// Kernels B, B', C, C', E, E', G and H: one-query decode attention over the
// caches.
//
// Kernel B, decode_self_attention, replaces the merged + store form of
// whisper_burn_tpu/ops/pallas_attention.py:_kernel (via
// decode_attention_merged(kq=, vq=)). One query per stream attends over
// layer `layer` of the int8 self cache [L, B, ctx, D] with per-token f32
// scales [L, B, ctx, 2] (K in lane 0, V in lane 1) for keys t < pos, and
// the current token's raw K/V are merged into the softmax. The output is
// normalized f32. The current token's pre-quantized rows and scales are
// then stored at pos in place (no key below pos is read-after-written).
// Bound: the cache read (2 * pos * D bytes per stream and layer, memory).
// Design: one block per (stream, head); a warp per key computes a 64-wide
// dot with two channels per lane, so a warp reads one key row of the head
// (64 bytes in int8); scores stay in shared memory; the value sum runs with
// one thread per channel on coalesced rows.
//
// Kernel B', decode_attention_merged, replaces the same _kernel through
// decode_attention_merged without kq/vq and without scales: the same merged
// attention over a float (f32 or bf16) self cache, unscaled, and no store
// (the decode step writes the row after its layer loop with kernel F, as
// the JAX package does). Bound and design: those of kernel B, at two or
// four bytes a cached value.
//
// Kernel E, decode_attention_layer, replaces the general form of the same
// _kernel (via decode_attention_layer, int8 cache with per-token scales):
// the same attention over keys t < valid, without the current token and
// without the store, returned unnormalized as (acc [B, D], m [B, H],
// l [B, H]) for the caller's flash merge (beam search's deferred cache
// write). Scores are (q.k) * scale * sk[t]; acc sums p[t] * sv[t] * v[t];
// l sums p[t] with the V scale left out. The TPU kernel walks key tiles
// with a running max when ctx spans several; here the whole ctx of scores
// sits in shared memory (ctx * 4 bytes, within the 48 KB default: ctx up
// to 12288, above n_text_ctx 448), so one exact pass gives the same m, l
// and acc. Kernel E' (decode_attention_layer_unscaled) is the same over a
// float cache without scales (decode_attention_layer(kv_scale4=None)).
// Bound and design: those of kernel B, whose cached-key part they share
// (attend_cached).
//
// Kernels G (decode_attention_merged_int4) and H
// (decode_attention_layer_int4) replace _kernel's int4 self-KV branches
// (K11, whisper_burn_tpu/ops/pallas_attention.py:174-258 with voff at
// :337-338): G in the merged form without the store
// (decode_attention_merged over a uint8 cache), H in the general,
// unnormalized form (decode_attention_layer). Values are int4 pairs packed
// along D ([L, B, ctx, D/2] uint8, channels j and j + D/2 in the low and
// high nibble of byte j, biased by 8); keys the same, or int8 codes (the
// mixed mode). Per-token scales [L, B, ctx, sw] f32, K lanes first: with
// channel groups a head's 64 channels share one group, so each (token,
// head) has one K scale and one V scale, and the math is kernel E's with
// those lanes (Lane::of); the scalar-scale form reads lanes 0 and 1, the
// unscaled form none. The TPU kernel rounds the dequantized keys to the
// compute dtype before its dot and folds the bias out as 8 * sum(q); here
// the dot runs in f32 on the unbiased codes. Bound: the cache read
// (pos * D bytes of int4 K and V per stream and layer, 1.5x that in the
// mixed mode, plus sw * 4 scale bytes a token). Design: attend_cached on a
// Nibbles accessor, one block per (stream, head): a lane loads two bytes,
// a warp one head's 64 key bytes, so each packed byte is read twice, by
// the blocks of the two heads that share it (the second read mostly from
// L2); a head pair per block would read it once and is later work.
//
// Kernel C, decode_cross_attention, replaces
// whisper_burn_tpu/ops/pallas_attention.py:_kt_kernel (int4, normalized).
// Keys are int4 pairs packed along D, stored [L, B, D/2, T] (byte row j
// holds channel j in its low nibble and channel j + D/2 in its high one);
// values are packed along T, stored [L, B, T/2, D] (row t holds time t low
// and time t + T/2 high). Codes are biased by 8. Keys at `valid` and above
// are masked. Per-channel scales are folded into q and the output by the
// caller. With G > 1 query streams per cache entry (beam search's
// batch_groups) stream b reads entry b / G, as the TPU kernel's index map
// does. Bound: the int4 cache read (T * D bytes per cache entry and layer,
// memory). Design: one block per (entry, head pair h, h + H/2, stream of
// the entry): channel j of head h and of head h + H/2 share a byte, so
// every key and value byte is read by exactly one block per stream, with
// consecutive threads on consecutive keys (scores) or channels (values).
// The G streams of an entry are the grid's z axis, so their blocks run
// side by side and re-read the entry's bytes mostly from L2. The host
// passes the entry count: the same kernel dividing B by G itself took
// more registers and ran slower, at G = 1 too.
//
// Kernel C', decode_cross_attention_unpacked, replaces _kt_kernel's
// unpacked branch (int8 codes with the per-channel scales folded outside,
// or an f32/bf16 cache): keys stored [L, B, D, T], values [L, B, T, D],
// normalized f32 out, keys at `valid` and above masked and never read.
// Bound: the cache read (2 * valid * D elements per cache entry and layer,
// memory). Design: one block per (stream of the entry, head, entry), the
// entry's streams adjacent in launch order so their re-reads of its bytes
// come mostly from L2; every thread loads 4 bytes at a time (4 int8, 2
// bf16 or 1 f32 elements): consecutive threads on consecutive keys of a
// key row (scores) or on consecutive channels of a value row (values).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// two consecutive cache elements as floats (the pointer is aligned to two)
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2((float)v.x, (float)v.y);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// one 4-byte load: 4 / sizeof(C) consecutive cache elements as floats
__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = v.x, o[1] = v.y;
}
__device__ __forceinline__ void load4(const float* p, float* o) { o[0] = *p; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide reduction of one value per thread (blockDim.x a multiple of 32,
// at most 1024); `scratch` holds 32 floats; every thread gets the result
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? scratch[lane] : (MAX ? NEG_BIG : 0.f);
  r = MAX ? warp_max(r) : warp_sum(r);
  return r;
}

constexpr int SELF_THREADS = 128;

// One head's 64 channels of a self cache, as the self-attention blocks read
// them: two(row, c) gives channels c and c + 1 (c even), one(row, c)
// channel c, as floats. Rows<C>: int8 codes or f32/bf16 values, D to a
// row. Nibbles: int4 pairs biased by 8, D/2 bytes to a row; channel j of a
// head in the low (shift 0) or high (shift 4) nibble of byte b0 + j.
template <typename C>
struct Rows {
  const C* p;
  int D, c0;
  __device__ float2 two(size_t row, int c) const { return load2(p + row * D + c0 + c); }
  __device__ float one(size_t row, int c) const { return to_f(p[row * D + c0 + c]); }
};

struct Nibbles {
  const uint8_t* p;
  int D2, b0, shift;
  __device__ float2 two(size_t row, int c) const {
    const uchar2 v = *reinterpret_cast<const uchar2*>(p + row * D2 + b0 + c);
    return make_float2((float)(((v.x >> shift) & 15) - 8), (float)(((v.y >> shift) & 15) - 8));
  }
  __device__ float one(size_t row, int c) const {
    return (float)(((p[row * D2 + b0 + c] >> shift) & 15) - 8);
  }
};

// head h of a cache: heads 0 .. H/2 - 1 in the low nibbles, the rest in the
// high ones (channel pairs j, j + D/2 share a byte)
__device__ __forceinline__ Rows<int8_t> head_of(const int8_t* p, int D, int H, int h) {
  return {p, D, h * DH};
}
__device__ __forceinline__ Nibbles head_of(const uint8_t* p, int D, int H, int h) {
  const int h2 = H / 2;
  return {p, D / 2, (h % h2) * DH, h < h2 ? 0 : 4};
}

// A head's per-token scale: Lane reads lane `lane` of rows `sw` floats
// wide; One is the scale of an unscaled cache. of() picks the lane of head
// h: off + (h * 64) / gs for groups of gs channels, off itself for gs = 0.
struct Lane {
  const float* p;
  int sw, lane;
  static __device__ Lane of(const float* p, int sw, int off, int gs, int h) {
    return {p, sw, off + (gs ? h * DH / gs : 0)};
  }
  __device__ float at(size_t row) const { return p[row * sw + lane]; }
};

struct One {
  static __device__ One of(const float*, int, int, int, int) { return {}; }
  __device__ float at(size_t) const { return 1.f; }
};

// The cached-key part of kernels B, B', E, E', G and H for one (stream,
// head) block of SELF_THREADS threads: scores of keys t < valid of the
// cache rows from row0 on (qs holds the head's 64 query values, s has room
// for `valid` floats), their softmax weights and the weighted value sum.
// Keys and values come through the accessors ka and va, their per-token
// scales through ks and vs. Every thread gets the running max m and the
// normalizer l (V scale left out); thread tid < 64 gets channel tid's sum
// of p[t] * sv[t] * v[t] in acc.
template <class KA, class VA, class KS, class VS>
__device__ void attend_cached(KA ka, VA va, KS ks, VS vs, size_t row0, int valid,
                              const float* qs, float* s, float* scratch, float* part,
                              float& m_out, float& l_out, float& acc_out) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = SELF_THREADS / 32;
  const float scale = rsqrtf((float)DH);

  for (int t = warp; t < valid; t += nwarps) {
    const float2 kk = ka.two(row0 + t, 2 * lane);
    float d = qs[2 * lane] * kk.x + qs[2 * lane + 1] * kk.y;
    d = warp_sum(d);
    if (lane == 0) s[t] = d * scale * ks.at(row0 + t);
  }
  __syncthreads();
  float m = NEG_BIG;
  for (int t = tid; t < valid; t += SELF_THREADS) m = fmaxf(m, s[t]);
  m = block_reduce<true>(m, scratch);
  float l = 0.f;
  for (int t = tid; t < valid; t += SELF_THREADS) {
    const float p = expf(s[t] - m);
    l += p;
    s[t] = p * vs.at(row0 + t);  // V scale weights the value sum only
  }
  l = block_reduce<false>(l, scratch);
  __syncthreads();

  // value sum: channel c = tid % 64, keys split in two halves by tid / 64
  const int c = tid % DH, half = tid / DH;
  float acc = 0.f;
  for (int t = half; t < valid; t += SELF_THREADS / DH) acc += s[t] * va.one(row0 + t, c);
  part[tid] = acc;
  __syncthreads();
  m_out = m;
  l_out = l;
  acc_out = tid < DH ? part[tid] + part[tid + DH] : 0.f;
}

// Kernels B, B' and G for block (stream b, head h): attend_cached over
// keys t < pos, then the current token's raw k_new / v_new merged in.
// Threads tid < 64 return channel h * 64 + tid of the normalized output.
template <typename T, class KA, class VA, class KS, class VS>
__device__ float attend_merged(const T* q, KA ka, VA va, KS ks, VS vs, const T* k_new,
                               const T* v_new, int layer, int pos, int B, int ctx, int D,
                               float* s, float* qs, float* scratch, float* part) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int c0 = h * DH;
  const float scale = rsqrtf((float)DH);
  const size_t row0 = ((size_t)layer * B + b) * ctx;  // first cache row of (layer, b)

  if (tid < DH) qs[tid] = to_f(q[(size_t)b * D + c0 + tid]);
  __syncthreads();
  float m, l, acc;
  attend_cached(ka, va, ks, vs, row0, pos, qs, s, scratch, part, m, l, acc);
  // the current token's score
  float e = tid < DH ? qs[tid] * to_f(k_new[(size_t)b * D + c0 + tid]) : 0.f;
  e = block_reduce<false>(e, scratch) * scale;
  if (tid >= DH) return 0.f;
  const float m2 = fmaxf(m, e);
  const float alpha = expf(m - m2), beta = expf(e - m2);
  const float l2 = l * alpha + beta;
  const float vn = to_f(v_new[(size_t)b * D + c0 + tid]);
  return (acc * alpha + beta * vn) / l2;
}

template <typename T>
__global__ void __launch_bounds__(SELF_THREADS)
self_attn_kernel(const T* __restrict__ q, int8_t* kc, int8_t* vc, float* kvs,
                 const T* __restrict__ k_new, const T* __restrict__ v_new,
                 const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
                 const float* __restrict__ new_scale, float* __restrict__ out,
                 int layer, int pos, int B, int ctx, int D) {
  extern __shared__ float s[];  // [ctx] scores, then probabilities
  __shared__ float qs[DH];
  __shared__ float scratch[32];
  __shared__ float part[SELF_THREADS];
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row0 = ((size_t)layer * B + b) * ctx;
  const size_t col = (size_t)b * D + h * DH + tid;
  const Rows<int8_t> ka{kc, D, h * DH}, va{vc, D, h * DH};
  const float o = attend_merged(q, ka, va, Lane{kvs, 2, 0}, Lane{kvs, 2, 1}, k_new, v_new, layer,
                                pos, B, ctx, D, s, qs, scratch, part);
  if (tid < DH) {
    out[col] = o;
    // store the current token at pos (no block reads row pos)
    kc[(row0 + pos) * D + h * DH + tid] = kq[col];
    vc[(row0 + pos) * D + h * DH + tid] = vq[col];
    if (h == 0 && tid < 2) kvs[(row0 + pos) * 2 + tid] = new_scale[b * 2 + tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(SELF_THREADS)
merged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                   const T* __restrict__ k_new, const T* __restrict__ v_new,
                   float* __restrict__ out, int layer, int pos, int B, int ctx, int D) {
  extern __shared__ float s[];  // [ctx] scores, then probabilities
  __shared__ float qs[DH];
  __shared__ float scratch[32];
  __shared__ float part[SELF_THREADS];
  const int c0 = blockIdx.y * DH;
  const float o = attend_merged(q, Rows<T>{kc, D, c0}, Rows<T>{vc, D, c0}, One{}, One{}, k_new,
                                v_new, layer, pos, B, ctx, D, s, qs, scratch, part);
  if (threadIdx.x < DH) out[(size_t)blockIdx.x * D + c0 + threadIdx.x] = o;
}

// Kernel G for block (stream b, head h): keys KC (uint8 int4 pairs, or
// int8 codes in the mixed mode) and int4 values, per-token scales SC (Lane,
// or One for the unscaled int4 form); lanes as in Lane::of.
template <typename T, typename KC, class SC>
__global__ void __launch_bounds__(SELF_THREADS)
merged_int4_kernel(const T* __restrict__ q, const KC* __restrict__ kc,
                   const uint8_t* __restrict__ vc, const float* __restrict__ kvs,
                   const T* __restrict__ k_new, const T* __restrict__ v_new,
                   float* __restrict__ out, int layer, int pos, int B, int ctx, int D, int H,
                   int sw, int kgs, int vgs, int voff) {
  extern __shared__ float s[];  // [ctx] scores, then probabilities
  __shared__ float qs[DH];
  __shared__ float scratch[32];
  __shared__ float part[SELF_THREADS];
  const int h = blockIdx.y;
  const float o = attend_merged(q, head_of(kc, D, H, h), head_of(vc, D, H, h),
                                SC::of(kvs, sw, 0, kgs, h), SC::of(kvs, sw, voff, vgs, h), k_new,
                                v_new, layer, pos, B, ctx, D, s, qs, scratch, part);
  if (threadIdx.x < DH) out[(size_t)blockIdx.x * D + h * DH + threadIdx.x] = o;
}

// Kernels E, E' and H for block (stream b, head h): attend_cached over
// keys t < valid, written unnormalized
template <typename T, class KA, class VA, class KS, class VS>
__device__ void layer_attn(const T* q, KA ka, VA va, KS ks, VS vs, float* acc_out, float* m_out,
                           float* l_out, int layer, int valid, int B, int ctx, int D, int H,
                           float* s, float* qs, float* scratch, float* part) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int c0 = h * DH;
  const size_t row0 = ((size_t)layer * B + b) * ctx;

  if (tid < DH) qs[tid] = to_f(q[(size_t)b * D + c0 + tid]);
  __syncthreads();
  float m, l, acc;
  attend_cached(ka, va, ks, vs, row0, valid, qs, s, scratch, part, m, l, acc);
  if (tid < DH) acc_out[(size_t)b * D + c0 + tid] = acc;
  if (tid == 0) {
    m_out[b * H + h] = m;
    l_out[b * H + h] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(SELF_THREADS)
layer_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                  const int8_t* __restrict__ vc, const float* __restrict__ kvs,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int layer, int valid, int B, int ctx, int D, int H) {
  extern __shared__ float s[];  // [ctx] scores, then probabilities
  __shared__ float qs[DH];
  __shared__ float scratch[32];
  __shared__ float part[SELF_THREADS];
  const int c0 = blockIdx.y * DH;
  layer_attn(q, Rows<int8_t>{kc, D, c0}, Rows<int8_t>{vc, D, c0}, Lane{kvs, 2, 0}, Lane{kvs, 2, 1},
             acc_out, m_out, l_out, layer, valid, B, ctx, D, H, s, qs, scratch, part);
}

template <typename T>
__global__ void __launch_bounds__(SELF_THREADS)
layer_unscaled_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int layer, int valid, int B, int ctx, int D,
                      int H) {
  extern __shared__ float s[];  // [ctx] scores, then probabilities
  __shared__ float qs[DH];
  __shared__ float scratch[32];
  __shared__ float part[SELF_THREADS];
  const int c0 = blockIdx.y * DH;
  layer_attn(q, Rows<T>{kc, D, c0}, Rows<T>{vc, D, c0}, One{}, One{}, acc_out, m_out, l_out, layer,
             valid, B, ctx, D, H, s, qs, scratch, part);
}

// Kernel H for block (stream b, head h): the caches and scales of kernel G
template <typename T, typename KC, class SC>
__global__ void __launch_bounds__(SELF_THREADS)
layer_int4_kernel(const T* __restrict__ q, const KC* __restrict__ kc,
                  const uint8_t* __restrict__ vc, const float* __restrict__ kvs,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int layer, int valid, int B, int ctx, int D, int H,
                  int sw, int kgs, int vgs, int voff) {
  extern __shared__ float s[];  // [ctx] scores, then probabilities
  __shared__ float qs[DH];
  __shared__ float scratch[32];
  __shared__ float part[SELF_THREADS];
  const int h = blockIdx.y;
  layer_attn(q, head_of(kc, D, H, h), head_of(vc, D, H, h), SC::of(kvs, sw, 0, kgs, h),
             SC::of(kvs, sw, voff, vgs, h), acc_out, m_out, l_out, layer, valid, B, ctx, D, H, s,
             qs, scratch, part);
}

// launch G (MERGED) or H over one of the three int4 self-cache forms:
// int4 keys with scales, int4 keys without, int8 keys with (mixed)
template <bool MERGED, typename T, typename KC, class SC>
int launch_int4(const void* q, const void* kc, const void* vc, const void* kvs, const void* k_new,
                const void* v_new, float* o0, float* o1, float* o2, int layer, int valid, int B,
                int ctx, int D, int H, int sw, int kgs, int vgs, int voff,
                cudaStream_t st) {
  dim3 grid(B, H);
  const size_t smem = (size_t)ctx * sizeof(float);
  const T* qt = static_cast<const T*>(q);
  const KC* k = static_cast<const KC*>(kc);
  const uint8_t* v = static_cast<const uint8_t*>(vc);
  const float* sc = static_cast<const float*>(kvs);
  if constexpr (MERGED) {
    merged_int4_kernel<T, KC, SC><<<grid, SELF_THREADS, smem, st>>>(
        qt, k, v, sc, static_cast<const T*>(k_new), static_cast<const T*>(v_new), o0, layer, valid,
        B, ctx, D, H, sw, kgs, vgs, voff);
  } else {
    layer_int4_kernel<T, KC, SC><<<grid, SELF_THREADS, smem, st>>>(
        qt, k, v, sc, o0, o1, o2, layer, valid, B, ctx, D, H, sw, kgs, vgs, voff);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool MERGED, typename T>
int launch_int4_form(int k_int4, const void* q, const void* kc, const void* vc, const void* kvs,
                     const void* k_new, const void* v_new, float* o0, float* o1, float* o2,
                     int layer, int valid, int B, int ctx, int D, int H, int sw, int kgs, int vgs,
                     int voff, cudaStream_t st) {
  if (!k_int4)
    return launch_int4<MERGED, T, int8_t, Lane>(q, kc, vc, kvs, k_new, v_new, o0, o1, o2, layer,
                                                valid, B, ctx, D, H, sw, kgs, vgs, voff, st);
  if (sw)
    return launch_int4<MERGED, T, uint8_t, Lane>(q, kc, vc, kvs, k_new, v_new, o0, o1, o2, layer,
                                                 valid, B, ctx, D, H, sw, kgs, vgs, voff, st);
  return launch_int4<MERGED, T, uint8_t, One>(q, kc, vc, kvs, k_new, v_new, o0, o1, o2, layer,
                                              valid, B, ctx, D, H, sw, kgs, vgs, voff, st);
}

constexpr int CROSS_THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(CROSS_THREADS)
cross_attn_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kT,
                  const uint8_t* __restrict__ v, float* __restrict__ out,
                  int layer, int valid, int E, int G, int D, int Tn, int H) {
  extern __shared__ float s[];  // [2][Tn] scores of the two heads
  __shared__ float qs[2][DH];
  __shared__ float scratch[32];
  __shared__ float part[CROSS_THREADS];
  const int e = blockIdx.x, h = blockIdx.y, h2 = h + H / 2;  // e: cache entry
  const int b = e * G + blockIdx.z;  // the query stream
  const int tid = threadIdx.x;
  const int D2 = D / 2, T2 = Tn / 2;
  const float scale = rsqrtf((float)DH);
  const size_t entry = (size_t)layer * E + e;
  const uint8_t* kb = kT + entry * D2 * Tn;
  const uint8_t* vb = v + entry * T2 * D;
  float* s1 = s;
  float* s2 = s + Tn;

  if (tid < DH) qs[0][tid] = to_f(q[(size_t)b * D + h * DH + tid]);
  else if (tid < 2 * DH) qs[1][tid - DH] = to_f(q[(size_t)b * D + h2 * DH + tid - DH]);
  __syncthreads();

  float m1 = NEG_BIG, m2 = NEG_BIG;
  for (int t = tid; t < Tn; t += CROSS_THREADS) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
    for (int j = 0; j < DH; ++j) {
      const int byte = kb[(size_t)(h * DH + j) * Tn + t];
      a1 += qs[0][j] * (float)((byte & 15) - 8);
      a2 += qs[1][j] * (float)((byte >> 4) - 8);
    }
    a1 = t < valid ? a1 * scale : NEG_BIG;
    a2 = t < valid ? a2 * scale : NEG_BIG;
    s1[t] = a1;
    s2[t] = a2;
    m1 = fmaxf(m1, a1);
    m2 = fmaxf(m2, a2);
  }
  m1 = block_reduce<true>(m1, scratch);
  m2 = block_reduce<true>(m2, scratch);
  float l1 = 0.f, l2 = 0.f;
  for (int t = tid; t < Tn; t += CROSS_THREADS) {
    const float p1 = t < valid ? expf(s1[t] - m1) : 0.f;
    const float p2 = t < valid ? expf(s2[t] - m2) : 0.f;
    s1[t] = p1;
    s2[t] = p2;
    l1 += p1;
    l2 += p2;
  }
  l1 = block_reduce<false>(l1, scratch);
  l2 = block_reduce<false>(l2, scratch);
  __syncthreads();

  // values: output o in [0, 128) = (head select, channel), 4 parts over rows
  const int o = tid % (2 * DH), pr = tid / (2 * DH);
  const int nparts = CROSS_THREADS / (2 * DH);
  const int hsel = o / DH, c = o % DH;
  const int col = (hsel ? h2 : h) * DH + c;
  const float* p = hsel ? s2 : s1;
  float acc = 0.f;
  for (int t2 = pr; t2 < T2; t2 += nparts) {
    const int byte = vb[(size_t)t2 * D + col];
    acc += p[t2] * (float)((byte & 15) - 8) + p[t2 + T2] * (float)((byte >> 4) - 8);
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < 2 * DH) {
    float r = 0.f;
    for (int k = 0; k < nparts; ++k) r += part[k * 2 * DH + tid];
    out[(size_t)b * D + col] = r / (hsel ? l2 : l1);
  }
}

constexpr int CROSS_U_THREADS = 512;

template <typename T, typename C>
__global__ void __launch_bounds__(CROSS_U_THREADS)
cross_unpacked_kernel(const T* __restrict__ q, const C* __restrict__ kT, const C* __restrict__ v,
                      float* __restrict__ out, int layer, int valid, int G, int D, int Tn) {
  constexpr int V = 4 / (int)sizeof(C);      // elements per 4-byte load
  constexpr int ROW_THREADS = DH / V;         // threads over one head's value row
  constexpr int PARTS = CROSS_U_THREADS / ROW_THREADS;
  extern __shared__ float s[];  // [Tn] scores of the head, then probabilities
  __shared__ float qs[DH];
  __shared__ float scratch[32];
  __shared__ float part[PARTS * DH];
  const int h = blockIdx.y, e = blockIdx.z;  // e: cache entry
  const int b = e * G + blockIdx.x;         // the query stream
  const int tid = threadIdx.x;
  const float scale = rsqrtf((float)DH);
  const size_t entry = (size_t)layer * gridDim.z + e;
  const C* kb = kT + (entry * D + (size_t)h * DH) * Tn;  // the head's 64 key rows [64][Tn]
  const C* vb = v + entry * Tn * D + h * DH;              // the head's value columns

  if (tid < DH) qs[tid] = to_f(q[(size_t)b * D + h * DH + tid]);
  __syncthreads();

  float m = NEG_BIG;
  for (int t0 = tid * V; t0 < valid; t0 += CROSS_U_THREADS * V) {
    float a[V];
#pragma unroll
    for (int i = 0; i < V; ++i) a[i] = 0.f;
#pragma unroll 8
    for (int j = 0; j < DH; ++j) {
      float k[V];
      load4(kb + (size_t)j * Tn + t0, k);
      const float qj = qs[j];
#pragma unroll
      for (int i = 0; i < V; ++i) a[i] += qj * k[i];
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (t0 + i < valid) {
        s[t0 + i] = a[i] * scale;
        m = fmaxf(m, a[i] * scale);
      }
    }
  }
  m = block_reduce<true>(m, scratch);
  float l = 0.f;
  for (int t = tid; t < valid; t += CROSS_U_THREADS) {
    const float p = expf(s[t] - m);
    s[t] = p;
    l += p;
  }
  l = block_reduce<false>(l, scratch);
  __syncthreads();

  // values: V channels a thread, PARTS threads down the rows t < valid
  const int c = (tid % ROW_THREADS) * V, pr = tid / ROW_THREADS;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int t = pr; t < valid; t += PARTS) {
    float x[V];
    load4(vb + (size_t)t * D + c, x);
    const float p = s[t];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += p * x[i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) part[pr * DH + c + i] = acc[i];
  __syncthreads();
  if (tid < DH) {
    float r = 0.f;
    for (int k = 0; k < PARTS; ++k) r += part[k * DH + tid];
    out[(size_t)b * D + h * DH + tid] = r / l;
  }
}

template <typename T, typename C>
int launch_cross_unpacked(const void* q, const void* kT, const void* v, float* out, int layer,
                          int valid, int B, int G, int D, int Tn, int H, cudaStream_t st) {
  dim3 grid(G, H, B / G);
  cross_unpacked_kernel<T, C><<<grid, CROSS_U_THREADS, (size_t)Tn * sizeof(float), st>>>(
      static_cast<const T*>(q), static_cast<const C*>(kT), static_cast<const C*>(v), out, layer,
      valid, G, D, Tn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k_new, v_new: [B, D] f32 or bf16 (bf16 flag); kc, vc: int8 [L, B, ctx, D];
// kvs: f32 [L, B, ctx, 2]; kq, vq: int8 [B, D]; new_scale: f32 [B, 2];
// out: f32 [B, D]. Head width 64. Needs 0 <= pos < ctx and ctx * 4 bytes of
// dynamic shared memory within the 48 KB default.
extern "C" int decode_self_attention(const void* q, int bf16, void* kc, void* vc, void* kvs,
                                     const void* k_new, const void* v_new, const void* kq,
                                     const void* vq, const void* new_scale, void* out,
                                     int layer, int pos, int B, int ctx, int D, int H,
                                     void* stream) {
  dim3 grid(B, H);
  const size_t smem = (size_t)ctx * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* k8 = static_cast<int8_t*>(kc);
  int8_t* v8 = static_cast<int8_t*>(vc);
  float* sc = static_cast<float*>(kvs);
  const int8_t* kq8 = static_cast<const int8_t*>(kq);
  const int8_t* vq8 = static_cast<const int8_t*>(vq);
  const float* ns = static_cast<const float*>(new_scale);
  float* o = static_cast<float*>(out);
  if (bf16) {
    self_attn_kernel<__nv_bfloat16><<<grid, SELF_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), k8, v8, sc,
        static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
        kq8, vq8, ns, o, layer, pos, B, ctx, D);
  } else {
    self_attn_kernel<float><<<grid, SELF_THREADS, smem, st>>>(
        static_cast<const float*>(q), k8, v8, sc, static_cast<const float*>(k_new),
        static_cast<const float*>(v_new), kq8, vq8, ns, o, layer, pos, B, ctx, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, k_new, v_new: [B, D]; kc, vc: [L, B, ctx, D]; all f32, or all bf16
// (bf16 flag); out: f32 [B, D], normalized; nothing is stored. Head width
// 64. Needs 0 <= pos < ctx and ctx * 4 bytes of dynamic shared memory
// within the 48 KB default.
extern "C" int decode_attention_merged(const void* q, int bf16, const void* kc, const void* vc,
                                       const void* k_new, const void* v_new, void* out, int layer,
                                       int pos, int B, int ctx, int D, int H, void* stream) {
  dim3 grid(B, H);
  const size_t smem = (size_t)ctx * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bf16) {
    using T = __nv_bfloat16;
    merged_attn_kernel<T><<<grid, SELF_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), o, layer, pos, B, ctx, D);
  } else {
    merged_attn_kernel<float><<<grid, SELF_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kc), static_cast<const float*>(vc),
        static_cast<const float*>(k_new), static_cast<const float*>(v_new), o, layer, pos, B, ctx,
        D);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [B, D] f32 or bf16 (bf16 flag), B query streams; kc, vc: int8
// [L, B, ctx, D]; kvs: f32 [L, B, ctx, 2]; acc: f32 [B, D]; m, l: f32
// [B, H]. Head width 64. Needs 0 <= valid <= ctx and ctx * 4 bytes of
// dynamic shared memory within the 48 KB default.
extern "C" int decode_attention_layer(const void* q, int bf16, const void* kc, const void* vc,
                                      const void* kvs, void* acc, void* m, void* l, int layer,
                                      int valid, int B, int ctx, int D, int H, void* stream) {
  dim3 grid(B, H);
  const size_t smem = (size_t)ctx * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* k8 = static_cast<const int8_t*>(kc);
  const int8_t* v8 = static_cast<const int8_t*>(vc);
  const float* sc = static_cast<const float*>(kvs);
  float* a = static_cast<float*>(acc);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (bf16) {
    layer_attn_kernel<__nv_bfloat16><<<grid, SELF_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), k8, v8, sc, a, mo, lo, layer, valid, B, ctx, D, H);
  } else {
    layer_attn_kernel<float><<<grid, SELF_THREADS, smem, st>>>(
        static_cast<const float*>(q), k8, v8, sc, a, mo, lo, layer, valid, B, ctx, D, H);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [B, D]; kc, vc: [L, B, ctx, D]; all f32, or all bf16 (bf16 flag);
// acc: f32 [B, D]; m, l: f32 [B, H]. Head width 64. Needs 0 <= valid <= ctx
// and ctx * 4 bytes of dynamic shared memory within the 48 KB default.
extern "C" int decode_attention_layer_unscaled(const void* q, int bf16, const void* kc,
                                               const void* vc, void* acc, void* m, void* l,
                                               int layer, int valid, int B, int ctx, int D, int H,
                                               void* stream) {
  dim3 grid(B, H);
  const size_t smem = (size_t)ctx * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (bf16) {
    using T = __nv_bfloat16;
    layer_unscaled_kernel<T><<<grid, SELF_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), a, mo, lo,
        layer, valid, B, ctx, D, H);
  } else {
    layer_unscaled_kernel<float><<<grid, SELF_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kc),
        static_cast<const float*>(vc), a, mo, lo, layer, valid, B, ctx, D, H);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, k_new, v_new: [B, D] f32 or bf16 (bf16 flag); kc: uint8 [L, B, ctx,
// D/2] int4 pairs (k_int4) or int8 [L, B, ctx, D]; vc: uint8 [L, B, ctx,
// D/2]; kvs: f32 [L, B, ctx, sw] (null with sw = 0: an unscaled int4
// cache); a head's scale lanes as in Lane::of (keys from lane 0 in groups
// of kgs channels, values from lane voff in groups of vgs); out: f32
// [B, D], normalized; nothing is stored. Head width 64, H even, a scale
// group a whole number of heads. Needs 0 <= pos < ctx and ctx * 4 bytes of
// dynamic shared memory within the 48 KB default.
extern "C" int decode_attention_merged_int4(const void* q, int bf16, const void* kc,
                                            const void* vc, const void* kvs, const void* k_new,
                                            const void* v_new, void* out, int layer, int pos,
                                            int B, int ctx, int D, int H, int k_int4, int sw,
                                            int kgs, int vgs, int voff, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bf16)
    return launch_int4_form<true, __nv_bfloat16>(k_int4, q, kc, vc, kvs, k_new, v_new, o, nullptr,
                                                 nullptr, layer, pos, B, ctx, D, H, sw, kgs, vgs,
                                                 voff, st);
  return launch_int4_form<true, float>(k_int4, q, kc, vc, kvs, k_new, v_new, o, nullptr, nullptr,
                                       layer, pos, B, ctx, D, H, sw, kgs, vgs, voff, st);
}

// The caches and scales of decode_attention_merged_int4, over keys
// t < valid: acc f32 [B, D], m, l f32 [B, H], unnormalized (l without the
// V scales). Needs 0 <= valid <= ctx.
extern "C" int decode_attention_layer_int4(const void* q, int bf16, const void* kc, const void* vc,
                                           const void* kvs, void* acc, void* m, void* l,
                                           int layer, int valid, int B, int ctx, int D, int H,
                                           int k_int4, int sw, int kgs, int vgs,
                                           int voff, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (bf16)
    return launch_int4_form<false, __nv_bfloat16>(k_int4, q, kc, vc, kvs, nullptr, nullptr, a, mo,
                                                  lo, layer, valid, B, ctx, D, H, sw, kgs, vgs,
                                                  voff, st);
  return launch_int4_form<false, float>(k_int4, q, kc, vc, kvs, nullptr, nullptr, a, mo, lo, layer,
                                        valid, B, ctx, D, H, sw, kgs, vgs, voff, st);
}

// q: [B, D] f32 or bf16, B query streams, G of them per cache entry (B % G
// == 0); kT: uint8 [L, B/G, D/2, T]; v: uint8 [L, B/G, T/2, D]; out: f32
// [B, D], normalized. Head width 64, H even, T even, 2 * T * 4 bytes of
// dynamic shared memory within the 48 KB default.
extern "C" int decode_cross_attention(const void* q, int bf16, const void* kT, const void* v,
                                      void* out, int layer, int valid, int B, int G, int D, int T,
                                      int H, void* stream) {
  dim3 grid(B / G, H / 2, G);
  const int E = B / G;
  const size_t smem = 2 * (size_t)T * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* k4 = static_cast<const uint8_t*>(kT);
  const uint8_t* v4 = static_cast<const uint8_t*>(v);
  float* o = static_cast<float*>(out);
  if (bf16) {
    cross_attn_kernel<__nv_bfloat16><<<grid, CROSS_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), k4, v4, o, layer, valid, E, G, D, T, H);
  } else {
    cross_attn_kernel<float><<<grid, CROSS_THREADS, smem, st>>>(
        static_cast<const float*>(q), k4, v4, o, layer, valid, E, G, D, T, H);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [B, D] f32 or bf16 (bf16 flag), B query streams, G of them per cache
// entry (B % G == 0); kT: [L, B/G, D, T]; v: [L, B/G, T, D], int8
// (cache_int8) or of q's type; out: f32 [B, D], normalized. Head width 64,
// T and D multiples of 4, 0 < valid <= T, T * 4 bytes of dynamic shared
// memory within the 48 KB default.
extern "C" int decode_cross_attention_unpacked(const void* q, int bf16, int cache_int8,
                                               const void* kT, const void* v, void* out,
                                               int layer, int valid, int B, int G, int D, int T,
                                               int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  using BF = __nv_bfloat16;
  if (bf16 && cache_int8)
    return launch_cross_unpacked<BF, int8_t>(q, kT, v, o, layer, valid, B, G, D, T, H, st);
  if (bf16) return launch_cross_unpacked<BF, BF>(q, kT, v, o, layer, valid, B, G, D, T, H, st);
  if (cache_int8)
    return launch_cross_unpacked<float, int8_t>(q, kT, v, o, layer, valid, B, G, D, T, H, st);
  return launch_cross_unpacked<float, float>(q, kT, v, o, layer, valid, B, G, D, T, H, st);
}
