// Kernels B, B', C, C', E, E', G and H: one-query decode attention over the
// caches.
//
// The self-attention kernels (B, B', E, E', G, H) replace the forms of
// whisper_burn_tpu/ops/pallas_attention.py:_kernel that attend one query
// per stream over layer `layer` of a self cache [L, B, ctx, .] for keys
// t < pos (or valid). Scores are (q.k) * 64^-1/2 * sk[t]; each key's
// softmax weight p[t] multiplies sv[t] * v[t]; the dot runs in f32 on the
// cache's values or unbiased codes, q converted from bf16 or f32.
//
// - B, decode_self_attention (K2, merged + store, via
//   decode_attention_merged(kq=, vq=)): int8 cache with per-token f32
//   scales [L, B, ctx, 2] (K lane 0, V lane 1); the current token's raw
//   K/V are merged into the softmax and the output is normalized f32. The
//   block of (b, h) then stores the token's pre-quantized rows and scales
//   at pos in place; no block reads row pos.
// - B', decode_attention_merged (K2 without kq/vq and scales): the same
//   merge over a float (f32 or bf16) cache, unscaled, nothing stored (the
//   decode step writes the row after its layer loop with kernel F).
// - E, decode_attention_layer (K8, the general form): int8 cache with
//   per-token scales, keys t < valid, no current token and no store,
//   returned unnormalized as (acc [B, D], m [B, H], l [B, H]) for the
//   caller's flash merge (beam search's deferred cache write); l sums p[t]
//   with the V scale left out. E', decode_attention_layer_unscaled: the
//   same over a float cache without scales.
// - G, decode_attention_merged_int4 (K11 merged, :174-258 with voff at
//   :337-338), and H, decode_attention_layer_int4 (K11 general): values
//   are int4 pairs packed along D ([L, B, ctx, D/2] uint8, channels j and
//   j + D/2 in the low and high nibble of byte j, biased by 8), so heads h
//   and h + H/2 share every byte; keys the same, or int8 codes (the mixed
//   mode). Per-token scales [L, B, ctx, sw] f32, K lanes first: a head's
//   64 channels lie in one channel group, so each (token, head) has one K
//   and one V scale (Lane::of); the scalar-scale form reads lanes 0 and 1,
//   the unscaled form none. The TPU kernel rounds the dequantized keys to
//   the compute dtype before its dot and folds the bias out as 8 * sum(q);
//   here the dot runs in f32 on the unbiased codes.
//
// Bound: the cache read, a few µs of launch and latency above it. At pos
// keys a stream and layer: B 2 * pos * D bytes and 8 * pos of scales
// (0.75 µs at B = 8, pos 115, D 1280), B' and E' 2 * pos * D elements, G
// and H pos * D bytes of int4 K and V (1.5x that mixed) and sw * 4 scale
// bytes a token (0.40 µs at B = 8).
//
// Design, one loop for all six (attend_cached): one block of 8 warps per
// (stream, head), for G and H per (stream, head pair h, h + H/2), so each
// packed byte is read once. A lane loads 16 bytes of a key row and 16 of
// its value row: an int8 or int4-pair head row (64 bytes) takes 4 lanes, a
// bf16 one 8 and an f32 one 16, so a warp load instruction covers 8, 4 or
// 2 keys, one a key slot. Warp w owns a contiguous run of keys and issues
// the loads of 16 of them (keys, values and the scales the lanes use)
// before it uses any; at ctx 256 that is one or two steps a warp. A key's
// score is reduced over its lanes by 2-4 shuffles. Each slot keeps a
// normalizer and an accumulator in registers under a running max that the
// warp's slots share (online softmax, one rescale a step), so the slots
// merge by butterfly sums without exponentials, and the 8 warps' states
// (m, l, acc[64]) merge once through shared memory in warp order: one
// barrier, no score buffer, no atomics, so two launches give bitwise equal
// results. Codes become floats by a byte permute into 2^23's float and one
// subtraction, int8 after an xor and int4 after a mask. The current
// token's q, k and v (and B's row to store) are loaded before the cached
// keys; the merged kernels then add the current token and normalize, and
// B's block stores its row. At most 128 registers a thread, so two blocks
// share a multiprocessor: the grid (B x H, or B x H/2 head pairs) is one
// wave at the greedy paths' 8 streams. No cluster split: at ctx 256 a
// block's loads are all in flight in one or two rounds, and a split would
// add a cluster barrier to a latency-bound launch. Tried and slower on
// the H100 (PERF.md, kernels B and G): each slot's state in shared memory, 32-key
// steps, 16 warps a block for G, four partial sums in the dot.

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
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
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

// ---- the self-attention loop (kernels B, B', E, E', G, H) ------------------

constexpr int SELF_WARPS = 8;
constexpr int SELF_THREADS = 32 * SELF_WARPS;

// Byte b of u (biased to unsigned, at most 255) as a float: it becomes the
// low byte of 2^23's float, whose value is then 2^23 + b.
__device__ __forceinline__ float biased_byte(uint32_t u, int b) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + b));
}

// 16 bytes of a cache row as floats: 16 int8 codes, 8 bf16 or 4 f32 values
template <typename C>
struct Unpack;
template <>
struct Unpack<int8_t> {
  static __device__ __forceinline__ void run(const uint4& w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b) f[4 * k + b] = biased_byte(u[k] ^ 0x80808080u, b) - 8388736.0f;
  }
};
template <>
struct Unpack<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const uint4& w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
};
template <>
struct Unpack<float> {
  static __device__ __forceinline__ void run(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x), f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z), f[3] = __uint_as_float(w.w);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) { return *reinterpret_cast<const uint4*>(p); }

// NH heads of a cache of D elements of C a row (int8 codes, or f32/bf16
// values), head j's 64 channels from column c0[j]. A lane's load(row,
// chunk) brings channels [chunk * CPL, (chunk + 1) * CPL) of every head,
// 16 bytes each; unpack(raw, j, f) gives head j's as floats.
template <typename C, int NH>
struct Rows {
  static constexpr int CPL = 16 / sizeof(C);
  struct Raw {
    uint4 w[NH];
  };
  const C* p;
  int D;
  int c0[NH];
  __device__ Raw load(size_t row, int chunk) const {
    Raw r;
#pragma unroll
    for (int j = 0; j < NH; ++j) r.w[j] = load16(p + row * D + c0[j] + chunk * CPL);
    return r;
  }
  __device__ void unpack(const Raw& r, int j, float* f) const { Unpack<C>::run(r.w[j], f); }
};

// Heads h and h + H/2 of an int4 cache: int4 pairs biased by 8, D/2 bytes
// a row, channel c of head h in the low nibble of byte b0 + c and of head
// h + H/2 in the high one, so one 16-byte load serves both heads (NH = 2).
struct Nibbles {
  static constexpr int CPL = 16;
  struct Raw {
    uint4 w;
  };
  const uint8_t* p;
  int D2, b0;
  __device__ Raw load(size_t row, int chunk) const { return {load16(p + row * D2 + b0 + chunk * CPL)}; }
  __device__ void unpack(const Raw& r, int j, float* f) const {
    const uint32_t u[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b) f[4 * k + b] = biased_byte((u[k] >> (4 * j)) & 0x0f0f0f0fu, b) - 8388616.0f;
  }
};

// the keys (or values) of head pair h, h + H/2 of an int4-valued cache:
// int4 pairs, or int8 codes (the mixed mode's keys)
__device__ __forceinline__ Nibbles pair_of(const uint8_t* p, int D, int H, int h) {
  return {p, D / 2, h * DH};
}
__device__ __forceinline__ Rows<int8_t, 2> pair_of(const int8_t* p, int D, int H, int h) {
  return {p, D, {h * DH, (h + H / 2) * DH}};
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

// The block's running states per head, one a warp, merged in warp order.
template <int NH>
struct alignas(16) Partials {
  float acc[SELF_WARPS][NH][DH];
  float l[SELF_WARPS][NH];
  float m[SELF_WARPS][NH];
};

// The one-pass loop of kernels B, B', E, E', G and H for the block of
// stream blockIdx.x: the keys t < valid of cache rows row0 + t
// for NH heads (head[j], query q[b, head[j] * 64 ..]). Keys and values
// come through ka and va, their per-token scales through ks[j] and vs[j].
// LPK lanes take one key (16 bytes each), so a warp load covers KPW keys,
// one a key slot; warp w walks keys [w * per, (w + 1) * per) in steps of
// 16 keys whose loads are all issued first, with an online softmax whose
// max the warp's slots share, so the slots then merge by plain butterfly
// sums. The warps' states land in `part`, synchronized. The m of a head
// without keys is NEG_BIG, its l and acc 0.
template <int NH, typename T, class KA, class VA, class KS, class VS>
__device__ void attend_cached(const T* q, const int (&head)[NH], KA ka, VA va, const KS (&ks)[NH],
                              const VS (&vs)[NH], size_t row0, int valid, int D,
                              Partials<NH>& part) {
  static_assert(KA::CPL == VA::CPL, "keys and values take the same lanes");
  constexpr int CPL = KA::CPL;   // channels a lane
  constexpr int LPK = DH / CPL;  // lanes a key
  constexpr int KPW = 32 / LPK;  // keys a warp load: the key slots
  constexpr int U = LPK / 2;     // warp loads a step: 16 keys
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int chunk = lane % LPK, slot = lane / LPK;
  const float scale = rsqrtf((float)DH);

  float qf[NH][CPL], acc[NH][CPL], m[NH], l[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    const T* qh = q + (size_t)blockIdx.x * D + head[j] * DH + chunk * CPL;
#pragma unroll
    for (int i = 0; i < CPL; ++i) qf[j][i] = to_f(qh[i]), acc[j][i] = 0.f;
    m[j] = NEG_BIG, l[j] = 0.f;
  }

  const int per = (valid + SELF_WARPS * KPW - 1) / (SELF_WARPS * KPW) * KPW;
  const int t_end = min(valid, (warp + 1) * per);
  for (int t0 = warp * per; t0 < t_end; t0 += U * KPW) {
    typename KA::Raw kr[U] = {};
    typename VA::Raw vr[U] = {};
    float sk[U][NH] = {}, sv[U][NH] = {};
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * KPW + slot;
      ok[u] = t < t_end;
      if (ok[u]) {
        const size_t row = row0 + t;
        kr[u] = ka.load(row, chunk);
        vr[u] = va.load(row, chunk);
#pragma unroll
        for (int j = 0; j < NH; ++j) sk[u][j] = ks[j].at(row), sv[u][j] = vs[j].at(row);
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float s[U];
      float mc = m[j];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[CPL];
        ka.unpack(kr[u], j, kf);
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) d += qf[j][i] * kf[i];
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
        s[u] = ok[u] ? d * scale * sk[u][j] : NEG_BIG;
        mc = fmaxf(mc, s[u]);
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, o));  // the warp's max
      const float alpha = expf(m[j] - mc);
      m[j] = mc;
      l[j] *= alpha;
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[j][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? expf(s[u] - mc) : 0.f;
        l[j] += p;
        const float w = p * sv[u][j];  // the V scale weights the value sum only
        float vf[CPL];
        va.unpack(vr[u], j, vf);
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[j][i] += w * vf[i];
      }
    }
  }

  // the warp's key slots hold the same channels under one max: sum them
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      l[j] += __shfl_xor_sync(FULL, l[j], o);
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[j][i] += __shfl_xor_sync(FULL, acc[j][i], o);
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
#pragma unroll
      for (int i = 0; i < CPL; i += 4)
        *reinterpret_cast<float4*>(&part.acc[warp][j][chunk * CPL + i]) =
            make_float4(acc[j][i], acc[j][i + 1], acc[j][i + 2], acc[j][i + 3]);
      if (chunk == 0) part.l[warp][j] = l[j], part.m[warp][j] = m[j];
    }
  }
  __syncthreads();
}

// Head j's state over the block's warps, merged in warp order: M, L and
// this lane's channels 2 * lane and 2 * lane + 1 of acc.
template <int NH>
__device__ void merge_warps(const Partials<NH>& part, int j, float& M, float& L, float2& a) {
  const int c = 2 * (threadIdx.x % 32);
  M = NEG_BIG;
#pragma unroll
  for (int w = 0; w < SELF_WARPS; ++w) M = fmaxf(M, part.m[w][j]);
  L = 0.f, a = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < SELF_WARPS; ++w) {
    const float e = expf(part.m[w][j] - M);
    const float2 x = *reinterpret_cast<const float2*>(&part.acc[w][j][c]);
    L += part.l[w][j] * e;
    a.x += x.x * e, a.y += x.y * e;
  }
}

// The current token's q, k and v at this lane's two channels of head j =
// warp < NH, loaded before the cached keys for the merged kernels' last
// step.
struct TokenCols {
  float2 q, k, v;
};

template <int NH, typename T>
__device__ TokenCols token_cols(const T* q, const T* k_new, const T* v_new, const int (&head)[NH],
                                int D) {
  const int j = threadIdx.x / 32;
  TokenCols r{};
  if (j < NH) {
    const size_t col = (size_t)blockIdx.x * D + head[j] * DH + 2 * (threadIdx.x % 32);
    r.q = make_float2(to_f(q[col]), to_f(q[col + 1]));
    r.k = make_float2(to_f(k_new[col]), to_f(k_new[col + 1]));
    r.v = make_float2(to_f(v_new[col]), to_f(v_new[col + 1]));
  }
  return r;
}

// Kernels B, B' and G after attend_cached: warp j < NH merges head j's
// state with the current token and writes the normalized output, two
// channels a lane.
template <int NH>
__device__ void finish_merged(const TokenCols& tok, const int (&head)[NH], int D,
                              const Partials<NH>& part, float* out) {
  const int j = threadIdx.x / 32;
  if (j >= NH) return;
  float M, L;
  float2 a;
  merge_warps(part, j, M, L, a);
  const float e = warp_sum(tok.q.x * tok.k.x + tok.q.y * tok.k.y) * rsqrtf((float)DH);
  const float m2 = fmaxf(M, e);
  const float alpha = expf(M - m2), beta = expf(e - m2);
  const float l2 = L * alpha + beta;
  const size_t col = (size_t)blockIdx.x * D + head[j] * DH + 2 * (threadIdx.x % 32);
  *reinterpret_cast<float2*>(out + col) =
      make_float2((a.x * alpha + beta * tok.v.x) / l2, (a.y * alpha + beta * tok.v.y) / l2);
}

// Kernels E, E' and H after attend_cached: warp j < NH writes head j's
// unnormalized state.
template <int NH>
__device__ void finish_layer(const int (&head)[NH], int D, int H, const Partials<NH>& part,
                             float* acc_out, float* m_out, float* l_out) {
  const int j = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (j >= NH) return;
  float M, L;
  float2 a;
  merge_warps(part, j, M, L, a);
  *reinterpret_cast<float2*>(acc_out + (size_t)blockIdx.x * D + head[j] * DH + 2 * lane) = a;
  if (lane == 0) {
    m_out[blockIdx.x * H + head[j]] = M;
    l_out[blockIdx.x * H + head[j]] = L;
  }
}

// Kernel B for block (stream b, head h)
template <typename T>
__global__ void __launch_bounds__(SELF_THREADS, 2)
self_attn_kernel(const T* __restrict__ q, int8_t* kc, int8_t* vc, float* kvs,
                 const T* __restrict__ k_new, const T* __restrict__ v_new,
                 const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
                 const float* __restrict__ new_scale, float* __restrict__ out,
                 int layer, int pos, int B, int ctx, int D) {
  __shared__ Partials<1> part;
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t row0 = ((size_t)layer * B + b) * ctx;
  const int head[1] = {h};
  const TokenCols tok = token_cols(q, k_new, v_new, head, D);
  // warp 0 stores the current token's rows and scales at pos after the
  // attention (no block reads row pos)
  const size_t c = h * DH + 2 * (threadIdx.x % 32);
  char2 kq2{}, vq2{};
  float ns = 0.f;
  if (threadIdx.x < 32) {
    kq2 = *reinterpret_cast<const char2*>(kq + b * D + c);
    vq2 = *reinterpret_cast<const char2*>(vq + b * D + c);
    if (threadIdx.x < 2) ns = new_scale[b * 2 + threadIdx.x];
  }
  const Lane ks[1] = {{kvs, 2, 0}}, vs[1] = {{kvs, 2, 1}};
  using KA = Rows<int8_t, 1>;
  attend_cached(q, head, KA{kc, D, {h * DH}}, KA{vc, D, {h * DH}}, ks, vs, row0, pos, D, part);
  finish_merged(tok, head, D, part, out);
  if (threadIdx.x < 32) {
    *reinterpret_cast<char2*>(kc + (row0 + pos) * D + c) = kq2;
    *reinterpret_cast<char2*>(vc + (row0 + pos) * D + c) = vq2;
    if (h == 0 && threadIdx.x < 2) kvs[(row0 + pos) * 2 + threadIdx.x] = ns;
  }
}

// Kernel B' for block (stream b, head h)
template <typename T>
__global__ void __launch_bounds__(SELF_THREADS, 2)
merged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                   const T* __restrict__ k_new, const T* __restrict__ v_new,
                   float* __restrict__ out, int layer, int pos, int B, int ctx, int D) {
  __shared__ Partials<1> part;
  const int h = blockIdx.y;
  const int head[1] = {h};
  const TokenCols tok = token_cols(q, k_new, v_new, head, D);
  const One ones[1] = {{}};
  using KA = Rows<T, 1>;
  attend_cached(q, head, KA{kc, D, {h * DH}}, KA{vc, D, {h * DH}}, ones, ones,
                ((size_t)layer * B + blockIdx.x) * ctx, pos, D, part);
  finish_merged(tok, head, D, part, out);
}

// Kernel G for block (stream b, head pair h, h + H/2): keys KC (uint8 int4
// pairs, or int8 codes in the mixed mode) and int4 values, per-token
// scales SC (Lane, or One for the unscaled int4 form); lanes as in Lane::of.
template <typename T, typename KC, class SC>
__global__ void __launch_bounds__(SELF_THREADS, 2)
merged_int4_kernel(const T* __restrict__ q, const KC* __restrict__ kc,
                   const uint8_t* __restrict__ vc, const float* __restrict__ kvs,
                   const T* __restrict__ k_new, const T* __restrict__ v_new,
                   float* __restrict__ out, int layer, int pos, int B, int ctx, int D, int H,
                   int sw, int kgs, int vgs, int voff) {
  __shared__ Partials<2> part;
  const int h = blockIdx.y;
  const int head[2] = {h, h + H / 2};
  const TokenCols tok = token_cols(q, k_new, v_new, head, D);
  const SC ks[2] = {SC::of(kvs, sw, 0, kgs, head[0]), SC::of(kvs, sw, 0, kgs, head[1])};
  const SC vs[2] = {SC::of(kvs, sw, voff, vgs, head[0]), SC::of(kvs, sw, voff, vgs, head[1])};
  attend_cached(q, head, pair_of(kc, D, H, h), pair_of(vc, D, H, h), ks, vs,
                ((size_t)layer * B + blockIdx.x) * ctx, pos, D, part);
  finish_merged(tok, head, D, part, out);
}

// Kernel E for block (stream b, head h)
template <typename T>
__global__ void __launch_bounds__(SELF_THREADS, 2)
layer_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                  const int8_t* __restrict__ vc, const float* __restrict__ kvs,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int layer, int valid, int B, int ctx, int D, int H) {
  __shared__ Partials<1> part;
  const int h = blockIdx.y;
  const int head[1] = {h};
  const Lane ks[1] = {{kvs, 2, 0}}, vs[1] = {{kvs, 2, 1}};
  using KA = Rows<int8_t, 1>;
  attend_cached(q, head, KA{kc, D, {h * DH}}, KA{vc, D, {h * DH}}, ks, vs,
                ((size_t)layer * B + blockIdx.x) * ctx, valid, D, part);
  finish_layer(head, D, H, part, acc_out, m_out, l_out);
}

// Kernel E' for block (stream b, head h)
template <typename T>
__global__ void __launch_bounds__(SELF_THREADS, 2)
layer_unscaled_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int layer, int valid, int B, int ctx, int D,
                      int H) {
  __shared__ Partials<1> part;
  const int h = blockIdx.y;
  const int head[1] = {h};
  const One ones[1] = {{}};
  using KA = Rows<T, 1>;
  attend_cached(q, head, KA{kc, D, {h * DH}}, KA{vc, D, {h * DH}}, ones, ones,
                ((size_t)layer * B + blockIdx.x) * ctx, valid, D, part);
  finish_layer(head, D, H, part, acc_out, m_out, l_out);
}

// Kernel H for block (stream b, head pair h, h + H/2): the caches and
// scales of kernel G
template <typename T, typename KC, class SC>
__global__ void __launch_bounds__(SELF_THREADS, 2)
layer_int4_kernel(const T* __restrict__ q, const KC* __restrict__ kc,
                  const uint8_t* __restrict__ vc, const float* __restrict__ kvs,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int layer, int valid, int B, int ctx, int D, int H,
                  int sw, int kgs, int vgs, int voff) {
  __shared__ Partials<2> part;
  const int h = blockIdx.y;
  const int head[2] = {h, h + H / 2};
  const SC ks[2] = {SC::of(kvs, sw, 0, kgs, head[0]), SC::of(kvs, sw, 0, kgs, head[1])};
  const SC vs[2] = {SC::of(kvs, sw, voff, vgs, head[0]), SC::of(kvs, sw, voff, vgs, head[1])};
  attend_cached(q, head, pair_of(kc, D, H, h), pair_of(vc, D, H, h), ks, vs,
                ((size_t)layer * B + blockIdx.x) * ctx, valid, D, part);
  finish_layer(head, D, H, part, acc_out, m_out, l_out);
}

// launch G (MERGED) or H over one of the three int4 self-cache forms:
// int4 keys with scales, int4 keys without, int8 keys with (mixed)
template <bool MERGED, typename T, typename KC, class SC>
int launch_int4(const void* q, const void* kc, const void* vc, const void* kvs, const void* k_new,
                const void* v_new, float* o0, float* o1, float* o2, int layer, int valid, int B,
                int ctx, int D, int H, int sw, int kgs, int vgs, int voff,
                cudaStream_t st) {
  dim3 grid(B, H / 2);
  const T* qt = static_cast<const T*>(q);
  const KC* k = static_cast<const KC*>(kc);
  const uint8_t* v = static_cast<const uint8_t*>(vc);
  const float* sc = static_cast<const float*>(kvs);
  if constexpr (MERGED) {
    merged_int4_kernel<T, KC, SC><<<grid, SELF_THREADS, 0, st>>>(
        qt, k, v, sc, static_cast<const T*>(k_new), static_cast<const T*>(v_new), o0, layer, valid,
        B, ctx, D, H, sw, kgs, vgs, voff);
  } else {
    layer_int4_kernel<T, KC, SC><<<grid, SELF_THREADS, 0, st>>>(
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
// out: f32 [B, D]. Head width 64, caches 16-byte aligned. Needs
// 0 <= pos < ctx.
extern "C" int decode_self_attention(const void* q, int bf16, void* kc, void* vc, void* kvs,
                                     const void* k_new, const void* v_new, const void* kq,
                                     const void* vq, const void* new_scale, void* out,
                                     int layer, int pos, int B, int ctx, int D, int H,
                                     void* stream) {
  dim3 grid(B, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* k8 = static_cast<int8_t*>(kc);
  int8_t* v8 = static_cast<int8_t*>(vc);
  float* sc = static_cast<float*>(kvs);
  const int8_t* kq8 = static_cast<const int8_t*>(kq);
  const int8_t* vq8 = static_cast<const int8_t*>(vq);
  const float* ns = static_cast<const float*>(new_scale);
  float* o = static_cast<float*>(out);
  if (bf16) {
    self_attn_kernel<__nv_bfloat16><<<grid, SELF_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), k8, v8, sc,
        static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
        kq8, vq8, ns, o, layer, pos, B, ctx, D);
  } else {
    self_attn_kernel<float><<<grid, SELF_THREADS, 0, st>>>(
        static_cast<const float*>(q), k8, v8, sc, static_cast<const float*>(k_new),
        static_cast<const float*>(v_new), kq8, vq8, ns, o, layer, pos, B, ctx, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, k_new, v_new: [B, D]; kc, vc: [L, B, ctx, D]; all f32, or all bf16
// (bf16 flag); out: f32 [B, D], normalized; nothing is stored. Head width
// 64, caches 16-byte aligned. Needs 0 <= pos < ctx.
extern "C" int decode_attention_merged(const void* q, int bf16, const void* kc, const void* vc,
                                       const void* k_new, const void* v_new, void* out, int layer,
                                       int pos, int B, int ctx, int D, int H, void* stream) {
  dim3 grid(B, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bf16) {
    using T = __nv_bfloat16;
    merged_attn_kernel<T><<<grid, SELF_THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), o, layer, pos, B, ctx, D);
  } else {
    merged_attn_kernel<float><<<grid, SELF_THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kc), static_cast<const float*>(vc),
        static_cast<const float*>(k_new), static_cast<const float*>(v_new), o, layer, pos, B, ctx,
        D);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [B, D] f32 or bf16 (bf16 flag), B query streams; kc, vc: int8
// [L, B, ctx, D]; kvs: f32 [L, B, ctx, 2]; acc: f32 [B, D]; m, l: f32
// [B, H]. Head width 64, caches 16-byte aligned. Needs 0 <= valid <= ctx.
extern "C" int decode_attention_layer(const void* q, int bf16, const void* kc, const void* vc,
                                      const void* kvs, void* acc, void* m, void* l, int layer,
                                      int valid, int B, int ctx, int D, int H, void* stream) {
  dim3 grid(B, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* k8 = static_cast<const int8_t*>(kc);
  const int8_t* v8 = static_cast<const int8_t*>(vc);
  const float* sc = static_cast<const float*>(kvs);
  float* a = static_cast<float*>(acc);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (bf16) {
    layer_attn_kernel<__nv_bfloat16><<<grid, SELF_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), k8, v8, sc, a, mo, lo, layer, valid, B, ctx, D, H);
  } else {
    layer_attn_kernel<float><<<grid, SELF_THREADS, 0, st>>>(
        static_cast<const float*>(q), k8, v8, sc, a, mo, lo, layer, valid, B, ctx, D, H);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [B, D]; kc, vc: [L, B, ctx, D]; all f32, or all bf16 (bf16 flag);
// acc: f32 [B, D]; m, l: f32 [B, H]. Head width 64, caches 16-byte
// aligned. Needs 0 <= valid <= ctx.
extern "C" int decode_attention_layer_unscaled(const void* q, int bf16, const void* kc,
                                               const void* vc, void* acc, void* m, void* l,
                                               int layer, int valid, int B, int ctx, int D, int H,
                                               void* stream) {
  dim3 grid(B, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (bf16) {
    using T = __nv_bfloat16;
    layer_unscaled_kernel<T><<<grid, SELF_THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), a, mo, lo,
        layer, valid, B, ctx, D, H);
  } else {
    layer_unscaled_kernel<float><<<grid, SELF_THREADS, 0, st>>>(
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
// group a whole number of heads, caches 16-byte aligned. Needs
// 0 <= pos < ctx.
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
