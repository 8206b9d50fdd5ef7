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
//   mode). Per-token scales [L, B, ctx, sw] f32, K lanes first: where a
//   head's 64 channels lie in one channel group each (token, head) has one
//   K and one V scale (Lane::of); the scalar-scale form reads lanes 0 and 1,
//   the unscaled form none. With an odd head count (a tensor-parallel
//   shard's, 5 heads at Large-V3 over 4 ranks) heads h and h + H/2 share
//   no byte, and groups may be narrower than a head (32 channels there):
//   then one block serves one head, each lane's 16 channels from their own
//   nibble (NibbleHead) with their own group's scale (LaneGroup), applied
//   before the lanes' sum. The TPU kernel rounds the dequantized keys to
//   the compute dtype before its dot and folds the bias out as 8 * sum(q);
//   here the dot runs in f32 on the unbiased codes.
//
// The position (pos, or valid) lives in device memory as one int32 that
// each block reads once (clamped into the cache): the decode loop keeps it
// on the card and replays a captured CUDA graph of its step, whose launch
// arguments are fixed, as the Pallas kernels take it by scalar prefetch.
// The grids do not depend on it, so one capture serves every position.
//
// Bound: the cache read, a few µs of launch and latency above it. At pos
// keys a stream and layer: B 2 * pos * D bytes and 8 * pos of scales
// (0.75 µs at B = 8, pos 115, D 1280), B' and E' 2 * pos * D elements, G
// and H pos * D bytes of int4 K and V (1.5x that mixed) and sw * 4 scale
// bytes a token (0.40 µs at B = 8).
//
// Design, one loop for all six (attend_cached): one block of 8 warps per
// (stream, head), for G and H per (stream, head pair h, h + H/2), so each
// packed byte is read once (at an odd head count per (stream, head), each
// byte read by the two blocks of its nibbles). A lane loads 16 bytes of a key row and 16 of
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

// Kernels C and C', decode_cross_attention and
// decode_cross_attention_unpacked, replace
// whisper_burn_tpu/ops/pallas_attention.py:_kt_kernel (normalized): one
// query per stream over layer `layer` of the cross cache, keys at `valid`
// and above masked, G query streams per cache entry (beam search's
// batch_groups; stream b reads entry b / G). C takes the int4 cache: keys
// int4 pairs packed along D, [L, E, D/2, T] (byte row j holds channel j
// low and j + D/2 high, so heads h and h + H/2 share every key byte),
// values packed along T, [L, E, T/2, D] (row t2 holds time t2 low and
// t2 + T/2 high), codes biased by 8. C' takes int8 codes or an f32/bf16
// cache of the query's dtype: keys [L, E, D, T], values [L, E, T, D].
// Per-channel scales are folded into q and the output by the caller.
//
// Arithmetic, as K3 in its compute dtype: scores in f32 from q and the
// codes or values; m and l = sum(p) in f32; the value product on p
// rounded to the query's dtype (bf16; f32 unchanged), then divided by l;
// in bf16 the int4 codes' bias folded out as K3 does, q . nibble - 8 sum(q)
// and sum(round(p) * nibble) - 8 * l (pallas_attention.py:690,701,711).
// Rounding p needs the global max before any p is formed, so the maxima
// are exchanged before the value pass.
//
// Bound: the cache read, once per entry whatever G (memory): at Large-V3
// (D 1280, T 1536, 1500 valid) 1.94 MB an entry and layer for C, 3.84 MB
// for bf16 C'. Design: the keys are split over the blocks of a thread
// block cluster (split-KV, as in flash-decoding). A cluster serves one
// (entry, head pair h, h + H/2) for C, (entry, head) for C' and for C at
// an odd head count (a tensor-parallel shard's, 5 heads at Large-V3 over 4
// ranks: there heads h and h + H/2 share no key byte, so the cluster of
// head h reads the nibble of each of its key channel rows, the low below
// D/2 and the high above, and its own value bytes); its S <= 16
// blocks take runs of 16-key units (S so the grid fills three quarters of
// the card: enough blocks at B = 1, few enough at B = 8 for each block to
// stream several steps), for C a run of packed value rows t2 with the keys
// t2 and t2 + T/2, so every key and value byte of the entry is read by
// exactly one block, which serves all G streams of the entry. A block
// walks its run in steps of 128 keys (C: rows): each step's keys, then
// each step's values, go through a ring of shared-memory stages by 16-byte
// cp.async, two stages in flight while one is used (key columns at and
// past `valid` are not read). Scores, per step: with one stream, or an f32
// query, on CUDA cores, a thread 4 keys and a quarter (C) or an eighth
// (C') of the 64 channel rows, the partial dots meeting by shuffles; with
// a bf16 query of several streams, on the tensor cores (mma.sync
// m16n8k16, bf16 in and f32 accumulate as K3's dots; rows 0-7 the streams
// of head h, for C rows 8-15 those of h + H/2; codes to bf16 by a byte
// permute). The block's maxima go to every block of the cluster through
// distributed shared memory; after one cluster barrier each block forms p
// against the global max and rounds it, and the value product runs step
// by step the same way (CUDA cores: a warp a run of rows, 4 channels a
// lane; tensor cores: a warp an 8-channel tile, p as A). The warps' sums
// meet in shared memory in warp order and are pushed, with each block's l,
// to the block that owns those outputs; after a second cluster barrier the
// owner sums them in rank order and normalizes. Fixed orders, no atomics:
// two launches give bitwise equal results.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 64;
constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// The position a block reads once from device memory, clamped into
// [0, hi] so that no position reads or writes outside the cache.
__device__ __forceinline__ int read_pos(const int* at, int hi) { return min(max(*at, 0), hi); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Head h alone of an int4 cache, for odd head counts: channel c of the
// row lies in the low nibble of byte c below D/2 and in the high nibble of
// byte c - D/2 above; a lane's 16 channels lie on one side (D/2 = 32 H),
// so each lane has its own byte offset b0 and nibble (NH = 1).
struct NibbleHead {
  static constexpr int CPL = 16;
  struct Raw {
    uint4 w;
  };
  const uint8_t* p;
  int D2, b0, nib;
  static __device__ NibbleHead of(const uint8_t* p, int D, int h) {
    const int c = h * DH + (threadIdx.x % 32) % (DH / CPL) * CPL;  // the lane's first channel
    const int hi = c >= D / 2;
    return {p, D / 2, c - hi * (D / 2), hi};
  }
  __device__ Raw load(size_t row, int) const { return {load16(p + row * D2 + b0)}; }
  __device__ void unpack(const Raw& r, int, float* f) const {
    const uint32_t u[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b) f[4 * k + b] = biased_byte((u[k] >> (4 * nib)) & 0x0f0f0f0fu, b) - 8388616.0f;
  }
};

// head h alone of an int4-valued cache: int4 pairs, or int8 codes (the
// mixed mode's keys)
__device__ __forceinline__ NibbleHead head_of(const uint8_t* p, int D, int h) { return NibbleHead::of(p, D, h); }
__device__ __forceinline__ Rows<int8_t, 1> head_of(const int8_t* p, int D, int h) { return {p, D, {h * DH}}; }

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
  static constexpr bool PER_LANE = false;  // one scale for the whole head
  const float* p;
  int sw, lane;
  static __device__ Lane of(const float* p, int sw, int off, int gs, int h) {
    return {p, sw, off + (gs ? h * DH / gs : 0)};
  }
  __device__ float at(size_t row) const { return p[row * sw + lane]; }
};

struct One {
  static constexpr bool PER_LANE = false;
  static __device__ One of(const float*, int, int, int, int) { return {}; }
  __device__ float at(size_t) const { return 1.f; }
};

// A lane's per-token scale where a head spans several groups (the
// one-head form): the lane of this lane's 16 channels, off + c / gs for
// its first channel c (off itself for gs = 0). A key score takes it per
// lane, before the lanes' partial dots are summed (PER_LANE).
struct LaneGroup {
  static constexpr bool PER_LANE = true;
  const float* p;
  int sw, lane;
  static __device__ LaneGroup of(const float* p, int sw, int off, int gs, int h) {
    const int c = h * DH + (threadIdx.x % 32) % (DH / 16) * 16;
    return {p, sw, off + (gs ? c / gs : 0)};
  }
  __device__ float at(size_t row) const { return p[row * sw + lane]; }
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
        if constexpr (KS::PER_LANE) d *= sk[u][j];  // this lane's group
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
        s[u] = ok[u] ? (KS::PER_LANE ? d * scale : d * scale * sk[u][j]) : NEG_BIG;
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
                 int layer, const int* __restrict__ pos_at, int B, int ctx, int D) {
  __shared__ Partials<1> part;
  const int b = blockIdx.x, h = blockIdx.y;
  const int pos = read_pos(pos_at, ctx - 1);
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
                   float* __restrict__ out, int layer, const int* __restrict__ pos_at, int B, int ctx,
                   int D) {
  __shared__ Partials<1> part;
  const int h = blockIdx.y;
  const int pos = read_pos(pos_at, ctx - 1);
  const int head[1] = {h};
  const TokenCols tok = token_cols(q, k_new, v_new, head, D);
  const One ones[1] = {{}};
  using KA = Rows<T, 1>;
  attend_cached(q, head, KA{kc, D, {h * DH}}, KA{vc, D, {h * DH}}, ones, ones,
                ((size_t)layer * B + blockIdx.x) * ctx, pos, D, part);
  finish_merged(tok, head, D, part, out);
}

// Kernel G for block (stream b, head pair h, h + H/2), or with !PAIRS
// (odd head counts, groups narrower than a head) for block (stream b,
// head h): keys KC (uint8 int4 pairs, or int8 codes in the mixed mode)
// and int4 values, per-token scales SC (Lane, LaneGroup without pairs, or
// One for the unscaled int4 form); lanes as in Lane::of.
template <typename T, typename KC, class SC, bool PAIRS>
__global__ void __launch_bounds__(SELF_THREADS, 2)
merged_int4_kernel(const T* __restrict__ q, const KC* __restrict__ kc,
                   const uint8_t* __restrict__ vc, const float* __restrict__ kvs,
                   const T* __restrict__ k_new, const T* __restrict__ v_new,
                   float* __restrict__ out, int layer, const int* __restrict__ pos_at, int B, int ctx,
                   int D, int H, int sw, int kgs, int vgs, int voff) {
  constexpr int NH = PAIRS ? 2 : 1;
  __shared__ Partials<NH> part;
  const int h = blockIdx.y;
  const int pos = read_pos(pos_at, ctx - 1);
  const size_t row0 = ((size_t)layer * B + blockIdx.x) * ctx;
  if constexpr (PAIRS) {
    const int head[2] = {h, h + H / 2};
    const TokenCols tok = token_cols(q, k_new, v_new, head, D);
    const SC ks[2] = {SC::of(kvs, sw, 0, kgs, head[0]), SC::of(kvs, sw, 0, kgs, head[1])};
    const SC vs[2] = {SC::of(kvs, sw, voff, vgs, head[0]), SC::of(kvs, sw, voff, vgs, head[1])};
    attend_cached(q, head, pair_of(kc, D, H, h), pair_of(vc, D, H, h), ks, vs, row0, pos, D, part);
    finish_merged(tok, head, D, part, out);
  } else {
    const int head[1] = {h};
    const TokenCols tok = token_cols(q, k_new, v_new, head, D);
    const SC ks[1] = {SC::of(kvs, sw, 0, kgs, h)}, vs[1] = {SC::of(kvs, sw, voff, vgs, h)};
    attend_cached(q, head, head_of(kc, D, h), head_of(vc, D, h), ks, vs, row0, pos, D, part);
    finish_merged(tok, head, D, part, out);
  }
}

// Kernel E for block (stream b, head h)
template <typename T>
__global__ void __launch_bounds__(SELF_THREADS, 2)
layer_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                  const int8_t* __restrict__ vc, const float* __restrict__ kvs,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int layer, const int* __restrict__ valid_at, int B,
                  int ctx, int D, int H) {
  __shared__ Partials<1> part;
  const int h = blockIdx.y;
  const int valid = read_pos(valid_at, ctx);
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
                      float* __restrict__ l_out, int layer, const int* __restrict__ valid_at, int B,
                      int ctx, int D, int H) {
  __shared__ Partials<1> part;
  const int h = blockIdx.y;
  const int valid = read_pos(valid_at, ctx);
  const int head[1] = {h};
  const One ones[1] = {{}};
  using KA = Rows<T, 1>;
  attend_cached(q, head, KA{kc, D, {h * DH}}, KA{vc, D, {h * DH}}, ones, ones,
                ((size_t)layer * B + blockIdx.x) * ctx, valid, D, part);
  finish_layer(head, D, H, part, acc_out, m_out, l_out);
}

// Kernel H for block (stream b, head pair h, h + H/2), or with !PAIRS
// for block (stream b, head h): the caches and scales of kernel G
template <typename T, typename KC, class SC, bool PAIRS>
__global__ void __launch_bounds__(SELF_THREADS, 2)
layer_int4_kernel(const T* __restrict__ q, const KC* __restrict__ kc,
                  const uint8_t* __restrict__ vc, const float* __restrict__ kvs,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int layer, const int* __restrict__ valid_at, int B,
                  int ctx, int D, int H, int sw, int kgs, int vgs, int voff) {
  constexpr int NH = PAIRS ? 2 : 1;
  __shared__ Partials<NH> part;
  const int h = blockIdx.y;
  const int valid = read_pos(valid_at, ctx);
  const size_t row0 = ((size_t)layer * B + blockIdx.x) * ctx;
  if constexpr (PAIRS) {
    const int head[2] = {h, h + H / 2};
    const SC ks[2] = {SC::of(kvs, sw, 0, kgs, head[0]), SC::of(kvs, sw, 0, kgs, head[1])};
    const SC vs[2] = {SC::of(kvs, sw, voff, vgs, head[0]), SC::of(kvs, sw, voff, vgs, head[1])};
    attend_cached(q, head, pair_of(kc, D, H, h), pair_of(vc, D, H, h), ks, vs, row0, valid, D, part);
    finish_layer(head, D, H, part, acc_out, m_out, l_out);
  } else {
    const int head[1] = {h};
    const SC ks[1] = {SC::of(kvs, sw, 0, kgs, h)}, vs[1] = {SC::of(kvs, sw, voff, vgs, h)};
    attend_cached(q, head, head_of(kc, D, h), head_of(vc, D, h), ks, vs, row0, valid, D, part);
    finish_layer(head, D, H, part, acc_out, m_out, l_out);
  }
}

// launch G (MERGED) or H over one of the three int4 self-cache forms:
// int4 keys with scales, int4 keys without, int8 keys with (mixed); in
// head pairs where the head count is even and no group splits a head,
// else one head a block (SC's per-lane form, LaneGroup, where it scales)
template <bool MERGED, typename T, typename KC, class SC>
int launch_int4(const void* q, const void* kc, const void* vc, const void* kvs, const void* k_new,
                const void* v_new, float* o0, float* o1, float* o2, int layer, const int* valid,
                int B, int ctx, int D, int H, int sw, int kgs, int vgs, int voff, cudaStream_t st) {
  using SC1 = typename std::conditional<std::is_same<SC, One>::value, One, LaneGroup>::type;
  const bool pairs = H % 2 == 0 && kgs % DH == 0 && vgs % DH == 0;
  const T* qt = static_cast<const T*>(q);
  const KC* k = static_cast<const KC*>(kc);
  const uint8_t* v = static_cast<const uint8_t*>(vc);
  const float* sc = static_cast<const float*>(kvs);
  const T* kn = static_cast<const T*>(k_new);
  const T* vn = static_cast<const T*>(v_new);
  if constexpr (MERGED) {
    if (pairs)
      merged_int4_kernel<T, KC, SC, true><<<dim3(B, H / 2), SELF_THREADS, 0, st>>>(
          qt, k, v, sc, kn, vn, o0, layer, valid, B, ctx, D, H, sw, kgs, vgs, voff);
    else
      merged_int4_kernel<T, KC, SC1, false><<<dim3(B, H), SELF_THREADS, 0, st>>>(
          qt, k, v, sc, kn, vn, o0, layer, valid, B, ctx, D, H, sw, kgs, vgs, voff);
  } else {
    if (pairs)
      layer_int4_kernel<T, KC, SC, true><<<dim3(B, H / 2), SELF_THREADS, 0, st>>>(
          qt, k, v, sc, o0, o1, o2, layer, valid, B, ctx, D, H, sw, kgs, vgs, voff);
    else
      layer_int4_kernel<T, KC, SC1, false><<<dim3(B, H), SELF_THREADS, 0, st>>>(
          qt, k, v, sc, o0, o1, o2, layer, valid, B, ctx, D, H, sw, kgs, vgs, voff);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool MERGED, typename T>
int launch_int4_form(int k_int4, const void* q, const void* kc, const void* vc, const void* kvs,
                     const void* k_new, const void* v_new, float* o0, float* o1, float* o2,
                     int layer, const int* valid, int B, int ctx, int D, int H, int sw, int kgs,
                     int vgs, int voff, cudaStream_t st) {
  if (!k_int4)
    return launch_int4<MERGED, T, int8_t, Lane>(q, kc, vc, kvs, k_new, v_new, o0, o1, o2, layer,
                                                valid, B, ctx, D, H, sw, kgs, vgs, voff, st);
  if (sw)
    return launch_int4<MERGED, T, uint8_t, Lane>(q, kc, vc, kvs, k_new, v_new, o0, o1, o2, layer,
                                                 valid, B, ctx, D, H, sw, kgs, vgs, voff, st);
  return launch_int4<MERGED, T, uint8_t, One>(q, kc, vc, kvs, k_new, v_new, o0, o1, o2, layer,
                                              valid, B, ctx, D, H, sw, kgs, vgs, voff, st);
}

// ---- kernels C and C': split-key cross-attention over a cluster -----------

constexpr int X_THREADS = 256;
constexpr int X_WARPS = X_THREADS / 32;
constexpr int X_UNIT = 16;          // keys (C: packed value rows) a unit of the split
constexpr int X_STEP = 128;         // keys (C: packed value rows) a step of a block
constexpr int X_MAX_CLUSTER = 16;   // blocks a cluster (non-portable above 8)
// blocks a multiprocessor holds by registers: one stream a block needs few
#define X_BLOCKS_PER_SM(NG) ((NG) == 1 ? 3 : 2)
constexpr int X_FILL_PERCENT = 75;  // blocks a launch aims at, in % of those the card holds at once
constexpr int X_SCORE_BYTES = 64 * 1024;  // a block's score buffer at most
constexpr int X_STAGES = 3;               // ring stages (f32 caches: 2)
// row padding in shared memory, so lanes that read other rows read other
// banks; rows stay 16-byte aligned for cp.async (int8 keys need 16)
constexpr int X_KPAD = 16;  // key rows, elements (int4 pairs: twice this in bytes)
constexpr int X_VPAD = 16;  // value rows, bytes
// streams a block from which bf16 queries take the tensor cores (on
// CUDA cores one stream's products cost no more than the code conversion)
constexpr int X_MMA_MIN_STREAMS = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// four consecutive cache elements in shared memory as floats
__device__ __forceinline__ void four(const int8_t* p, float* f) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = biased_byte(u, b) - 8388736.0f;
}
__device__ __forceinline__ void four(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16), f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16), f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void four(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}

// p in the query's dtype: bf16 rounds to nearest even, f32 stays
__device__ __forceinline__ float rounded(float p, const float*) { return p; }
__device__ __forceinline__ float rounded(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

// nibble n (0 low, 1 high) of four bytes of int4 pairs as floats, minus `bias`
__device__ __forceinline__ void nibbles(uint32_t u, int n, float bias, float* f) {
  const uint32_t x = (u >> (4 * n)) & 0x0f0f0f0fu;
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = biased_byte(x, b) - (8388608.0f + bias);
}

// D += A B on the tensor cores: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats that bf16 holds exactly (codes, bf16 values, rounded p) as
// a bf16 pair, a low: their high halves
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// the mma fragment of 4 codes (k rows 2c, 2c + 1, 2c + 8, 2c + 9 of one
// column) held in the bytes of w: as two bf16 pairs
__device__ __forceinline__ void code_pairs(uint32_t w, float bias, bool sign, uint32_t& b0, uint32_t& b1) {
  const float off = sign ? 8388736.0f : 8388608.0f + bias;
  if (sign) w ^= 0x80808080u;
  b0 = bf16_pair(biased_byte(w, 0) - off, biased_byte(w, 1) - off);
  b1 = bf16_pair(biased_byte(w, 2) - off, biased_byte(w, 3) - off);
}

// The cache forms. Keys sit in shared memory as 64 channel rows of KEYS
// columns, KPITCH bytes apart (padded so the JS lanes of a key group read
// other banks); values as rows of VROW bytes, VPITCH apart (padded so an
// mma fragment's four rows lie in other banks). A thread of the score pass
// takes 4 key columns and every JS-th channel row.
struct Int4Pairs {  // C: NH = 2 heads a block; key columns [0, 128) the
                    // times r0 + c, [128, 256) the times T/2 + r0 + c - 128
  using Code = uint8_t;
  static constexpr bool PACKED = true;
  static constexpr int NH = 2, KEYS = 2 * X_STEP, HALF = X_STEP, JS = 4, STAGES = X_STAGES;
  static constexpr int KPITCH = KEYS + 2 * X_KPAD, VROW = 2 * DH, VPITCH = VROW + X_VPAD;
  // keys(): 4 key columns of a channel row; `plane`, the row's nibble,
  // is Int4Head's (a pair takes both)
  static __device__ void keys(const unsigned char* row, int col, int, float bias, float (*f)[4]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(row + col);
    nibbles(u, 0, bias, f[0]);  // head h
    nibbles(u, 1, bias, f[1]);  // head h + H/2
  }
  // the bytes of an mma B fragment: rows k0 + 2c, + 1, + 8, + 9 (pitch
  // bytes apart) at element col; frag() turns nibble plane n (0 low, 1
  // high) of them into the fragment
  static __device__ uint32_t gather(const unsigned char* p, int pitch, int k0, int col) {
    const unsigned char* b = p + (k0 + 2 * (threadIdx.x % 4)) * pitch + col;
    return b[0] | b[pitch] << 8 | b[8 * pitch] << 16 | (uint32_t)b[9 * pitch] << 24;
  }
  static __device__ void frag(uint32_t w, int n, float bias, uint32_t& b0, uint32_t& b1) {
    code_pairs((w >> (4 * n)) & 0x0f0f0f0fu, bias, false, b0, b1);
  }
};
// C at an odd head count: NH = 1 head a block; a key channel row holds
// the head's channel in nibble `plane` (the low one below D/2, the high
// one above), the other nibble another head's; values as Int4Pairs', one
// head's 64 bytes a row
struct Int4Head : Int4Pairs {
  static constexpr int NH = 1, VROW = DH, VPITCH = VROW + X_VPAD;
  static __device__ void keys(const unsigned char* row, int col, int plane, float bias, float (*f)[4]) {
    nibbles(*reinterpret_cast<const uint32_t*>(row + col), plane, bias, f[0]);
  }
};
template <typename C>
struct Plain {  // C': one head a block, key columns the times r0 + c
  using Code = C;
  static constexpr bool PACKED = false;
  static constexpr int NH = 1, KEYS = X_STEP, HALF = X_STEP, JS = 8, STAGES = sizeof(C) < 4 ? X_STAGES : 2;
  static constexpr int KPITCH = (KEYS + X_KPAD) * (int)sizeof(C), VROW = DH * (int)sizeof(C), VPITCH = VROW + X_VPAD;
  static __device__ void keys(const unsigned char* row, int col, int, float, float (*f)[4]) {
    four(reinterpret_cast<const C*>(row) + col, f[0]);
  }
  // an mma B fragment for a bf16 query (int8 codes or bf16 values), as
  // Int4Pairs' (no planes)
  static __device__ uint2 gather(const unsigned char* p, int pitch, int k0, int col) {
    const unsigned char* b = p + (k0 + 2 * (threadIdx.x % 4)) * pitch + col * (int)sizeof(C);
    if constexpr (sizeof(C) == 1) {
      return make_uint2(b[0] | b[pitch] << 8 | b[8 * pitch] << 16 | (uint32_t)b[9 * pitch] << 24, 0u);
    } else {
      auto h = [&](int r) { return (uint32_t)*reinterpret_cast<const uint16_t*>(b + r * pitch); };
      return make_uint2(h(0) | h(1) << 16, h(8) | h(9) << 16);
    }
  }
  static __device__ void frag(uint2 w, int, float, uint32_t& b0, uint32_t& b1) {
    if constexpr (sizeof(C) == 1) {
      code_pairs(w.x, 0.f, true, b0, b1);
    } else {
      b0 = w.x, b1 = w.y;
    }
  }
};

template <class F, int NG>
struct XLayout {
  static constexpr int NQ = NG * F::NH;        // query rows: (stream, head)
  static constexpr int NQP = (NQ + 3) / 4 * 4;
  static constexpr int NO = NQ * DH;           // outputs of a cluster
  // a ring stage holds one step's keys (64 channel rows) or values (128 rows)
  static constexpr int STAGE_KEYS = DH * F::KPITCH, STAGE_VALUES = X_STEP * F::VPITCH;
  static constexpr int STAGE = STAGE_KEYS > STAGE_VALUES ? STAGE_KEYS : STAGE_VALUES;
  static constexpr int RING = F::STAGES * STAGE;
  static constexpr int QT = RING;                               // q, [64][NQP]
  static constexpr int RECV = QT + DH * NQP * 4;                // owners' sums
  static constexpr int MX = RECV + (NO + X_MAX_CLUSTER) * 4;    // the blocks' maxima
  static constexpr int LR = MX + X_MAX_CLUSTER * NQ * 4;        // the blocks' l
  static constexpr int RED = LR + X_MAX_CLUSTER * NQ * 4;       // the warps' maxima and sums
  static constexpr int QSUM = RED + X_WARPS * NQ * 4;           // the rows' sums of q
  static constexpr int PS = QSUM + NQP * 4;                     // scores, then p: [NQ][pitch(steps)]
  // a row of scores: 8 floats of padding put an mma fragment's 8 rows in
  // other banks
  static constexpr __host__ __device__ int pitch(int steps) { return steps * F::KEYS + 8; }
  static constexpr int bytes(int steps) { return PS + NQ * pitch(steps) * 4; }
  // the warps' value sums reuse the ring
  static_assert(X_WARPS * NO * 4 <= RING, "partials fit over the ring");
};

// The block of cluster rank `rank` over units [u0, u0 + nu) of cluster
// (entry e, head unit hu): C' head hu, C heads hu and hu + H/2 (at an odd
// head count, Int4Head, head hu). It walks
// its units in steps of X_STEP keys (C: packed value rows): every step's
// keys, then every step's values, each a chunk through a ring of
// F::STAGES stages, so F::STAGES - 1 chunks are in flight while one is
// used. `steps` sizes the score buffer.
template <typename T, class F, int NG>
__device__ void cross_split(const T* __restrict__ q, const typename F::Code* __restrict__ kT,
                            const typename F::Code* __restrict__ v, float* __restrict__ out,
                            int layer, int valid, int E, int G, int D, int Tn, int H, int units) {
  using Lay = XLayout<F, NG>;
  using Code = typename F::Code;
  constexpr bool PACKED = F::PACKED;
  // bf16 folds the int4 codes' bias out after each sum, as K3 does, so p
  // rounds where K3's does; in f32, where p is not rounded, the sums are
  // taken on the unbiased codes
  constexpr bool FOLD = PACKED && !std::is_same<T, float>::value;
  // bf16 queries of several streams take both products on the tensor
  // cores (m16n8k16: rows 0-7 the streams of head h, C's rows 8-15 those of
  // h + H/2); f32, and one stream, on CUDA cores
  constexpr bool MMA = !std::is_same<T, float>::value && NG >= X_MMA_MIN_STREAMS;
  static_assert(NG <= 8, "a block serves at most 8 streams");
  constexpr int NQ = Lay::NQ, NQP = Lay::NQP, NO = Lay::NO, JS = F::JS, NS = F::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem + Lay::PS);
  float* qt = reinterpret_cast<float*>(smem + Lay::QT);
  float* recv = reinterpret_cast<float*>(smem + Lay::RECV);
  float* mx = reinterpret_cast<float*>(smem + Lay::MX);
  float* lr = reinterpret_cast<float*>(smem + Lay::LR);
  float* red = reinterpret_cast<float*>(smem + Lay::RED);
  float* qsum_s = reinterpret_cast<float*>(smem + Lay::QSUM);
  float* part = reinterpret_cast<float*>(smem);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hu = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int u0 = rank * units / S, nu = (rank + 1) * units / S - u0;
  const int r0 = u0 * X_UNIT, rows = nu * X_UNIT;  // C: packed value rows; C': keys
  const int steps = (rows + X_STEP - 1) / X_STEP, cols = steps * F::KEYS, pp = Lay::pitch(steps);
  const int T2 = Tn / 2;
  const size_t entry = (size_t)layer * E + e;
  auto head = [&](int jh) { return hu + jh * (H / 2); };
  // Int4Head: the nibble of the head's key channel row j. It changes at
  // most once in a head, at j = 32 (D/2 = 32 H), so the 16 rows of an mma
  // k-step share it
  auto plane = [&](int j) { return hu * DH + j >= D / 2 ? 1 : 0; };
  // score column c (step c / KEYS): its time, and whether it is a valid key
  auto time_of = [&](int c) {
    const int k = c % F::KEYS;
    return r0 + c / F::KEYS * X_STEP + k % F::HALF + (PACKED && k >= F::HALF ? T2 : 0);
  };
  auto col_ok = [&](int c) {
    return c / F::KEYS * X_STEP + c % F::KEYS % F::HALF < rows && time_of(c) < valid;
  };

  // chunk k < steps: the keys of step k; k >= steps: the values of step k - steps
  auto issue = [&](int k) {
    unsigned char* stage = smem + k % NS * Lay::STAGE;
    if (k < steps) {
      constexpr int KCH = X_UNIT * (int)sizeof(Code) / 16;  // 16-byte chunks a unit of a key row
      constexpr int UPS = X_STEP / X_UNIT;                   // units a step
      constexpr int PER = (PACKED ? 2 : 1) * UPS * KCH;      // chunks a channel row
      const int su = min(UPS, nu - k * UPS);
      for (int i = tid; i < DH * PER; i += X_THREADS) {
        const int j = i / PER, rest = i % PER, half = rest / (UPS * KCH);
        const int u = rest % (UPS * KCH) / KCH, sub = rest % KCH;
        const int col = half * F::HALF + u * X_UNIT;  // the unit's first column in the step
        const int t = time_of(k * F::KEYS + col);
        if (u >= su || t >= valid) continue;  // never used: masked
        const int c = hu * DH + j;  // C: its byte row c mod D/2 (c itself for a pair)
        const size_t krow = entry * (PACKED ? D / 2 : D) + (PACKED ? c % (D / 2) : c);
        cp_async16(stage + j * F::KPITCH + col * (int)sizeof(Code) + sub * 16,
                   kT + krow * Tn + t + sub * (16 / (int)sizeof(Code)));
      }
    } else if (k < 2 * steps) {
      constexpr int VCH = DH * (int)sizeof(Code) / 16;  // 16-byte chunks of a head's value row
      constexpr int PER = F::NH * VCH;
      const int s = k - steps, sr = min(X_STEP, rows - s * X_STEP);
      for (int i = tid; i < sr * PER; i += X_THREADS) {
        const int r = i / PER, c = i % PER;
        const size_t vrow = entry * (PACKED ? T2 : Tn) + r0 + s * X_STEP + r;
        cp_async16(stage + r * F::VPITCH + c * 16,
                   v + vrow * D + head(c / VCH) * DH + c % VCH * (16 / (int)sizeof(Code)));
      }
    }
    cp_async_commit();  // one group a chunk, empty past the last
  };
  for (int k = 0; k < NS - 1; ++k) issue(k);

  // q of the entry's streams, [channel][query row], padded rows zero
  for (int i = tid; i < DH * NQP; i += X_THREADS) {
    const int j = i / NQP, qr = i % NQP, g = qr / F::NH;
    qt[i] = qr < NQ && g < G ? to_f(q[(size_t)(e * G + g) * D + head(qr % F::NH) * DH + j]) : 0.f;
  }
  // MMA: q as A fragments, a k-step of 16 channels and a head each (a0, a2
  // for rows g = lane / 4 of head h, a1, a3 for those of h + H/2; zero past
  // the streams), and the rows' sums of q
  const int fr = lane / 4, fc = lane % 4;  // a fragment's row (stream) and column pair
  uint32_t qa[MMA ? 4 : 1][F::NH][2] = {};
  if constexpr (MMA) {
    __syncthreads();
    for (int r = warp; r < NQ; r += X_WARPS) {
      float x = qt[lane * NQP + r] + qt[(lane + 32) * NQP + r];
      x = warp_sum(x);
      if (lane == 0) qsum_s[r] = x;
    }
    if (fr < NG)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int jh = 0; jh < F::NH; ++jh)
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            const int j = ks * 16 + h8 * 8 + 2 * fc, qr = fr * F::NH + jh;
            qa[ks][jh][h8] = bf16_pair(qt[j * NQP + qr], qt[(j + 1) * NQP + qr]);
          }
  }

  // scores, step by step: 4 key columns and every JS-th channel row a thread
  const float scale = rsqrtf((float)DH);
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<NS - 2>();  // chunk k has landed
    __syncthreads();  // and every thread is done with step k - 1's stage
    issue(k + NS - 1);
    const unsigned char* ks = smem + k % NS * Lay::STAGE;
    if constexpr (MMA) {
      // a warp an 8-key tile at a time: 4 k-steps of 16 channels a head
      for (int c0 = warp * 8; c0 < F::KEYS; c0 += X_WARPS * 8) {
        if (!col_ok(k * F::KEYS + c0)) continue;  // the tile's first key: past it all are masked
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const auto w = F::gather(ks, F::KPITCH, kk * 16, c0 + fr);
#pragma unroll
          for (int jh = 0; jh < F::NH; ++jh) {
            uint32_t b0, b1;
            // biased nibbles: the bias folds out below
            F::frag(w, F::NH == 2 ? jh : plane(kk * 16), 0.f, b0, b1);
            if (jh == 0) mma_bf16(d, qa[kk][0][0], 0u, qa[kk][0][1], 0u, b0, b1);
            else mma_bf16(d, 0u, qa[kk][F::NH - 1][0], 0u, qa[kk][F::NH - 1][1], b0, b1);
          }
        }
        if (fr < NG)
#pragma unroll
          for (int jh = 0; jh < F::NH; ++jh) {
            const int r = fr * F::NH + jh, c = k * F::KEYS + c0 + 2 * fc;
            const float bias = FOLD ? 8.f * qsum_s[r] : 0.f;
            *reinterpret_cast<float2*>(ps + r * pp + c) =
                make_float2(col_ok(c) ? (d[2 * jh] - bias) * scale : NEG_BIG,
                            col_ok(c + 1) ? (d[2 * jh + 1] - bias) * scale : NEG_BIG);
          }
      }

      continue;
    }
    const int js = tid % JS, c0 = tid / JS * 4;
    float acc[NQ][4], qsum[NQ];  // qsum: the rows' sums of q, for FOLD
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      qsum[r] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    if (col_ok(k * F::KEYS + c0)) {
#pragma unroll 4
      for (int i = 0; i < DH / JS; ++i) {
        const int j = i * JS + js;
        float code[F::NH][4];
        F::keys(ks + j * F::KPITCH, c0, plane(j), FOLD ? 0.f : 8.f, code);
        float qf[NQP];
#pragma unroll
        for (int r = 0; r < NQP; r += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qt + j * NQP + r);
          qf[r] = x.x, qf[r + 1] = x.y, qf[r + 2] = x.z, qf[r + 3] = x.w;
        }
#pragma unroll
        for (int r = 0; r < NQ; ++r) {
          if (FOLD) qsum[r] += qf[r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(qf[r], code[r % F::NH][c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o < JS; o <<= 1)
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        if (FOLD) qsum[r] += __shfl_xor_sync(FULL, qsum[r], o);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += __shfl_xor_sync(FULL, acc[r][c], o);
      }
#pragma unroll
    for (int r = 0; r < NQ; ++r)
      if (r % JS == js) {
        float s[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[c] = col_ok(k * F::KEYS + c0 + c) ? (acc[r][c] - 8.f * qsum[r]) * scale : NEG_BIG;
        *reinterpret_cast<float4*>(ps + r * pp + k * F::KEYS + c0) = make_float4(s[0], s[1], s[2], s[3]);
      }
  }

  __syncthreads();  // every score is written
  // the block's maxima to every block of the cluster, then the global max
  {
    float m[NQ];
#pragma unroll
    for (int r = 0; r < NQ; ++r) m[r] = NEG_BIG;
    for (int c = tid; c < cols; c += X_THREADS)
      if (col_ok(c))
#pragma unroll
        for (int r = 0; r < NQ; ++r) m[r] = fmaxf(m[r], ps[r * pp + c]);
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      m[r] = warp_max(m[r]);
      if (lane == 0) red[warp * NQ + r] = m[r];
    }
    __syncthreads();
    for (int i = tid; i < NQ * S; i += X_THREADS) {  // (row, destination rank)
      const int r = i % NQ;
      float b = NEG_BIG;
#pragma unroll
      for (int w = 0; w < X_WARPS; ++w) b = fmaxf(b, red[w * NQ + r]);
      *cluster.map_shared_rank(mx + rank * NQ + r, i / NQ) = b;
    }
  }
  cluster.sync();
  {
    float M[NQ], l[NQ];
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      M[r] = NEG_BIG, l[r] = 0.f;
      for (int k = 0; k < S; ++k) M[r] = fmaxf(M[r], mx[k * NQ + r]);
    }
    for (int c = tid; c < cols; c += X_THREADS) {
      const bool ok = col_ok(c);
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        const float p = ok ? expf(ps[r * pp + c] - M[r]) : 0.f;
        l[r] += p;
        // the value product takes p in the query's dtype, l the unrounded sum
        ps[r * pp + c] = rounded(p, q);
      }
    }
#pragma unroll
    for (int r = 0; r < NQ; ++r) {  // red was read before the cluster barrier
      l[r] = warp_sum(l[r]);
      if (lane == 0) red[warp * NQ + r] = l[r];
    }
    __syncthreads();
    for (int i = tid; i < NQ * S; i += X_THREADS) {
      const int r = i % NQ;
      float b = 0.f;
#pragma unroll
      for (int w = 0; w < X_WARPS; ++w) b += red[w * NQ + r];
      *cluster.map_shared_rank(lr + rank * NQ + r, i / NQ) = b;
    }
  }

  // values, step by step: a warp a run of rows, 4 channels a lane (MMA:
  // an 8-channel tile a warp)
  float vacc[MMA ? F::NH : 1][4] = {};
  float acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<NS - 2>();  // chunk steps + k has landed
    __syncthreads();  // and every thread is done with the stage it was in before
    issue(steps + k + NS - 1);
    const unsigned char* vs = smem + (steps + k) % NS * Lay::STAGE;
    const int sr = min(X_STEP, rows - k * X_STEP);
    const float* pk = ps + k * F::KEYS;
    if constexpr (MMA) {
      // a warp the 8-channel tile `warp` of each head; 16 rows a k-step,
      // for C each row's low and high times (columns r and HALF + r)
      for (int r0k = 0; r0k < sr; r0k += 16) {
#pragma unroll
        for (int jh = 0; jh < F::NH; ++jh) {
          const auto wv = F::gather(vs, F::VPITCH, r0k, jh * DH + warp * 8 + fr);
#pragma unroll
          for (int n = 0; n < (PACKED ? 2 : 1); ++n) {  // C: the low times, then the high
            uint32_t b0, b1, a0 = 0u, a2 = 0u;
            F::frag(wv, n, FOLD ? 0.f : 8.f, b0, b1);
            if (fr < NG) {
              const float* pr = pk + (fr * F::NH + jh) * pp + n * F::HALF + r0k + 2 * fc;
              const float2 x0 = *reinterpret_cast<const float2*>(pr), x8 = *reinterpret_cast<const float2*>(pr + 8);
              a0 = bf16_pair(x0.x, x0.y);
              a2 = bf16_pair(x8.x, x8.y);
            }
            mma_bf16(vacc[jh], a0, 0u, a2, 0u, b0, b1);
          }
        }
      }
    } else if constexpr (PACKED) {
      // lane's bytes: head jh's channels (lane % 16) * 4 ..; one head a
      // block (Int4Head): lanes 0-15 and 16-31 take alternate rows
      constexpr int RW = 2 / F::NH;  // rows a warp takes at once
      const int jh = F::NH == 2 ? lane / 16 : 0, lr0 = F::NH == 2 ? 0 : lane / 16;
      for (int r = warp * RW + lr0; r < sr; r += RW * X_WARPS) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(vs + r * F::VPITCH + (lane % (16 * F::NH)) * 4);
        float lo[4], hi[4];
        nibbles(u, 0, FOLD ? 0.f : 8.f, lo);  // time r0 + r
        nibbles(u, 1, FOLD ? 0.f : 8.f, hi);  // time T/2 + r0 + r
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float plo = pk[(g * F::NH + jh) * pp + r], phi = pk[(g * F::NH + jh) * pp + F::HALF + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g][c] = fmaf(phi, hi[c], fmaf(plo, lo[c], acc[g][c]));
        }
      }
    } else {
      const int cg4 = lane % 16;  // lanes 0-15 and 16-31 take alternate rows
      for (int r = warp * 2 + lane / 16; r < sr; r += 2 * X_WARPS) {
        float x[4];
        four(reinterpret_cast<const Code*>(vs + r * F::VPITCH) + cg4 * 4, x);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float p = pk[g * pp + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g][c] = fmaf(p, x[c], acc[g][c]);
        }
      }
    }
  }
  if constexpr (F::NH == 1 && !MMA) {  // the two half-warps' rows
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] += __shfl_xor_sync(FULL, acc[g][c], 16);
  }
  __syncthreads();  // the last stage is read
  // the ring is free (its last groups are empty): it takes the warps' sums
  // (MMA: the block's, each warp its own channels)
  constexpr int PW = MMA ? 1 : X_WARPS;
  if constexpr (MMA) {
    if (fr < NG)
#pragma unroll
      for (int jh = 0; jh < F::NH; ++jh)
        *reinterpret_cast<float2*>(part + (fr * F::NH + jh) * DH + warp * 8 + 2 * fc) =
            make_float2(vacc[jh][0], vacc[jh][1]);
  } else if (F::NH == 2 || lane < 16) {
    const int jh = F::NH == 2 ? lane / 16 : 0, c = (lane % 16) * 4;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(part + warp * NO + (g * F::NH + jh) * DH + c) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  // the block's sums in warp order, pushed to the owner of each output
  const int CO = (NO + S - 1) / S;
  for (int o = tid; o < NO; o += X_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < PW; ++w) s += part[w * NO + o];
    const int owner = o / CO;
    *cluster.map_shared_rank(recv + rank * CO + o - owner * CO, owner) = s;
  }
  cluster.sync();  // every push has landed; no block touches another's memory after this
  for (int o = rank * CO + tid; o < min(NO, (rank + 1) * CO); o += X_THREADS) {
    const int r = o / DH, g = r / F::NH;
    if (g >= G) continue;
    float s = 0.f, L = 0.f;
    for (int k = 0; k < S; ++k) s += recv[k * CO + o - rank * CO], L += lr[k * NQ + r];
    if (FOLD) s -= 8.f * L;  // the values' bias, folded out with the unrounded sum
    out[(size_t)(e * G + g) * D + head(r % F::NH) * DH + o % DH] = s / L;
  }
}

// Kernel C: F is Int4Pairs, or Int4Head at an odd head count
template <typename T, class F, int NG>
__global__ void __launch_bounds__(X_THREADS, X_BLOCKS_PER_SM(NG))
cross_attn_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kT,
                  const uint8_t* __restrict__ v, float* __restrict__ out, int layer, int valid,
                  int E, int G, int D, int Tn, int H, int units) {
  cross_split<T, F, NG>(q, kT, v, out, layer, valid, E, G, D, Tn, H, units);
}

template <typename T, typename C, int NG>
__global__ void __launch_bounds__(X_THREADS, X_BLOCKS_PER_SM(NG))
cross_unpacked_kernel(const T* __restrict__ q, const C* __restrict__ kT, const C* __restrict__ v,
                      float* __restrict__ out, int layer, int valid, int E, int G, int D, int Tn,
                      int H, int units) {
  cross_split<T, Plain<C>, NG>(q, kT, v, out, layer, valid, E, G, D, Tn, H, units);
}

// Launch one cluster of S blocks per (entry, head unit): S so the grid
// holds about X_FILL_PERCENT of the blocks the card holds at once (short
// of all of them, so clusters pack into the GPCs), and more where a
// block's scores would not fit X_SCORE_BYTES.
template <class F, int NG, typename T, typename C>
int launch_cross(void (*kernel)(const T*, const C*, const C*, float*, int, int, int, int, int, int,
                                int, int),
                 const void* q, const void* kT, const void* v, float* out, int layer, int valid,
                 int B, int G, int D, int Tn, int H, cudaStream_t st) {
  using Lay = XLayout<F, NG>;
  const int E = B / G, hunits = H / F::NH;
  const int rows = F::PACKED ? min(Tn / 2, valid) : valid;
  const int units = (rows + X_UNIT - 1) / X_UNIT;
  constexpr int UPS = X_STEP / X_UNIT;
  constexpr int max_steps = X_SCORE_BYTES / (Lay::NQ * F::KEYS * 4);
  const int min_S = (units + max_steps * UPS - 1) / (max_steps * UPS);
  // once per instance: the attributes, and the blocks the card holds at
  // once (multiprocessors times the occupancy at two steps' scores)
  static int capacity = 0;
  static const cudaError_t attr_err = [&] {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Lay::bytes(max_steps));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, X_THREADS, Lay::bytes(2));
    capacity = sms * max(per_sm, 1);
    return err;
  }();
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  int S = (capacity * X_FILL_PERCENT / 100 + hunits * E / 2) / (hunits * E);
  S = max(min(min(S, X_MAX_CLUSTER), units), max(min_S, 1));
  if (S > X_MAX_CLUSTER) return static_cast<int>(cudaErrorInvalidValue);
  const int steps = ((units + S - 1) / S + UPS - 1) / UPS;  // the largest block's
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, hunits, E);
  cfg.blockDim = dim3(X_THREADS);
  cfg.dynamicSmemBytes = Lay::bytes(steps);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const C*>(kT),
                                             static_cast<const C*>(v), out, layer, valid, E, G, D, Tn, H, units);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// streams a block serves, as instantiated: 1, up to 5 (beam search's
// width), up to 8
template <template <int> class Launch, typename... Args>
int by_streams(int G, Args... args) {
  if (G == 1) return Launch<1>::run(args...);
  if (G <= 5) return Launch<5>::run(args...);
  if (G <= 8) return Launch<8>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
struct LaunchC {
  template <int NG>
  struct At {
    static int run(const void* q, const void* kT, const void* v, float* out, int layer, int valid,
                   int B, int G, int D, int Tn, int H, cudaStream_t st) {
      if (H % 2)  // heads h and h + H/2 share no key byte: one head a cluster
        return launch_cross<Int4Head, NG>(cross_attn_kernel<T, Int4Head, NG>, q, kT, v, out, layer, valid, B, G,
                                          D, Tn, H, st);
      return launch_cross<Int4Pairs, NG>(cross_attn_kernel<T, Int4Pairs, NG>, q, kT, v, out, layer, valid, B, G,
                                         D, Tn, H, st);
    }
  };
};

template <typename T, typename C>
struct LaunchCU {
  template <int NG>
  struct At {
    static int run(const void* q, const void* kT, const void* v, float* out, int layer, int valid,
                   int B, int G, int D, int Tn, int H, cudaStream_t st) {
      return launch_cross<Plain<C>, NG>(cross_unpacked_kernel<T, C, NG>, q, kT, v, out, layer, valid, B,
                                        G, D, Tn, H, st);
    }
  };
};
}  // namespace

// q, k_new, v_new: [B, D] f32 or bf16 (bf16 flag); kc, vc: int8 [L, B, ctx, D];
// kvs: f32 [L, B, ctx, 2]; kq, vq: int8 [B, D]; new_scale: f32 [B, 2];
// out: f32 [B, D]; pos: one int32 in device memory, 0 <= *pos < ctx.
// Head width 64, caches 16-byte aligned.
extern "C" int decode_self_attention(const void* q, int bf16, void* kc, void* vc, void* kvs,
                                     const void* k_new, const void* v_new, const void* kq,
                                     const void* vq, const void* new_scale, void* out,
                                     int layer, const int* pos, int B, int ctx, int D, int H,
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
// (bf16 flag); out: f32 [B, D], normalized; nothing is stored; pos: one
// int32 in device memory, 0 <= *pos < ctx. Head width 64, caches 16-byte
// aligned.
extern "C" int decode_attention_merged(const void* q, int bf16, const void* kc, const void* vc,
                                       const void* k_new, const void* v_new, void* out, int layer,
                                       const int* pos, int B, int ctx, int D, int H, void* stream) {
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
// [B, H]; valid: one int32 in device memory, 0 <= *valid <= ctx. Head
// width 64, caches 16-byte aligned.
extern "C" int decode_attention_layer(const void* q, int bf16, const void* kc, const void* vc,
                                      const void* kvs, void* acc, void* m, void* l, int layer,
                                      const int* valid, int B, int ctx, int D, int H, void* stream) {
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
// acc: f32 [B, D]; m, l: f32 [B, H]; valid as decode_attention_layer.
// Head width 64, caches 16-byte aligned.
extern "C" int decode_attention_layer_unscaled(const void* q, int bf16, const void* kc,
                                               const void* vc, void* acc, void* m, void* l,
                                               int layer, const int* valid, int B, int ctx, int D,
                                               int H, void* stream) {
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
// [B, D], normalized; nothing is stored. Head width 64; head pairs where
// H is even and a scale group is a whole number of heads, else one head a
// block with groups of a multiple of 16 channels; caches 16-byte aligned;
// pos: one int32 in device memory, 0 <= *pos < ctx.
extern "C" int decode_attention_merged_int4(const void* q, int bf16, const void* kc,
                                            const void* vc, const void* kvs, const void* k_new,
                                            const void* v_new, void* out, int layer, const int* pos,
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
// V scales); valid: one int32 in device memory, 0 <= *valid <= ctx.
extern "C" int decode_attention_layer_int4(const void* q, int bf16, const void* kc, const void* vc,
                                           const void* kvs, void* acc, void* m, void* l,
                                           int layer, const int* valid, int B, int ctx, int D, int H,
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
// q: [B, D] f32 or bf16, B query streams, G <= 8 of them per cache entry
// (B % G == 0); kT: uint8 [L, B/G, D/2, T]; v: uint8 [L, B/G, T/2, D]; out:
// f32 [B, D], normalized. Head width 64 (head pairs where H is even, else
// one head a cluster), T a multiple of 32,
// caches 16-byte aligned, 0 < valid <= T, min(T/2, valid) <= 2048.
extern "C" int decode_cross_attention(const void* q, int bf16, const void* kT, const void* v,
                                      void* out, int layer, int valid, int B, int G, int D, int T,
                                      int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bf16)
    return by_streams<LaunchC<__nv_bfloat16>::template At>(G, q, kT, v, o, layer, valid, B, G, D, T, H, st);
  return by_streams<LaunchC<float>::template At>(G, q, kT, v, o, layer, valid, B, G, D, T, H, st);
}

// q: [B, D] f32 or bf16 (bf16 flag), B query streams, G <= 8 of them per
// cache entry (B % G == 0); kT: [L, B/G, D, T]; v: [L, B/G, T, D], int8
// (cache_int8) or of q's type; out: f32 [B, D], normalized. Head width 64,
// T * element size a multiple of 16, caches 16-byte aligned,
// 0 < valid <= min(T, 2048).
extern "C" int decode_cross_attention_unpacked(const void* q, int bf16, int cache_int8,
                                               const void* kT, const void* v, void* out,
                                               int layer, int valid, int B, int G, int D, int T,
                                               int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  using BF = __nv_bfloat16;
  if (bf16 && cache_int8)
    return by_streams<LaunchCU<BF, int8_t>::template At>(G, q, kT, v, o, layer, valid, B, G, D, T, H, st);
  if (bf16) return by_streams<LaunchCU<BF, BF>::template At>(G, q, kT, v, o, layer, valid, B, G, D, T, H, st);
  if (cache_int8)
    return by_streams<LaunchCU<float, int8_t>::template At>(G, q, kT, v, o, layer, valid, B, G, D, T, H, st);
  return by_streams<LaunchCU<float, float>::template At>(G, q, kT, v, o, layer, valid, B, G, D, T, H, st);
}
