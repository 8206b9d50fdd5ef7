// Kernels D and D': non-causal whole-sequence attention for the encoder.
//
// Replaces, in whisper_burn_tpu/ops/pallas_encoder_attention.py:
// - _packed_kernel (K6, reached through flash_prefill.prefill_attention):
//   kernel D, encoder_attention, on the packed [B, T, D] layout with
//   64-wide heads as slices of D;
// - _kernel (K10, reached only through that module's encoder_attention
//   op: no model path calls it): kernel D', encoder_attention_heads, on
//   the TPU kernel's layout, q and k head-major [B, H, Tp, 64], v and the
//   output transposed [B, H, 64, Tp].
// Keys at `valid` and above are masked (the encoder pads T to a multiple
// of 128 once for its whole layer stack); query rows at `valid` and above
// are computed like the others (finite) and discarded by the caller.
//
// Bound on the H100: operations, 4 * T * valid * 64 per head and stream
// (about 97 GFLOP per Large-V3 layer at B=8), since q/k/v are read once.
// The TPU kernels hold a whole [T, T] score block in VMEM; these never
// materialize scores.
//
// Two instances of each layout:
// - bf16 (the model's serving and fast() modes): a flash loop on Hopper's
//   warpgroup mma, encoder_attn_wgmma. One block of two warpgroups per
//   (128-query tile, head, stream); each warpgroup owns 64 query rows, each
//   warp 16 of them. S = Q K^T and O += P V are wgmma.m64n64k16 bf16 -> f32
//   with the A operand in registers: Q's fragments come through a padded
//   shared-memory tile and ldmatrix, P straight from the score
//   accumulator's layout (the two layouts match), rounded to bf16 as K6 and
//   K10 round p to the value dtype. 64-key tiles of K and V stream through
//   a two-stage ring in shared memory, filled with 16-byte cp.async into
//   the 128-byte swizzle the wgmma descriptors name, and handed to the
//   async proxy with fence.proxy.async before each tile's barrier. Keys
//   and values at `valid` and above, and rows past T, are zero-filled by
//   the copy itself (a copy of fewer source bytes), so a pad row never
//   reaches a real row through 0 * v; tiles wholly past `valid` are never
//   loaded. The value operand is the one place the layouts differ: D's V
//   tile [keys, 64] is B in N-major order (the transposed-B flag), D''s
//   V^T tile [64, keys] is B in K-major order, like K (the HEADS
//   parameter). Masked keys are set to -inf by select; the row max of the
//   unscaled scores lives across the four lanes of a quad (shuffles); the
//   output accumulator is rescaled once per key tile; 1/sqrt(64) * log2(e)
//   is folded into one FFMA before ex2; the row sum is kept per lane and
//   summed over the quad once at the end. The epilogue divides by the row
//   sum once, stages the tile in shared memory and writes 16-byte stores:
//   rows of 64 channels at h * 64 (D), or rows of the transposed output
//   with consecutive queries on consecutive threads (D').
//   wgmma reads its register operands asynchronously: the accumulators and
//   the A fragments are fenced against the compiler around each product,
//   and Q's fragments are loaded again each tile (kept in registers across
//   tiles, the products of every tile after the first came out wrong).
//   Numerics: p is rounded against the running max and rescaled in f32
//   when the max grows, where K6 rounds exp(s - m) against the row's
//   final max; the difference is inside the bf16 tolerance (1e-2 of
//   max|out| against the plain version, which rounds as K6 does).
//   PERF.md has this loop's times beside the mma.sync form it replaced.
// - f32 (Compute.parity() and the f32 card checks, held to 1e-5 of
//   max|out|: TF32 or bf16 tensor cores would break that): the CUDA-core
//   loop, encoder_attn. One block per (128-query tile, head, stream), one
//   thread per query row holding q and the running output in registers;
//   64-key tiles of K and V staged in shared memory and read as
//   broadcasts, 16 keys per softmax rescale. D''s transposed values are
//   staged with consecutive threads on consecutive keys into rows padded
//   by 4 floats.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int DH = 64;
constexpr int BK = 64;  // keys per shared-memory tile

// --------------------------------------------------------------------------
// f32: the CUDA-core loop

constexpr int BQ = 128;  // queries per block, one per thread
constexpr int SUB = 16;  // keys per online-softmax update

// HEADS = false: q, k, v, out packed [B, T, D], head h at channels
// h * 64 ..; HEADS = true: q, k [B, H, T, 64], v and out [B, H, 64, T]
template <bool HEADS>
__device__ void encoder_attn(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out, int Tn, int D,
                             int valid) {
  constexpr int VPAD = HEADS ? 4 : 0;  // value rows padded against bank conflicts
  __shared__ __align__(16) float ks[BK][DH];
  __shared__ __align__(16) float vs[BK][DH + VPAD];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * BQ + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const float scale = rsqrtf((float)DH);
  const bool q_ok = qi < Tn;
  // element (t, c) of head h: q and k rows, v (and out) by layout
  const size_t head = (size_t)b * H + h;
  auto qk_at = [&](int t, int c) -> size_t {
    return HEADS ? (head * Tn + t) * DH + c : ((size_t)b * Tn + t) * D + h * DH + c;
  };
  auto v_at = [&](int t, int c) -> size_t {
    return HEADS ? (head * DH + c) * Tn + t : ((size_t)b * Tn + t) * D + h * DH + c;
  };

  float qv[DH], acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) {
    qv[c] = q_ok ? q[qk_at(qi, c)] : 0.f;
    acc[c] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  for (int t0 = 0; t0 < valid; t0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * DH; e += BQ) {
      int r = e / DH, c = e % DH;
      ks[r][c] = t0 + r < valid ? k[qk_at(t0 + r, c)] : 0.f;
      if (HEADS) r = e % BK, c = e / BK;  // transposed values: consecutive keys
      vs[r][c] = t0 + r < valid ? v[v_at(t0 + r, c)] : 0.f;
    }
    __syncthreads();
    const int nk = min(BK, valid - t0);
    for (int j0 = 0; j0 < nk; j0 += SUB) {
      float sc[SUB];
      float mt = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks[j0 + jj]);
        float d = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < DH / 4; ++c4) {
          const float4 kk = kr[c4];
          d += qv[4 * c4] * kk.x + qv[4 * c4 + 1] * kk.y + qv[4 * c4 + 2] * kk.z +
               qv[4 * c4 + 3] * kk.w;
        }
        sc[jj] = j0 + jj < nk ? d * scale : -INFINITY;
        mt = fmaxf(mt, sc[jj]);
      }
      const float alpha = expf(m - mt);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < DH; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(sc[jj] - mt);  // 0 for the masked tail
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[j0 + jj]);
#pragma unroll
        for (int c4 = 0; c4 < DH / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4] += p * vv.x;
          acc[4 * c4 + 1] += p * vv.y;
          acc[4 * c4 + 2] += p * vv.z;
          acc[4 * c4 + 3] += p * vv.w;
        }
      }
      m = mt;
    }
  }
  if (q_ok) {
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < DH; ++c) out[v_at(qi, c)] = acc[c] * inv;
  }
}

// --------------------------------------------------------------------------
// bf16: the warpgroup-mma loop

constexpr int GQ = 128;                 // queries per block
constexpr int GTHREADS = 256;           // two warpgroups
constexpr int STAGES = 2;               // K/V tiles in flight
constexpr int LDS = DH + 8;             // row stride (bf16) of the padded q tile: 144 B
constexpr int LDO = GQ + 8;             // row stride (bf16) of D''s transposed output tile: 272 B
constexpr int GTILE = BK * DH;          // one swizzled K or V tile (bf16), 8 KB
constexpr int GQBYTES = GQ * LDS * 2;   // the padded q tile (ldmatrix), 18 KB
constexpr int GSMEM_BYTES = GQBYTES + 1024 + STAGES * 2 * GTILE * 2;  // + alignment slack
static_assert(GQBYTES % 1024 == 0, "the ring follows the q tile on a 1024-byte boundary");
static_assert(DH * LDO <= GQ * LDS, "D''s output tile is staged in the q tile's place");
static_assert(BK == DH, "K and V^T tiles share one shape");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past src_bytes (0 to 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// element (r, c) of a [64][64] bf16 tile in the 128-byte swizzle: 16-byte
// chunk c / 8 of row r at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) { return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7); }

// shared-memory matrix descriptor: 128-byte swizzle, 1024 B between 8-row
// groups; the tiles start on 1024-byte boundaries, and a 16-element step
// along a K-major row moves the start by 32 B
__device__ __forceinline__ uint64_t gdesc(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of d across the asynchronous mma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[64 x 64] += a[64 x 16] (registers, the mma.sync A layout per warp) * B[16 x 64]
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TRANS_B), "r"(1));
}

// Layouts as encoder_attn's. Dynamic shared memory: the padded q tile
// [GQ][LDS] (later the output tile), then on a 1024-byte boundary STAGES
// pairs of swizzled K and V tiles.
template <bool HEADS>
__device__ void encoder_attn_wgmma(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   __nv_bfloat16* __restrict__ out, int Tn, int D, int valid) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* qs = smem;
  const uint32_t ring_at = (smem_addr(smem) + GQBYTES + 1023) & ~1023u;
  __nv_bfloat16* ring = smem + (ring_at - smem_addr(smem)) / 2;  // stage s: K at 2s GTILE, V after it
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * GQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const size_t head = (size_t)b * H + h;
  // row t of q or k (64 channels); row t of D's V
  auto qk_row = [&](const __nv_bfloat16* x, int t) {
    return HEADS ? x + (head * Tn + t) * DH : x + ((size_t)b * Tn + t) * D + h * DH;
  };

  // q tile: 128 rows x 8 chunks of 16 B; rows past T zero-filled
  for (int e = tid; e < GQ * 8; e += GTHREADS) {
    const int r = e >> 3, c = (e & 7) * 8;
    const bool ok = q0 + r < Tn;
    cp_async16(qs + r * LDS + c, qk_row(q, ok ? q0 + r : 0) + c, ok ? 16 : 0);
  }
  // a K/V tile of keys [t0, t0 + 64): keys at valid and above zero-filled
  auto load_tile = [&](int t0, int st) {
    __nv_bfloat16* ks = ring + 2 * st * GTILE;
    __nv_bfloat16* vs = ks + GTILE;
    for (int e = tid; e < BK * 8; e += GTHREADS) {
      const int r = e >> 3, c = (e & 7) * 8;
      const bool ok = t0 + r < valid;
      cp_async16(ks + swz(r, c), qk_row(k, ok ? t0 + r : 0) + c, ok ? 16 : 0);
      if (HEADS) {  // V^T row r is channel r; its 8 keys t0 + c .. by 2-byte count
        const int n = min(max(valid - (t0 + c), 0), 8);
        cp_async16(vs + swz(r, c), v + (head * DH + r) * Tn + (n ? t0 + c : 0), 2 * n);
      } else {
        cp_async16(vs + swz(r, c), qk_row(v, ok ? t0 + r : 0) + c, ok ? 16 : 0);
      }
    }
  };
  const int n_tiles = (valid + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();

  const float sl2 = 0.125f * 1.4426950408889634f;  // 1/sqrt(64) * log2(e)
  uint32_t qf[DH / 16][4];                          // this warp's 16 rows, A fragments
  float o[32];                                      // output accumulator, 8 channel tiles of n8
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows lane/4 and lane/4 + 8

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * BK;
    if (it + 1 < n_tiles) {
      load_tile(t0 + BK, (it + 1) % STAGES);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();  // this thread's copies, to the async proxy
    __syncthreads();
    {  // q's A fragments, again each tile (source note)
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc)
        ldmatrix_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * LDS + kc * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks = ring + 2 * (it % STAGES) * GTILE;
    const __nv_bfloat16* vs = ks + GTILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    // S = Q K^T: 64 rows x 64 keys a warpgroup, 16 channels a step
    fence_regs(s);
    fence_regs(qf);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) wgmma_rs<0>(s, qf[kc], gdesc(ks + kc * 16));
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(qf);

    // mask keys at valid and above; s[4j + e] is row lane/4 (+ 8 for e >= 2),
    // key t0 + 8j + 2 (lane % 4) + e % 2
    if (t0 + BK > valid) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = t0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        if (key >= valid) s[i] = -INFINITY;
      }
    }
    // online softmax on the unscaled scores (the scale is positive): the
    // row max over the quad, one rescale per tile
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // the first tile always holds key 0 < valid, so mx0 and mx1 are finite
    const float a0 = ex2((m0 - mx0) * sl2), a1 = ex2((m1 - mx1) * sl2);
    m0 = mx0, m1 = mx1;
    const float ms0 = -mx0 * sl2, ms1 = -mx1 * sl2;  // p = 2^(s sl2 - m sl2), one FFMA
    l0 *= a0, l1 *= a1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= a0, o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1, o[4 * j + 3] *= a1;
    }
    // P (f32 into the sums, bf16 into the product), as A fragments of 16
    // keys: the score accumulator's layout is the A operand's
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(s[4 * j], sl2, ms0)), p1 = ex2(fmaf(s[4 * j + 1], sl2, ms0));
      const float p2 = ex2(fmaf(s[4 * j + 2], sl2, ms1)), p3 = ex2(fmaf(s[4 * j + 3], sl2, ms1));
      l0 += p0 + p1, l1 += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V: 64 rows x 64 channels a warpgroup, 16 keys a step
    fence_regs(o);
    fence_regs(pf);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      if (HEADS)  // V^T [channel][key]: K-major, 16 keys a step along the row
        wgmma_rs<0>(o, pf[kc], gdesc(vs + kc * 16));
      else  // V [key][channel]: N-major, 16 key rows a step
        wgmma_rs<1>(o, pf[kc], gdesc(vs + kc * 16 * DH));
    }
    wg_commit();
    wg_wait0();
    fence_regs(o);
    fence_regs(pf);
    __syncthreads();  // the stage is refilled by the next iteration
  }

  // epilogue: the row sums over the quad, one division, staged in shared
  // memory (the q tile's place), 16-byte stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  __nv_bfloat16* os = qs;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + cq;
    if (HEADS) {  // [channel][query]
      os[c * LDO + r0] = __float2bfloat16(o[4 * j] * i0);
      os[(c + 1) * LDO + r0] = __float2bfloat16(o[4 * j + 1] * i0);
      os[c * LDO + r0 + 8] = __float2bfloat16(o[4 * j + 2] * i1);
      os[(c + 1) * LDO + r0 + 8] = __float2bfloat16(o[4 * j + 3] * i1);
    } else {  // [query][channel]
      *reinterpret_cast<uint32_t*>(os + r0 * LDS + c) = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
      *reinterpret_cast<uint32_t*>(os + (r0 + 8) * LDS + c) = pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
  __syncthreads();
  if (HEADS) {  // 64 channel rows x 16 chunks of 8 queries; Tn % 8 == 0
    for (int e = tid; e < DH * (GQ / 8); e += GTHREADS) {
      const int c = e / (GQ / 8), r = (e % (GQ / 8)) * 8;
      if (q0 + r < Tn)
        *reinterpret_cast<uint4*>(out + (head * DH + c) * Tn + q0 + r) =
            *reinterpret_cast<const uint4*>(os + c * LDO + r);
    }
  } else {  // 128 query rows x 8 chunks of 8 channels
    for (int e = tid; e < GQ * 8; e += GTHREADS) {
      const int r = e >> 3, c = (e & 7) * 8;
      if (q0 + r < Tn)
        *reinterpret_cast<uint4*>(out + ((size_t)b * Tn + q0 + r) * D + h * DH + c) =
            *reinterpret_cast<const uint4*>(os + r * LDS + c);
    }
  }
}

// --------------------------------------------------------------------------
// the kernels: the warpgroup-mma loop for bf16, the CUDA-core loop for f32

template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

template <typename T>
__global__ void __launch_bounds__(kMma<T> ? GTHREADS : BQ)
encoder_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, int Tn, int D, int valid) {
  if constexpr (kMma<T>)
    encoder_attn_wgmma<false>(q, k, v, out, Tn, D, valid);
  else
    encoder_attn<false>(q, k, v, out, Tn, D, valid);
}

template <typename T>
__global__ void __launch_bounds__(kMma<T> ? GTHREADS : BQ)
encoder_heads_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int Tn, int D, int valid) {
  if constexpr (kMma<T>)
    encoder_attn_wgmma<true>(q, k, v, out, Tn, D, valid);
  else
    encoder_attn<true>(q, k, v, out, Tn, D, valid);
}

template <bool HEADS, typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out, int B, int Tn, int D,
                 int H, int valid, cudaStream_t st) {
  auto kernel = HEADS ? encoder_heads_kernel<T> : encoder_attn_kernel<T>;
  const int rows = kMma<T> ? GQ : BQ;
  const int threads = kMma<T> ? GTHREADS : BQ;
  const int smem = kMma<T> ? GSMEM_BYTES : 0;
  if (kMma<T>) {
    static bool sized = false;  // above 48 KB only after this, once a kernel
    if (!sized) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM_BYTES);
      if (err != cudaSuccess) return static_cast<int>(err);
      sized = true;
    }
  }
  dim3 grid((Tn + rows - 1) / rows, H, B);
  kernel<<<grid, threads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(out), Tn, D, valid);
  return static_cast<int>(cudaGetLastError());
}

template <bool HEADS>
int launch(const void* q, const void* k, const void* v, void* out, int bf16, int B, int T, int D,
           int H, int valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<HEADS, __nv_bfloat16>(q, k, v, out, B, T, D, H, valid, st);
  return launch_typed<HEADS, float>(q, k, v, out, B, T, D, H, valid, st);
}

}  // namespace

// q, k, v, out: [B, T, D] f32 or bf16 (bf16 flag), contiguous; head width
// 64; keys t >= valid masked (1 <= valid <= T).
extern "C" int encoder_attention(const void* q, const void* k, const void* v, void* out,
                                 int bf16, int B, int T, int D, int H, int valid,
                                 void* stream) {
  return launch<false>(q, k, v, out, bf16, B, T, D, H, valid, stream);
}

// q, k: [B, H, T, 64]; v, out: [B, H, 64, T]; f32 or bf16 (bf16 flag),
// contiguous; D = H * 64; T a multiple of 8; keys t >= valid masked
// (1 <= valid <= T).
extern "C" int encoder_attention_heads(const void* q, const void* k, const void* v, void* out,
                                       int bf16, int B, int T, int D, int H, int valid,
                                       void* stream) {
  return launch<true>(q, k, v, out, bf16, B, T, D, H, valid, stream);
}
