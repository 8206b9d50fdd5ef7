// Kernel I: the fused FFN out[M, D] = fc2(GELU(fc1(x))) of Q4 weights, one launch:
//
//   out = b2 + sum_f gelu(x . W1[:, f] + b1[f]) . W2[f, :]
//
// with W = code x scale (Q4 codes int8 [K, N], f32 scales [K/32, N]).
//
// Replaces the TPU kernels of whisper_burn_tpu/ops/pallas_ffn.py: _kernel
// (K7, the FFN of the prefill and the encoder: fc2's bias in the f32 sum,
// one rounding) and _kernel_stacked (K4, the decode step's layer-indexed
// FFN: the sum rounded, then the bias added in the compute dtype, as
// models/decoder.py does after it). bias_after_round picks K4's order; the
// wrapper offsets the weight pointers to one layer, so nothing is copied.
//
// Rounding, as the Pallas kernels round: for bf16 x every weight is
// bf16(code x bf16(scale)) (a code times a bf16 scale is exact in f32, so
// rounding the product once is bf16's multiply); h is summed in f32, g =
// gelu(h) is rounded to bf16, the fc2 sum is f32. f32 x is f32 throughout.
// GELU is the tanh form or, for "erf", K4's Abramowitz & Stegun 7.1.26 erf
// (about 3e-6 from the exact erf), so that the kernel and its plain version
// agree with K4 and K7 to the last f32 step.
//
// Bound. At the decode shapes (M = 1-40 rows, Large-V3 1280 <-> 5120) the
// work is reading the weights once: 2 (D F + D F / 32 x 4) = 14.75 MB, 4.4
// us at 3.35 TB/s whatever M. The encoder's 1536 rows (B = 1) are bound by
// operations: 4 M D F = 40.3 GFLOP, 40.7 us at 989 TFLOP/s.
//
// fc2 sums over all of F, so no block can finish alone. Both regimes meet
// that the same way: every block writes its part of g = gelu(fc1(x)) to a
// scratch [M, F] in x's dtype (80 KB at 8 rows, 15.7 MB at 1536: it stays
// in the 50 MB L2, so g now passes through device memory, where K4 and K7
// keep it on the chip), all blocks meet once at a grid-wide barrier, and
// then each block computes fc2 for output columns that it owns whole,
// summing all of F in a fixed order. The launch is cooperative, so every
// block is resident at once; the barrier is a 64-bit count that only grows
// (grid_sync), ready for the next launch or graph replay with no reset. No
// float atomics: two launches give the same bits.
//
// Decode regime (bf16 below 64 rows; f32 at any rows): one block to an SM,
// each holding its whole share of the weights in shared memory, copied in
// from its first instruction by 1D bulk copies (cp.async.bulk, completing
// on mbarriers) out of a second copy of the weights in 16-column units
// (ops/ffn_kernel.unit_layout; KB_BYTES below), each unit one contiguous
// run. The plan (dec_plan) gives each of the first D / 16 blocks one fc2
// unit (16 output columns over all of F) and e fc1 units (16 columns of F
// over all of D), each later block C fc1 units, weighing what a block must
// read before the barrier (Large-V3 at up to 32 rows: 80 blocks of 3 + 1
// units and 27 of 3).
// - Copies: K part p of every W1 unit of the block on barrier p (nparts
//   parts), then W2's unit and the biases on one more barrier.
// - fc1: a job is (residue, unit group): the K blocks (32 rows) of D are
//   dealt round-robin to the residues, so all warps share the part that
//   lands last, and a warp runs mma.sync (m16n8k16, bf16 in, f32 out) for
//   up to five units on one load of x's A fragments (16 bytes a row),
//   waiting for each K block's part just before using it. Within a K block
//   lane (g, t) holds x's columns 8t..8t+7 and the codes of the same rows
//   at columns 2g, 2g + 1 (one 16-byte load); 16-row step h takes rows 8t
//   + 4h .. 8t + 4h + 3 as the mma's k = 2t, 2t+1, 2t+8, 2t+9. A byte
//   permute and one logic op turn two codes into bf16 200 + c, and one
//   bf16x2 subtract and multiply into bf16(c x s). The residues' sums meet
//   in shared memory in order; + b1, GELU and the rounding give g.
// - fc2: after the barrier each fc2 block runs the same mma over its W2
//   unit, its warps dealt F's K blocks round-robin, with g's fragments
//   read through L2 (ld.global.cg); the warps' sums added in warp order,
//   then the bias. 16 warps up to 32 rows of bf16 (8 above, and for f32),
//   to keep more loads and more independent work in flight.
// f32 takes the same plan with one FMA a weight on CUDA cores, row tiles of
// 64 rows walked in turn, weights still read once.
//
// Encoder regime (bf16, 64 rows and up: the entry's and a B = 1 window's
// 1536): two products on the tensor cores, one persistent block to an SM
// walking 128 x 128 output tiles: fc1 (x . W1, epilogue + b1, GELU, g to
// the scratch), the grid barrier, fc2 (g . W2, epilogue the bias). For
// each 64-deep K chunk TMA (cp.async.bulk.tensor, 2D tensor maps encoded
// through the runtime's driver entry point) brings the A tile [128][64] in
// the 128-byte swizzle, the codes [64][128] and their scales into one of
// six stages (one mbarrier each); the block's 256 threads dequantize the
// codes once into two bf16 panels [64 k][64 n] in the swizzle a wgmma
// descriptor names, and two warpgroups (64 rows each) run wgmma.m64n128k16
// on them, the A operand and the B panels both read from shared memory,
// with the sums in registers across the tile's chunks. Chunk q + 1 is
// dequantized while chunk q's wgmma runs; a stage is refilled as soon as
// its chunk's products are done, six chunks ahead.
//
// What bounds it on the card (scripts/torch_ffn_phases.py, PERF.md): at
// the decode shapes the weights land when a plain copy of 14.75 MB would
// (about 6.5 us after the start), then fc1's last part, the barrier and
// fc2, whose blocks each read all of g from L2; at 1536 rows the stream
// of A and B tiles from L2 (each tile's x or g rows are read again for
// every column tile), with the dequant on its path. The scratch and the
// barrier word are the wrapper's, made once per (device, shape); launches
// of one shape must not run concurrently on two streams.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // the encoder regime: two warpgroups
// the decode regime's warps: 16 for bf16 up to 32 rows (more loads and
// more warps in flight to hide each one's latency), else 8
__host__ __device__ constexpr int dec_warps(bool bf16, int mt) { return bf16 && mt <= 2 ? 16 : 8; }
constexpr size_t SMEM_LIMIT = 232448;
constexpr size_t ONE_PER_SM = 118 * 1024;  // more than half an SM's shared memory: one block to an SM

// decode regime
constexpr int UNIT = 16;      // columns of a unit: of F in fc1, of the output in fc2
constexpr int MAX_PARTS = 8;  // K parts of W1, each on its own barrier

// encoder regime
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 6, NP = BN / 64;  // two panels of 64 columns: one n128 product
constexpr int A_BYTES = BM * BK * 2, BQ_BYTES = BK * BN, BS_BYTES = BK / 32 * BN * 4;
constexpr int SLOT_BYTES = A_BYTES + BQ_BYTES + BS_BYTES;  // 25 KB: every stage on a 1024-byte boundary
constexpr int PANEL = BK * 64;                             // bf16 of a dequantized panel [64 k][64 n]
constexpr size_t ENC_SMEM = 1024 + (size_t)STAGES * SLOT_BYTES + 2 * NP * PANEL * 2 + STAGES * 8;

__host__ __device__ inline size_t up(size_t v, size_t a) { return (v + a - 1) / a * a; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = (x + 0.044715f * x * x * x) * 0.7978845608028654f;
  return x * 0.5f * (tanhf(inner) + 1.0f);
}

// Abramowitz & Stegun 7.1.26, as pallas_ffn.py's _erf
__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float z = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * z);
  const float p = ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t + 0.254829592f);
  return s * (1.0f - p * t * expf(-z * z));
}

__device__ __forceinline__ float gelu_erf(float x) { return 0.5f * x * (1.0f + erf_as(x * 0.70710678118654752f)); }
__device__ __forceinline__ float gelu(float x, int erf) { return erf ? gelu_erf(x) : gelu_tanh(x); }

// fc2's bias in K7's order (in the f32 sum, one rounding) or K4's (the sum
// rounded, then the bias added in bf16)
template <bool BF>
__device__ __forceinline__ float finish(float v, float b, int after) {
  if (BF && after) return round_bf16(v) + round_bf16(b);
  return v + b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A Q4 code c (-8 to 7) as the bf16 200 + c is its low nibble xor 0x48
// under the bf16 exponent byte 0x43; subtracting 200 gives c exactly and
// one bf16 multiply bf16(c x s): two codes per instruction of each kind.
__device__ __forceinline__ uint32_t bf16x2_sub_mul(uint32_t v, uint32_t s2) {
  const uint32_t k200 = 0x43484348u;  // bf16 200 twice
  const __nv_bfloat162 c = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), *reinterpret_cast<const __nv_bfloat162*>(&k200));
  const __nv_bfloat162 w = __hmul2(c, *reinterpret_cast<const __nv_bfloat162*>(&s2));
  return *reinterpret_cast<const uint32_t*>(&w);
}

// bytes lo and hi of w (selector 0x4n4m: byte m low, byte n high) as bf16 200 + c
__device__ __forceinline__ uint32_t codes200(uint32_t w, uint32_t sel) {
  return (__byte_perm(w, 0u, sel) & 0x000F000Fu) ^ 0x43484348u;
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// A wait that cannot end (a copy that never lands) traps after some
// seconds, so a fault fails the launch instead of holding the card.
constexpr unsigned SPIN_LIMIT = 1u << 26;

__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned n = 0; !mbar_try(bar, parity); ++n)
    if (n == SPIN_LIMIT) __trap();
}

// a 2D box of `map` at (column c0, row c1) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` contiguous bytes into shared memory, completing on bar (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// between generic-proxy writes (g, the dequantized panels) and async-proxy reads (TMA, wgmma)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// A grid-wide barrier on a 64-bit count that only grows: a launch's
// arrivals are [k grid, (k + 1) grid) for some k. Each block reads the
// count once before it can have reached it (grid_target, at its start) and
// waits, after its own arrival, for the end of its launch's range. Nothing
// is reset: the word is ready for the next launch or graph replay.
__device__ __forceinline__ unsigned long long grid_target(const unsigned long long* bar) {
  unsigned long long now;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(now) : "l"(bar) : "memory");
  return (now / gridDim.x + 1) * gridDim.x;
}

__device__ void grid_sync(unsigned long long* bar, unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(bar) : "memory");
    for (unsigned n = 0;; ++n) {
      unsigned long long now;
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(now) : "l"(bar) : "memory");
      if (now >= target) break;
      if (n == SPIN_LIMIT) __trap();
      __nanosleep(20);
    }
  }
  __syncthreads();
}

// =========================================================================
// Decode regime

// The decode regime reads each weight as a second copy in units of 16
// columns (ops/ffn_kernel.unit_layout): [N/16][K/32][KB_BYTES], each 32-row
// K block its codes (512 bytes: lane 4g + t of a warp finds at 16 lane ..
// its codes of rows 8t..8t+7 at columns 2g and 2g + 1; byte 4q + 2p + c is
// row 8t + 2q + p, column 2g + c), then its 16 f32 scales.
constexpr int KB_BYTES = 512 + 64;

struct DecArgs {
  const void* x;            // [M, D]
  const unsigned char* w1;  // W1 [D, F] in units
  const unsigned char* w2;  // W2 [F, D] in units
  const float* b1;
  const float* b2;
  void* g;    // scratch [M, F], x's dtype
  void* out;  // [M, D]
  unsigned long long* bar;
  int M, D, F, C, e, nparts, gelu_erf, bias_after_round;
};

// A block's work and where its weights sit in its shared memory: its W1
// units at 0 as in device memory, W2's unit, the biases of its fc1 units
// and of its fc2 unit.
struct DecLayout {
  int c1, u0, fc2;  // fc1 units [u0, u0 + c1); fc2 unit, or -1
  size_t w2, bias, end;
};

__host__ __device__ inline DecLayout dec_layout(int b, int D, int F, int C, int e) {
  const int U1 = F / UNIT, U2 = D / UNIT;
  DecLayout l;
  if (b < U2) {
    l.fc2 = b, l.u0 = b * e;
    const int left = U1 - l.u0;
    l.c1 = left < 0 ? 0 : (left < e ? left : e);
  } else {
    l.fc2 = -1, l.u0 = U2 * e + (b - U2) * C;
    l.c1 = U1 - l.u0 < C ? U1 - l.u0 : C;
  }
  l.w2 = up((size_t)l.c1 * (D / 32) * KB_BYTES, 128);
  l.bias = l.w2 + (l.fc2 >= 0 ? (size_t)(F / 32) * KB_BYTES : 0);
  l.end = l.bias + (size_t)UNIT * (l.c1 + 1) * 4;
  return l;
}

// fc1's jobs: the block's c1 units in ng groups of at most ug (the
// accumulators a warp holds: 5 units up to 16 rows, 3 above), and its K
// blocks dealt round-robin to nres residues; a job is (residue, group), so
// the warps share every K part, and a warp reads its A fragments once for
// its group.
struct DecJobs {
  int ng, ug, nres;
};

__host__ __device__ inline DecJobs dec_jobs(int c1, int D, int mt, int warps) {
  DecJobs j;
  const int cap = mt == 1 ? 5 : 3;
  j.ng = c1 > 0 ? (c1 + cap - 1) / cap : 1;
  j.ug = c1 > 0 ? (c1 + j.ng - 1) / j.ng : 0;
  j.nres = warps / j.ng < D / 32 ? warps / j.ng : D / 32;
  return j;
}

// f32 partial sums after the weights: fc1's [nres][R][16 c1], later fc2's [warps][R][16]
__host__ __device__ inline size_t dec_partials(int c1, int D, int mt, int warps) {
  const int R = 16 * mt;
  const size_t a = (size_t)dec_jobs(c1, D, mt, warps).nres * R * UNIT * c1, b = (size_t)warps * R * UNIT;
  return a > b ? a : b;
}

// acc += A[rows, K] . tile_u for the nu (at most UG) units of a group
// (bf16) over the K blocks kb0, kb0 + kstep, ... (nkb of them), then the
// sums to out[r][16 u + c] (row stride ldo). A: bf16 rows of stride lda
// (x, or g read through L2 with CG); rows at `rows` and above are zero
// (HALF: `rows` is at most 8). Unit u's blocks are at wt + u ustride. For
// a K block lane (g, t) holds A's columns 8t..8t+7 of it (one 16-byte load
// a row, used for every unit of the group) and each unit's codes of the
// same rows at columns 2g, 2g + 1 (one 16-byte load): 16-row step h takes
// rows 8t + 4h .. 8t + 4h + 3 as the mma's k = 2t, 2t+1, 2t+8, 2t+9, and
// n8 tile j column 2n + j. The A fragments of NB blocks are loaded before
// any is used, to keep bytes in flight; with bars, each block's W1 part
// (kbp blocks a part) is waited for just before the block is used.
template <int MT, bool HALF, int UG, int NB, bool CG>
__device__ __forceinline__ void group_mma(const __nv_bfloat16* A, int lda, int rows, const unsigned char* wt,
                                          size_t ustride, int nu, int kb0, int kstep, int nkb, float* out, int ldo,
                                          uint64_t* bars, int kbp) {
  constexpr int NQ = HALF ? 1 : 2;  // m8 halves of an m16 tile that hold rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[UG][MT][2][4];
#pragma unroll
  for (int u = 0; u < UG; ++u)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][i][j][e] = 0.f;
  for (int i0 = 0; i0 < nkb; i0 += NB) {
    uint4 av[NB][MT][NQ];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int r = mt * 16 + g + 8 * q, kb = kb0 + (i0 + b) * kstep;
          const uint4* p = reinterpret_cast<const uint4*>(A + (size_t)r * lda + 32 * kb + 8 * t);
          av[b][mt][q] = r < rows && i0 + b < nkb ? (CG ? __ldcg(p) : __ldg(p)) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (i0 + b < nkb) {
        const int kb = kb0 + (i0 + b) * kstep;
        if (bars) mbar_wait(&bars[kb / kbp], 0);
#pragma unroll
        for (int u = 0; u < UG; ++u) {
          if (u < nu) {
            const unsigned char* blk = wt + u * ustride + (size_t)kb * KB_BYTES;
            const uint4 w = *reinterpret_cast<const uint4*>(blk + 16 * lane);
            const float* sr = reinterpret_cast<const float*>(blk + 512) + 2 * g;
            const uint32_t s2[2] = {pack_bf16(sr[0], sr[0]), pack_bf16(sr[1], sr[1])};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t lo = h ? w.z : w.x, hi = h ? w.w : w.y;  // rows 8t+4h, +1 and +2, +3
              uint32_t bf[2][2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {  // byte j (row p = 0) low, byte 2 + j (row p = 1) high
                bf[j][0] = bf16x2_sub_mul(codes200(lo, 0x4240u + 0x0101u * j), s2[j]);
                bf[j][1] = bf16x2_sub_mul(codes200(hi, 0x4240u + 0x0101u * j), s2[j]);
              }
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const uint4 ra = av[b][mt][0], rb = HALF ? make_uint4(0u, 0u, 0u, 0u) : av[b][mt][NQ - 1];
                const uint32_t af[4] = {h ? ra.z : ra.x, h ? rb.z : rb.x, h ? ra.w : ra.y, h ? rb.w : rb.y};
                mma_bf16(acc[u][mt][0], af, bf[0]);
                mma_bf16(acc[u][mt][1], af, bf[1]);
              }
            }
          }
        }
      }
    }
  }
  // element e of tile j: row g + 8 (e >> 1), column 2 (2t + (e & 1)) + j
#pragma unroll
  for (int u = 0; u < UG; ++u)
    if (u < nu)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out[(mt * 16 + g + 8 * (e >> 1)) * ldo + UNIT * u + 4 * t + 2 * (e & 1) + j] = acc[u][mt][j][e];
}

// The same in f32 on CUDA cores, one unit after another: lane l takes
// column l % 16 and every other row from l / 16.
template <int MT, bool CG>
__device__ __forceinline__ void group_f32(const float* A, int lda, int rows, const unsigned char* wt, size_t ustride,
                                          int nu, int kb0, int kstep, int nkb, float* out, int ldo, uint64_t* bars,
                                          int kbp) {
  constexpr int RL = 8 * MT;
  const int lane = threadIdx.x & 31, c = lane & 15, r0 = lane >> 4;
  for (int u = 0; u < nu; ++u) {
    float acc[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i) acc[i] = 0.f;
    for (int i = 0; i < nkb; ++i) {
      const int kb = kb0 + i * kstep;
      if (bars) mbar_wait(&bars[kb / kbp], 0);
      const unsigned char* blk = wt + u * ustride + (size_t)kb * KB_BYTES;
      const float sc = reinterpret_cast<const float*>(blk + 512)[c];
      for (int kk = 0; kk < 32; ++kk) {
        const int code = static_cast<int8_t>(blk[16 * (4 * (c >> 1) + (kk >> 3)) + 4 * ((kk >> 1) & 3) + 2 * (kk & 1) + (c & 1)]);
        const float w = static_cast<float>(code) * sc;
#pragma unroll
        for (int q = 0; q < RL; ++q) {
          const int r = r0 + 2 * q;
          const float* p = A + (size_t)r * lda + 32 * kb + kk;
          const float v = r < rows ? (CG ? __ldcg(p) : __ldg(p)) : 0.f;
          acc[q] = fmaf(v, w, acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RL; ++q) out[(r0 + 2 * q) * ldo + UNIT * u + c] = acc[q];
  }
}

template <typename T, int MT, bool HALF>
__global__ void __launch_bounds__(32 * dec_warps(std::is_same<T, __nv_bfloat16>::value, MT), 1)
    ffn_kernel(const DecArgs a) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int R = 16 * MT;  // rows of a row tile
  constexpr int WARPS = dec_warps(BF, MT), THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int D = a.D, F = a.F, M = a.M, nparts = a.nparts, kbp = D / 32 / nparts;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const DecLayout L = dec_layout(blockIdx.x, D, F, a.C, a.e);
  const int c1 = L.c1, W = UNIT * c1, f0 = UNIT * L.u0, n0 = UNIT * L.fc2;
  const unsigned long long target = grid_target(a.bar);
  float* P = reinterpret_cast<float*>(sm + up(L.end, 16));
  uint64_t* bars = reinterpret_cast<uint64_t*>(P + dec_partials(c1, D, MT, WARPS));
  const float* b1s = reinterpret_cast<const float*>(sm + L.bias);
  const float* b2s = b1s + W;

  if (tid == 0) {
    for (int p = 0; p <= nparts; ++p) mbar_init(&bars[p], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // ---- every copy of the block's weights, issued at once by warp 0: K
  // part p of each W1 unit on barrier p (b1's columns with part 0), W2's
  // unit in one piece a warp and b2's columns on barrier nparts
  if (warp == 0) {
    const size_t part = (size_t)kbp * KB_BYTES, piece = (size_t)(F / 32 / WARPS) * KB_BYTES;
    if (lane == 0) {
      if (c1)
        for (int p = 0; p < nparts; ++p) mbar_expect(&bars[p], c1 * part + (p ? 0 : 4 * W));
      if (L.fc2 >= 0) mbar_expect(&bars[nparts], WARPS * piece + (a.b2 ? 4 * UNIT : 0));
    }
    __syncwarp();
    const int n1 = c1 ? c1 * nparts + 1 : 0, n2 = L.fc2 >= 0 ? WARPS + (a.b2 ? 1 : 0) : 0;
    for (int k = lane; k < n1 + n2; k += 32) {
      if (k < n1 - 1) {  // part p of unit i
        const int p = k / c1, i = k - p * c1;
        bulk_load(sm + ((size_t)i * nparts + p) * part, a.w1 + ((size_t)(L.u0 + i) * nparts + p) * part, part, &bars[p]);
      } else if (k == n1 - 1) {
        bulk_load(sm + L.bias, a.b1 + f0, 4 * W, &bars[0]);
      } else if (k - n1 < WARPS) {
        const size_t off = (size_t)(k - n1) * piece;
        bulk_load(sm + L.w2 + off, a.w2 + (size_t)L.fc2 * WARPS * piece + off, piece, &bars[nparts]);
      } else {
        bulk_load(sm + L.bias + 4 * W, a.b2 + n0, 4 * UNIT, &bars[nparts]);
      }
    }
  }

  const T* x = static_cast<const T*>(a.x);
  T* gs = static_cast<T*>(a.g);
  const int tiles = (M + R - 1) / R, nkb = D / 32;
  const DecJobs J = dec_jobs(c1, D, MT, WARPS);
  // ---- fc1: jobs (residue, unit group), a warp each; each K block once its part has landed
  for (int rt = 0; rt < tiles; ++rt) {
    const int m0 = rt * R, rows = M - m0 < R ? M - m0 : R;
    for (int j = warp; j < (c1 ? J.nres * J.ng : 0); j += WARPS) {
      const int res = j / J.ng, i0 = (j - res * J.ng) * J.ug;
      const int nu = c1 - i0 < J.ug ? c1 - i0 : J.ug, n = (nkb - res + J.nres - 1) / J.nres;
      const unsigned char* wt = sm + (size_t)i0 * nkb * KB_BYTES;
      const size_t ustride = (size_t)nkb * KB_BYTES;
      float* out = P + (size_t)res * R * W + UNIT * i0;
      if constexpr (BF && MT == 1)
        group_mma<MT, HALF, 5, 5, false>(x + (size_t)m0 * D, D, rows, wt, ustride, nu, res, J.nres, n, out, W, bars,
                                         kbp);
      else if constexpr (BF)
        group_mma<MT, false, 3, 2, false>(x + (size_t)m0 * D, D, rows, wt, ustride, nu, res, J.nres, n, out, W,
                                          bars, kbp);
      else
        group_f32<MT, false>(x + (size_t)m0 * D, D, rows, wt, ustride, nu, res, J.nres, n, out, W, bars, kbp);
    }
    __syncthreads();  // every residue's sums are in P
    // h = the residues' sums in order + b1; g = gelu(h) in x's dtype, to the scratch
    for (int idx = tid; idx < rows * W; idx += THREADS) {
      const int r = idx / W, c = idx - r * W;
      float h = 0.f;
      for (int res = 0; res < J.nres; ++res) h += P[((size_t)res * R + r) * W + c];
      store(gs + (size_t)(m0 + r) * F + f0 + c, gelu(h + b1s[c], a.gelu_erf));
    }
    __syncthreads();  // P is read before the next row tile's sums
  }

  grid_sync(a.bar, target);  // all of g is written
  if (L.fc2 < 0) return;

  // ---- fc2: this block's 16 output columns over all of F, its K blocks dealt to the warps round-robin
  mbar_wait(&bars[nparts], 0);
  const int nkb2 = F / 32 / WARPS;
  T* out = static_cast<T*>(a.out);
  for (int rt = 0; rt < tiles; ++rt) {
    const int m0 = rt * R, rows = M - m0 < R ? M - m0 : R;
    float* Q = P + (size_t)warp * R * UNIT;
    if constexpr (BF)
      group_mma<MT, HALF, 1, HALF ? 10 : (MT == 1 ? 5 : 2), true>(
          gs + (size_t)m0 * F, F, rows, sm + L.w2, 0, 1, warp, WARPS, nkb2, Q, UNIT, nullptr, 1);
    else
      group_f32<MT, true>(gs + (size_t)m0 * F, F, rows, sm + L.w2, 0, 1, warp, WARPS, nkb2, Q, UNIT, nullptr, 1);
    __syncthreads();
    for (int idx = tid; idx < rows * UNIT; idx += THREADS) {
      const int r = idx / UNIT, c = idx - r * UNIT;
      float v = 0.f;
      for (int w = 0; w < WARPS; ++w) v += P[((size_t)w * R + r) * UNIT + c];
      store(out + (size_t)(m0 + r) * D + n0 + c, finish<BF>(v, a.b2 ? b2s[c] : 0.f, a.bias_after_round));
    }
    __syncthreads();
  }
}

// =========================================================================
// Encoder regime

struct EncMaps {
  CUtensorMap x, g;    // bf16 [M, D] and [M, F], box {64, 128}, 128-byte swizzle
  CUtensorMap w1, s1;  // codes [D, F] box {128, 64}; scales [D/32, F] box {128, 2}
  CUtensorMap w2, s2;  // codes [F, D] box {128, 64}; scales [F/32, D] box {128, 2}
};

struct EncArgs {
  const float* b1;
  const float* b2;
  __nv_bfloat16* g;  // scratch [M, F]
  __nv_bfloat16* out;
  unsigned long long* bar;
  int M, D, F, gelu_erf, bias_after_round;
};

// A's shared-memory matrix descriptor: K-major, 128-byte swizzle, 1024 B
// between 8-row groups; tiles start on 1024-byte boundaries, and a
// 16-element step along a row moves the start by 32 B
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

// B's descriptor for wgmma.m64n128k16 over both panels [64 k][64 n]: N-major
// (the transposed-B flag), the panels 8 KB apart (the leading byte
// offset), 1024 B between 8-row groups of k
__device__ __forceinline__ uint64_t gdesc_n128(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((PANEL * 2) >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d0 | d1 [64 x 128] += A[64 x 16] (shared, K-major) * B[16 x 128] (shared, N-major)
__device__ __forceinline__ void wgmma_n128(float (&d0)[32], float (&d1)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "l"(a), "l"(b), "r"(1));
}

// A chunk's codes [64][BN] and scales [2][BN] into NP bf16 panels [64 k][64
// n] in the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)):
// each thread takes 8 columns (its scales paired once a scale row) at
// rows r0, r0 + RS, ... (RS = THREADS / (BN / 8)).
__device__ __forceinline__ void dequant(const unsigned char* bq, const float* bs, __nv_bfloat16* dst) {
  constexpr int CPR = BN / 8, RS = THREADS / CPR, ROWS = BK / RS;  // 8-column runs a row; rows a step, a thread
  static_assert(32 % RS == 0, "a thread's row r0 + i RS (r0 < RS) lies in scale row i RS / 32");
  const int c8 = threadIdx.x % CPR, r0 = threadIdx.x / CPR, cc = c8 & 7;
  uint32_t s2[BK / 32][4];
#pragma unroll
  for (int sr = 0; sr < BK / 32; ++sr) {
    const float4 sa = *reinterpret_cast<const float4*>(bs + sr * BN + c8 * 8);
    const float4 sb = *reinterpret_cast<const float4*>(bs + sr * BN + c8 * 8 + 4);
    s2[sr][0] = pack_bf16(sa.x, sa.y), s2[sr][1] = pack_bf16(sa.z, sa.w);
    s2[sr][2] = pack_bf16(sb.x, sb.y), s2[sr][3] = pack_bf16(sb.z, sb.w);
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i * RS, sr = i * RS / 32;
    const uint2 w = *reinterpret_cast<const uint2*>(bq + r * BN + c8 * 8);
    uint4 v;
    v.x = bf16x2_sub_mul(codes200(w.x, 0x4140u), s2[sr][0]);
    v.y = bf16x2_sub_mul(codes200(w.x, 0x4342u), s2[sr][1]);
    v.z = bf16x2_sub_mul(codes200(w.y, 0x4140u), s2[sr][2]);
    v.w = bf16x2_sub_mul(codes200(w.y, 0x4342u), s2[sr][3]);
    *reinterpret_cast<uint4*>(dst + (c8 >> 3) * PANEL + r * 64 + ((cc ^ (r & 7)) << 3)) = v;
  }
}

__global__ void __launch_bounds__(THREADS, 1) ffn_wgmma_kernel(const __grid_constant__ EncMaps maps, const EncArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  __nv_bfloat16* bbf = reinterpret_cast<__nv_bfloat16*>(sm + STAGES * SLOT_BYTES);  // [2 chunks][NP panels][PANEL]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * SLOT_BYTES + 2 * NP * PANEL * 2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int M = a.M, tm = (M + BM - 1) / BM;
  const unsigned long long target = grid_target(a.bar);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  unsigned gq0 = 0;  // chunks this block consumed in earlier phases: chunk gq is in stage gq % STAGES
  for (int phase = 0; phase < 2; ++phase) {
    const CUtensorMap* am = phase ? &maps.g : &maps.x;
    const CUtensorMap* bm = phase ? &maps.w2 : &maps.w1;
    const CUtensorMap* bsm = phase ? &maps.s2 : &maps.s1;
    const int K = phase ? a.F : a.D, N = phase ? a.D : a.F;
    const int nk = (K + BK - 1) / BK, ntiles = tm * ((N + BN - 1) / BN);
    const int mine = ntiles > (int)blockIdx.x ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int Q = mine * nk;  // this block's chunks: its tiles blockIdx.x + i gridDim.x, nk chunks each
    auto issue = [&](int q) {
      const int tile = blockIdx.x + (q / nk) * gridDim.x, kc = q % nk;
      const int s = (gq0 + q) % STAGES;
      unsigned char* slot = sm + s * SLOT_BYTES;
      mbar_expect(&full[s], SLOT_BYTES);
      tma_load(slot, am, kc * BK, (tile % tm) * BM, &full[s]);
      tma_load(slot + A_BYTES, bm, (tile / tm) * BN, kc * BK, &full[s]);
      tma_load(slot + A_BYTES + BQ_BYTES, bsm, (tile / tm) * BN, kc * (BK / 32), &full[s]);
    };
    auto land_and_dequant = [&](int q) {
      const unsigned gq = gq0 + q, s = gq % STAGES;
      mbar_wait(&full[s], (gq / STAGES) & 1u);
      const unsigned char* slot = sm + s * SLOT_BYTES;
      dequant(slot + A_BYTES, reinterpret_cast<const float*>(slot + A_BYTES + BQ_BYTES), bbf + (q & 1) * NP * PANEL);
      fence_async_smem();  // the panels, to the async proxy
    };
    if (phase == 1) {  // g complete in every block before any of it is read
      fence_proxy_async();
      grid_sync(a.bar, target);
      fence_proxy_async();
    }
    if (tid == 0)
      for (int q = 0; q < STAGES && q < Q; ++q) issue(q);
    if (Q) land_and_dequant(0);
    __syncthreads();

    float acc[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    for (int q = 0; q < Q; ++q) {
      const unsigned char* A = sm + ((gq0 + q) % STAGES) * SLOT_BYTES + wg * (64 * BK * 2);
      const __nv_bfloat16* B = bbf + (q & 1) * NP * PANEL;
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_n128(acc[0], acc[1], gdesc(A + kk * 32), gdesc_n128(B + kk * 16 * 64));
      wg_commit();
      if (q + 1 < Q) land_and_dequant(q + 1);  // while the products run
      wg_wait0();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      if (q % nk == nk - 1) {  // the tile's last chunk: its epilogue
        const int tile = blockIdx.x + (q / nk) * gridDim.x;
        const int row0 = (tile % tm) * BM + warp * 16 + (lane >> 2), col0 = (tile / tm) * BN + 2 * (lane & 3);
        // acc[p][4j + e]: row row0 + 8 (e >> 1), column col0 + 64 p + 8 j + (e & 1)
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = row0 + 8 * hf, col = col0 + 64 * p + 8 * j;
              const float v0 = acc[p][4 * j + 2 * hf], v1 = acc[p][4 * j + 2 * hf + 1];
              if (row < M && col < N) {
                if (phase == 0)
                  *reinterpret_cast<uint32_t*>(a.g + (size_t)row * a.F + col) =
                      pack_bf16(gelu(v0 + a.b1[col], a.gelu_erf), gelu(v1 + a.b1[col + 1], a.gelu_erf));
                else
                  *reinterpret_cast<uint32_t*>(a.out + (size_t)row * a.D + col) =
                      pack_bf16(finish<true>(v0, a.b2 ? a.b2[col] : 0.f, a.bias_after_round),
                                finish<true>(v1, a.b2 ? a.b2[col + 1] : 0.f, a.bias_after_round));
              }
              acc[p][4 * j + 2 * hf] = 0.f, acc[p][4 * j + 2 * hf + 1] = 0.f;
            }
      }
      __syncthreads();  // both warpgroups' products of chunk q are done: its stage is free
      if (tid == 0 && q + STAGES < Q) issue(q + STAGES);
    }
    gq0 += Q;
  }
}

// =========================================================================
// Host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing new is linked
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] tensor, boxes of [box_rows, box_cols]; out-of-bounds elements read as zero
bool encode2d(CUtensorMap* m, const void* ptr, CUtensorMapDataType dt, int esize, uint64_t cols, uint64_t rows,
           uint32_t box_cols, uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(m, dt, 2, const_cast<void*>(ptr), dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode2d, remembered: a layer's maps are the same at every step
bool map2d(CUtensorMap* m, const void* ptr, CUtensorMapDataType dt, int esize, uint64_t cols, uint64_t rows,
           uint32_t box_cols, uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  struct Key {
    const void* ptr;
    uint64_t cols, rows;
    uint32_t box_cols, box_rows;
    int dt, swizzle;
  };
  static Key keys[512];
  static CUtensorMap maps[512];
  Key k;
  memset(&k, 0, sizeof(k));
  k.ptr = ptr, k.cols = cols, k.rows = rows, k.box_cols = box_cols, k.box_rows = box_rows, k.dt = dt, k.swizzle = swizzle;
  const size_t h = ((reinterpret_cast<uintptr_t>(ptr) >> 4) ^ (cols * 131) ^ (rows * 31) ^ (box_cols * 7) ^ box_rows) % 512;
  if (memcmp(&keys[h], &k, sizeof(k)) == 0) {
    *m = maps[h];
    return true;
  }
  if (!encode2d(m, ptr, dt, esize, cols, rows, box_cols, box_rows, swizzle)) return false;
  keys[h] = k, maps[h] = *m;
  return true;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

struct DecPlan {
  int C, e, nparts, mt, half, warps, grid;  // half: bf16 of at most 8 rows
  size_t smem;
};

size_t dec_block_smem(int b, int D, int F, const DecPlan& p) {
  const DecLayout l = dec_layout(b, D, F, p.C, p.e);
  return 1024 + up(l.end, 16) + dec_partials(l.c1, D, p.mt, p.warps) * 4 + 8 * (MAX_PARTS + 1);
}

// Units to blocks: each of the first D/16 blocks one fc2 unit and e fc1
// units, each later one C fc1 units. Before the grid barrier a block
// needs only its W1 units (its W2 unit lands while it waits), so the split
// weighs a block's fc1 units whole and its W2 unit at a quarter (W2_WEIGHT):
// the smallest largest block, then the fewest units a block (more blocks),
// within one block to an SM and its shared memory. W1 is copied in the
// most K parts (each its own barrier) that divide D / 32.
constexpr double W2_WEIGHT = 0.25;

bool dec_plan(int M, int D, int F, bool bf16, DecPlan* p) {
  const int nsm = sm_count();
  if (M <= 0 || D <= 0 || F <= 0 || D % 32 || (bf16 && M >= 64) || !nsm) return false;
  const int U1 = F / UNIT, U2 = D / UNIT;
  p->mt = M >= 64 ? 4 : (M + 15) / 16;
  p->half = bf16 && M <= 8;
  p->warps = dec_warps(bf16, p->mt);
  if (U2 > nsm || F % (32 * p->warps)) return false;
  p->nparts = 1;
  for (int n = 1; n <= MAX_PARTS; ++n)
    if ((D / 32) % n == 0) p->nparts = n;
  const double w1u = 18.0 * D, w2u = 18.0 * F;  // a unit's codes and scales, bytes
  double best = 0;
  DecPlan q = *p;
  p->C = 0;
  for (int C = 1; C <= U1; ++C)
    for (int e = 0; e <= C; ++e) {
      const int rest = U1 - U2 * e;
      if (rest < 0) break;
      q.C = C, q.e = e, q.grid = U2 + (rest + C - 1) / C;
      const double cost = C * w1u > e * w1u + W2_WEIGHT * w2u ? C * w1u : e * w1u + W2_WEIGHT * w2u;
      if (q.grid > nsm || (p->C && cost >= best)) continue;
      size_t need = dec_block_smem(0, D, F, q);
      if (q.grid > U2) {
        const size_t other = dec_block_smem(U2, D, F, q);
        need = other > need ? other : need;
      }
      if (need > SMEM_LIMIT) continue;
      q.smem = need > ONE_PER_SM ? need : ONE_PER_SM;
      *p = q, best = cost;
    }
  return p->C > 0;
}

using DecKernel = void (*)(DecArgs);

// the decode instances: 0-3 f32 (mt 1-4), 4 bf16 of at most 8 rows, 5-8 bf16 (mt 1-4)
int dec_index(int bf16, const DecPlan& p) { return bf16 ? (p.half ? 4 : 4 + p.mt) : p.mt - 1; }

DecKernel dec_instance(int index) {
  static const DecKernel table[9] = {
      ffn_kernel<float, 1, false>,         ffn_kernel<float, 2, false>,         ffn_kernel<float, 3, false>,
      ffn_kernel<float, 4, false>,         ffn_kernel<__nv_bfloat16, 1, true>,  ffn_kernel<__nv_bfloat16, 1, false>,
      ffn_kernel<__nv_bfloat16, 2, false>, ffn_kernel<__nv_bfloat16, 3, false>, ffn_kernel<__nv_bfloat16, 4, false>};
  return table[index];
}

// Raises an instance's shared-memory cap to what the launch needs: index
// 0-8 the decode instances (dec_index), 9 the encoder's.
template <typename K>
cudaError_t allow_smem(K kernel, int index, size_t smem) {
  static size_t allowed[10] = {};
  if (smem <= allowed[index]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed[index] = smem;
  return err;
}

int enc_grid(int M, int D, int F) {
  const int tm = (M + BM - 1) / BM;
  const int t1 = tm * ((F + BN - 1) / BN), t2 = tm * ((D + BN - 1) / BN);
  const int t = t1 > t2 ? t1 : t2;
  return t < sm_count() ? t : sm_count();
}

bool encoder_regime(int M, int bf16) { return bf16 && M >= 64; }

cudaLaunchConfig_t config(int grid, int threads, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeCooperative;  // every block resident at once: the grid barrier
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The plan of a shape: plan[0] regime (0 decode, 1 encoder), [1] blocks,
// [2] the scratch's elements (M x F, x's dtype), [3] shared memory bytes a
// block, [4] C and [5] e (decode: fc1 units of a later block, of an fc2
// block), [6] K parts of W1 (decode), [7] 1: a cooperative launch, [8]
// threads a block. Returns a CUDA error code (0 on success;
// cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ffn_plan(int M, int D, int F, int x_bf16, long long* plan) {
  for (int i = 0; i < 9; ++i) plan[i] = 0;
  if (M <= 0 || D <= 0 || F <= 0 || D % 32 || F % 32 || !sm_count()) return static_cast<int>(cudaErrorInvalidValue);
  plan[2] = (long long)M * F;
  plan[7] = 1;
  if (encoder_regime(M, x_bf16)) {
    plan[0] = 1, plan[1] = enc_grid(M, D, F), plan[3] = (long long)ENC_SMEM, plan[8] = THREADS;
    return 0;
  }
  DecPlan p;
  if (!dec_plan(M, D, F, x_bf16 != 0, &p)) return static_cast<int>(cudaErrorInvalidValue);
  plan[1] = p.grid, plan[3] = (long long)p.smem, plan[4] = p.C, plan[5] = p.e, plan[6] = p.nparts;
  plan[8] = 32 * p.warps;
  return 0;
}

// x: [M, D] f32 or bf16 (x_bf16); qw1 int8 [D, F], s1 f32 [D/32, F], b1 f32
// [F]; qw2 int8 [F, D], s2 f32 [F/32, D], b2 f32 [D] or null (no bias: a
// tensor-parallel shard's fc2, whose bias is added after the sum); w1u, w2u: the same
// codes and scales in units (KB_BYTES; read below 64 rows of bf16 and for
// f32, may be null otherwise); out: [M, D] in x's dtype; g: the
// scratch, M x F in x's dtype; bar: one uint64, zero before the first
// launch. gelu_erf: 0 tanh, 1 erf; bias_after_round: 1 for K4's order.
// 16-byte aligned tensors. One cooperative launch on `stream`; returns its
// CUDA error code.
extern "C" int fused_ffn(const void* x, int x_bf16, const void* qw1, const void* s1, const void* b1,
                         const void* qw2, const void* s2, const void* b2, const void* w1u, const void* w2u,
                         void* out, void* g, void* bar, int M, int D, int F,
                         int gelu_erf, int bias_after_round, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || D % 32 || F % 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  const CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8, F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle NONE = CU_TENSOR_MAP_SWIZZLE_NONE;
  cudaError_t err;
  if (encoder_regime(M, x_bf16)) {
    EncMaps maps;
    const CUtensorMapDataType B16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!map2d(&maps.x, x, B16, 2, D, M, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !map2d(&maps.g, g, B16, 2, F, M, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !map2d(&maps.w1, qw1, U8, 1, F, D, BN, BK, NONE) || !map2d(&maps.s1, s1, F32, 4, F, D / 32, BN, BK / 32, NONE) ||
        !map2d(&maps.w2, qw2, U8, 1, D, F, BN, BK, NONE) || !map2d(&maps.s2, s2, F32, 4, D, F / 32, BN, BK / 32, NONE))
      return static_cast<int>(cudaErrorInvalidValue);
    EncArgs a;
    a.b1 = static_cast<const float*>(b1);
    a.b2 = static_cast<const float*>(b2);
    a.g = static_cast<__nv_bfloat16*>(g);
    a.out = static_cast<__nv_bfloat16*>(out);
    a.bar = static_cast<unsigned long long*>(bar);
    a.M = M, a.D = D, a.F = F, a.gelu_erf = gelu_erf, a.bias_after_round = bias_after_round;
    if ((err = allow_smem(ffn_wgmma_kernel, 9, ENC_SMEM)) != cudaSuccess) return static_cast<int>(err);
    const cudaLaunchConfig_t cfg = config(enc_grid(M, D, F), THREADS, ENC_SMEM, st, attr);
    err = cudaLaunchKernelEx(&cfg, ffn_wgmma_kernel, maps, a);
  } else {
    DecPlan p;
    if (!dec_plan(M, D, F, x_bf16 != 0, &p)) return static_cast<int>(cudaErrorInvalidValue);
    if (!w1u || !w2u) return static_cast<int>(cudaErrorInvalidValue);
    DecArgs a;
    a.x = x;
    a.w1 = static_cast<const unsigned char*>(w1u);
    a.w2 = static_cast<const unsigned char*>(w2u);
    a.b1 = static_cast<const float*>(b1);
    a.b2 = static_cast<const float*>(b2);
    a.g = g;
    a.out = out;
    a.bar = static_cast<unsigned long long*>(bar);
    a.M = M, a.D = D, a.F = F, a.C = p.C, a.e = p.e, a.nparts = p.nparts;
    a.gelu_erf = gelu_erf, a.bias_after_round = bias_after_round;
    const int index = dec_index(x_bf16 != 0, p);
    const DecKernel kernel = dec_instance(index);
    if ((err = allow_smem(kernel, index, p.smem)) != cudaSuccess) return static_cast<int>(err);
    const cudaLaunchConfig_t cfg = config(p.grid, 32 * p.warps, p.smem, st, attr);
    err = cudaLaunchKernelEx(&cfg, kernel, a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
