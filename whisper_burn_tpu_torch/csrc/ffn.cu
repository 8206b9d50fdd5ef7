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
// As in K4 and K7 the hidden h = x . W1 + b1 and g = gelu(h) never reach
// device memory: they live in registers and shared memory.
//
// Rounding, as the Pallas kernels round: for bf16 x every weight is
// bf16(code x bf16(scale)) (a code times a bf16 scale is exact in f32, so
// rounding the f32 product once is bf16's multiply; each scale is rounded
// once, by the thread that staged it); h is summed in f32, g = gelu(h) is
// rounded to bf16, the fc2 sum is f32. f32 x is f32 throughout. GELU is
// the tanh form or, for "erf", K4's Abramowitz & Stegun 7.1.26 erf (about
// 3e-6 from the exact erf), so that the kernel and its plain version agree
// with K4 and K7 to the last f32 step.
//
// Bound. At the decode shapes (M = 1-40 rows, Large-V3 1280 <-> 5120) the
// work is reading the weights once: 2 (D F + D F / 32 x 4) = 14.75 MB, 4.4
// us at 3.35 TB/s whatever M. The encoder's 1536 rows (B = 1) are bound by
// operations: 4 M D F = 40.3 GFLOP, 40.7 us at 989 TFLOP/s.
//
// Design. F is cut into steps of 32 cs columns, cs (at most 8) the blocks
// of a thread block cluster; a block owns 32 of the step's F columns in fc1
// and D / cs of the output columns in fc2 (Large-V3: 32 of 256, and 160 of
// 1280). Its warps split both: two warps to each 32 output columns (one
// where the cluster size is odd, shape_plan); in fc1 each warp
// takes its own run of 32-row K steps, in fc2 its half of the step's rows
// at its 32 columns.
//  - At a step's start every warp issues, with cp.async, its parts of the
//    block's W1 slice [D][32] (40 KB) and W2 slice [32 cs][D / cs] (40 KB)
//    and their scales: the whole slice is in flight at once, and each warp
//    waits for its own part only, with no block barrier.
//  - fc1: each warp runs mma.sync (m16n8k16, bf16 in, f32 out) on x's rows
//    (read from global memory) and the codes. A lane builds its B fragments
//    from four 32-bit words of codes: within each 16-row K step rows
//    4t..4t+3 stand for the mma's k = 2t, 2t+1, 2t+8, 2t+9, and column n of
//    n8 tile j is column 4n + j, so that an A fragment is one 8-byte load
//    and a B fragment one word a row; a byte permute and one logic op turn
//    two codes into bf16 200 + c, and one bf16x2 subtract and multiply into
//    bf16(c x s). Rows are stored rotated within each group of four (row
//    4t+i at 4t+((i+t)&3)) so those loads meet no bank conflict. The warps'
//    sums meet in shared memory, added in warp order; + b1, GELU and the
//    rounding give g [M][32].
//  - The cluster's blocks exchange g through distributed shared memory:
//    every block then holds G [M][32 cs] and runs fc2 on it for its own
//    output columns, the same fragments from the W2 slice.
//  - Rows: a tile of at most 64 rows (four m16 tiles) per cluster. Below 64
//    rows one tile, and the steps are split over as many clusters as the
//    card holds at once (20 at Large-V3 below 17 rows, 10 above): each
//    cluster writes its f32 sums to a workspace, bumps an integer counter
//    per owner, and the last to arrive sums the splits in index order, adds
//    the bias and rounds (then resets the counter, so a replayed graph needs
//    no memset). From 64 rows each cluster walks every step for its own row
//    tile, its output sums in registers, and no workspace is used.
// What bounds it on the card: not the weight read but the chain of
// dependent phases after it (fc1, the exchange, fc2, the splits' sum);
// scripts/torch_ffn_phases.py stamps each phase, PERF.md has the readings.
// No float atomics: every sum runs in a fixed order, so two launches on the
// same inputs give the same bits. The workspace and the counters are the
// wrapper's, made once per (device, shape); launches of one shape must not
// run concurrently on two streams.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int FC = 32;          // F columns a block owns in fc1 (a W2 scale row)
constexpr int MAX_CS = 8;       // blocks of a cluster
constexpr int TILE_ROWS = 64;   // rows of a row tile: four m16 tiles
constexpr int GP = 16;          // G row pad (elements): conflict-free 8-byte loads
constexpr int MAX_THREADS = 320;

struct FfnArgs {
  const void* x;         // [M, D] f32 or bf16
  const int8_t* qw1;     // [D, F]
  const float* s1;       // [D/32, F]
  const float* b1;       // [F]
  const int8_t* qw2;     // [F, D]
  const float* s2;       // [F/32, D]
  const float* b2;       // [D]
  void* out;             // [M, D], x's dtype
  float* ws;             // [tiles][nsplit][R][D] f32 when nsplit > 1
  unsigned* counters;    // [tiles][cs]
  int M, D, F, cs, ks, nsplit, gelu_erf, bias_after_round;
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Where weight row r (of a slice) is stored: rotated within its group of
// four, so that lane t's rows 4t+i (i fixed) fall in four bank groups.
__device__ __forceinline__ int row_at(int r) { return (r & ~3) | ((r + (r >> 2)) & 3); }

// B fragments of four n8 tiles for one 16-row K step: w[i] holds the codes
// of row 4t+i at columns 4g..4g+3; tile j takes column 4g+j, and its rows
// 4t, 4t+1 (b0) and 4t+2, 4t+3 (b1) stand for the mma's k = 2t, 2t+1 and
// 2t+8, 2t+9. s2[j]: column 4g+j's scale as a bf16 pair. A Q4 code c (-8
// to 7) becomes the bf16 200 + c by a byte permute and one logic op (its
// low nibble xor 0x48 under the bf16 exponent byte 0x43), then c exactly by
// subtracting 200, then bf16(c x s) by one bf16 multiply: two codes per
// instruction of each kind.
__device__ __forceinline__ uint32_t bf16x2_sub_mul(uint32_t v, uint32_t s2) {
  const uint32_t k200 = 0x43484348u;  // bf16 200 twice
  const __nv_bfloat162 c = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), *reinterpret_cast<const __nv_bfloat162*>(&k200));
  const __nv_bfloat162 w = __hmul2(c, *reinterpret_cast<const __nv_bfloat162*>(&s2));
  return *reinterpret_cast<const uint32_t*>(&w);
}

__device__ __forceinline__ void b_fragments(const uint32_t w[4], const uint32_t s2[4], uint32_t b[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = (__byte_perm(w[0], w[1], 0x4400u + 0x1111u * j) & 0x000F000Fu) ^ 0x43484348u;
    const uint32_t hi = (__byte_perm(w[2], w[3], 0x4400u + 0x1111u * j) & 0x000F000Fu) ^ 0x43484348u;
    b[j][0] = bf16x2_sub_mul(lo, s2[j]);
    b[j][1] = bf16x2_sub_mul(hi, s2[j]);
  }
}

// Four scales (already rounded to bf16) as bf16 pairs.
__device__ __forceinline__ void scale_pairs(float4 v, uint32_t s2[4]) {
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) s2[j] = pack_bf16(f[j], f[j]);
}

// The block's shared memory, carved from one dynamic buffer. Each warp
// owns a part of the weight slices: its K steps of W1 (fc1) and its rows
// of W2 at its 32 output columns (fc2), which it loads, waits for and
// reads alone.
template <typename T, int MT>
struct Smem {
  int8_t* w1;     // [W][cs/ks * 32 rows][FC] codes, rows at row_at
  float* sc1;     // [W][cs/ks][FC]
  int8_t* w2;     // [W][FR/ks rows][32] codes, rows at row_at
  float* sc2;     // [W][cs/ks][32]
  float* P;       // [W][R][FC]: the warps' fc1 sums; at the end their fc2 sums ...
  T* G;           // [R][GS]: ... sharing their space with the cluster's g
  T* gown;        // [R][FC]: this block's g, read by its peers
  unsigned* flag;

  __host__ __device__ static size_t pg_bytes(int D, int cs, int ks) {
    const int warps = D / (32 * cs) * ks, R = 16 * MT;
    const size_t p = (size_t)warps * R * FC * 4, g = (size_t)R * (FC * cs + GP) * sizeof(T);
    return p > g ? p : g;
  }
  __host__ __device__ static size_t bytes(int D, int cs, int ks) {
    return (size_t)D * FC * 2 + (size_t)D * 8 + pg_bytes(D, cs, ks) + (size_t)16 * MT * FC * sizeof(T) + 16;
  }
  __device__ Smem(unsigned char* p, int D, int cs, int ks) {
    w1 = reinterpret_cast<int8_t*>(p);
    sc1 = reinterpret_cast<float*>(w1 + D * FC);
    w2 = reinterpret_cast<int8_t*>(sc1 + D);
    sc2 = reinterpret_cast<float*>(w2 + D * FC);
    P = sc2 + D;
    G = reinterpret_cast<T*>(P);
    gown = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(P) + pg_bytes(D, cs, ks));
    flag = reinterpret_cast<unsigned*>(gown + 16 * MT * FC);
  }
};

// At most 320 threads a block (two warps to each 32 output columns at
// Large-V3); below 17 rows two blocks to a multiprocessor.
template <typename T, int MT>
__global__ void __launch_bounds__(MAX_THREADS, MT == 1 ? 2 : 1) ffn_kernel(const FfnArgs a) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int R = 16 * MT;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cs, ks = a.ks, D = a.D, M = a.M;
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = blockIdx.x / cs, tile = blockIdx.y;
  const int m0 = tile * TILE_ROWS, mrows = min(TILE_ROWS, M - m0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int W = nthreads >> 5, warp = tid >> 5, lane = tid & 31;
  const int nw = W / ks;                  // 32-column groups of the block's output
  const int g = lane >> 2, t = lane & 3;
  const int Dc = D / cs, n0 = rank * Dc;  // this block's output columns
  const int cw = (warp % nw) * 32;        // this warp's, within them,
  const int FR = FC * cs, GS = FR + GP;   // F rows of a step; G's row stride
  const int fr_w = FR / ks, r0w = (warp / nw) * fr_w;  // and its rows of the step's FR
  const int kw = cs / ks, ks0 = warp * kw;  // its fc1 K steps (of 32 rows): kw of the D/32
  const int steps = a.F / FR;
  const int s_lo = split * steps / a.nsplit, s_hi = (split + 1) * steps / a.nsplit;
  const T* x = static_cast<const T*>(a.x);
  // where this lane's B-fragment words sit in a 16-row group of a weight
  // part (rows 4t..4t+3, columns 4g..4g+3), in rows of 32 bytes
  int boff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) boff[i] = row_at(4 * t + i) * 32 + 4 * g;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, MT> sm(smem_raw, D, cs, ks);
  int8_t* w1w = sm.w1 + warp * kw * 32 * FC;
  float* sc1w = sm.sc1 + warp * kw * FC;
  int8_t* w2w = sm.w2 + warp * fr_w * 32;
  float* sc2w = sm.sc2 + warp * kw * 32;

  auto load_w1 = [&](int s) {  // this warp's K rows of the step's W1 slice, and their scales
    const int f0 = s * FR + rank * FC;
    const int8_t* src = a.qw1 + (size_t)ks0 * 32 * a.F + f0;
    for (int i = lane; i < kw * 64; i += 32) {
      const int r = i >> 1, c = (i & 1) * 16;
      cp_async16(w1w + row_at(r) * FC + c, src + (size_t)r * a.F + c);
    }
    for (int i = lane; i < kw * 8; i += 32)  // float4 i: scale row i/8
      cp_async16(sc1w + 4 * i, a.s1 + (size_t)(ks0 + (i >> 3)) * a.F + f0 + (i & 7) * 4);
  };
  auto load_w2 = [&](int s) {  // this warp's rows of the step's W2 at its 32 columns, and their scales
    const int fr0 = s * FR + r0w;
    const int8_t* src = a.qw2 + (size_t)fr0 * D + n0 + cw;
    for (int i = lane; i < fr_w * 2; i += 32) {
      const int r = i >> 1, c = (i & 1) * 16;
      cp_async16(w2w + row_at(r) * 32 + c, src + (size_t)r * D + c);
    }
    for (int i = lane; i < kw * 8; i += 32)
      cp_async16(sc2w + 4 * i, a.s2 + (size_t)(fr0 / 32 + (i >> 3)) * D + n0 + cw + (i & 7) * 4);
  };
  // wait for this warp's oldest pending slice; round the scales this lane
  // staged to bf16 in place (bf16 x only); publish both within the warp
  auto wait_own = [&](float* sc) {
    cp_async_wait<1>();
    if constexpr (BF) {
      for (int i = lane; i < kw * 8; i += 32) {
        const float4 v = reinterpret_cast<float4*>(sc)[i];
        reinterpret_cast<float4*>(sc)[i] = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
      }
    }
    __syncwarp();
  };

  // fc2's sums over this split's steps: bf16 as mma fragments [MT][4 tiles][4],
  // f32 as one column (lane) of rows 0..R-1
  float acc2[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc2[i] = 0.f;

  load_w1(s_lo);
  cp_async_commit();
  load_w2(s_lo);
  cp_async_commit();
  for (int s = s_lo; s < s_hi; ++s) {
    const int f0 = s * FR + rank * FC;
    float* Pw = sm.P + warp * R * FC;

    // ---- fc1: this warp's part of h [R][FC], over its kw K steps
    if constexpr (BF) {
      float acc1[MT][4][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.f;
      // x's A fragments of K step k: rows g and g+8 of each m16 tile, k 4t..4t+3 of each half
      auto load_a = [&](int k, uint32_t (&af)[2][MT][4]) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int ra = mt * 16 + g, rb = ra + 8, kx = (ks0 + k) * 32 + h * 16 + 4 * t;
            const uint2 lo = ra < mrows ? __ldg(reinterpret_cast<const uint2*>(x + (size_t)(m0 + ra) * D + kx)) : make_uint2(0u, 0u);
            const uint2 hi = rb < mrows ? __ldg(reinterpret_cast<const uint2*>(x + (size_t)(m0 + rb) * D + kx)) : make_uint2(0u, 0u);
            af[h][mt][0] = lo.x, af[h][mt][1] = hi.x, af[h][mt][2] = lo.y, af[h][mt][3] = hi.y;
          }
      };
      wait_own(sc1w);  // W1(s)
      for (int k = 0; k < kw; ++k) {
        uint32_t af[2][MT][4];
        load_a(k, af);
        uint32_t s2[4];
        scale_pairs(*reinterpret_cast<const float4*>(sc1w + k * FC + 4 * g), s2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kb = k * 32 + h * 16;
          uint32_t w[4], b[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(w1w + kb * FC + boff[i]);
          b_fragments(w, s2, b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc1[mt][j], af[h][mt], b[j]);
        }
      }
      // element e of tile j is row g + 8 (e >> 1), column 8t + 4 (e & 1) + j
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Pw[(mt * 16 + g + 8 * (e >> 1)) * FC + 8 * t + 4 * (e & 1) + j] = acc1[mt][j][e];
    } else {
      float acc1[R];
#pragma unroll
      for (int m = 0; m < R; ++m) acc1[m] = 0.f;
      wait_own(sc1w);  // W1(s)
      for (int k = 0; k < kw; ++k) {
        const float sc = sc1w[k * FC + lane];
        for (int kk = 0; kk < 32; ++kk) {
          const int r = (ks0 + k) * 32 + kk;
          const float wv = static_cast<float>(w1w[row_at(k * 32 + kk) * FC + lane]) * sc;
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const float xv = m < mrows ? __ldg(reinterpret_cast<const float*>(x) + (size_t)(m0 + m) * D + r) : 0.f;
            acc1[m] = fmaf(xv, wv, acc1[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < R; ++m) Pw[m * FC + lane] = acc1[m];
    }
    // this warp's W1 rows are read: they take the next step's
    if (s + 1 < s_hi) load_w1(s + 1);
    cp_async_commit();

    // ---- g = gelu(h + b1), the warps' sums taken in order and rounded to T
    if (s == s_lo) __syncthreads();  // every warp's sum is in P
    else cluster.sync();  // and the peers have gathered the previous step's g
    for (int i = tid; i < mrows * FC; i += nthreads) {
      float h = sm.P[i];
      for (int w = 1; w < W; ++w) h += sm.P[w * R * FC + i];
      h += a.b1[f0 + (i & (FC - 1))];
      store(sm.gown + i, a.gelu_erf ? gelu_erf(h) : gelu_tanh(h));
    }
    cluster.sync();  // every block's g is in place (and P is read)
    {  // the cluster's g into G, four 16-byte pieces in flight a thread
      constexpr int VPR = FC * sizeof(T) / 16;  // 16-byte pieces of a g row
      const int per_peer = mrows * VPR, total = cs * per_peer;
      for (int i0 = tid; i0 < total; i0 += 4 * nthreads) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * nthreads;
          if (i < total) {
            const int q = i / per_peer, rem = i - q * per_peer, m = rem / VPR, c = rem - m * VPR;
            v[u] = reinterpret_cast<const uint4*>(cluster.map_shared_rank(sm.gown + m * FC, q))[c];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * nthreads;
          if (i < total) {
            const int q = i / per_peer, rem = i - q * per_peer, m = rem / VPR, c = rem - m * VPR;
            reinterpret_cast<uint4*>(sm.G + m * GS + q * FC)[c] = v[u];
          }
        }
      }
    }
    // the last step's g read from the peers: arrive at the cluster barrier
    // that lets them leave (waited for at the end)
    if (s + 1 == s_hi) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();  // G complete

    // ---- fc2: this warp's rows of G at its 32 output columns
    wait_own(sc2w);  // W2(s)
    if constexpr (BF) {
      for (int kb = 0; kb < fr_w; kb += 16) {
        uint32_t s2[4], w[4], b[4][2];
        scale_pairs(*reinterpret_cast<const float4*>(sc2w + (kb >> 5) * 32 + 4 * g), s2);
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(w2w + kb * 32 + boff[i]);
        b_fragments(w, s2, b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int ra = mt * 16 + g, rb = ra + 8, kg = r0w + kb + 4 * t;
          const uint2 lo = ra < mrows ? *reinterpret_cast<const uint2*>(sm.G + ra * GS + kg) : make_uint2(0u, 0u);
          const uint2 hi = rb < mrows ? *reinterpret_cast<const uint2*>(sm.G + rb * GS + kg) : make_uint2(0u, 0u);
          const uint32_t af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc2 + (mt * 4 + j) * 4, af, b[j]);
        }
      }
    } else {
      for (int k = 0; k < fr_w; ++k) {
        const float wv = static_cast<float>(w2w[row_at(k) * 32 + lane]) * sc2w[(k >> 5) * 32 + lane];
        const float* gr = reinterpret_cast<const float*>(sm.G) + r0w + k;
#pragma unroll
        for (int m = 0; m < R; ++m) acc2[m] = fmaf(gr[m * GS], wv, acc2[m]);
      }
    }
    // this warp's W2 rows are read: they take the next step's
    if (s + 1 < s_hi) load_w2(s + 1);
    cp_async_commit();
    __syncthreads();  // G is read before the next step's sums overwrite it
  }
  cp_async_wait<0>();

  // ---- the warps' fc2 sums into P as [warp][row][32]
  float* Qw = sm.P + warp * R * FC;
  if constexpr (BF) {
    // element e of tile j is row g + 8 (e >> 1), column 8t + 4 (e & 1) + j
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Qw[(mt * 16 + g + 8 * (e >> 1)) * FC + 8 * t + 4 * (e & 1) + j] = acc2[(mt * 4 + j) * 4 + e];
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) Qw[m * FC + lane] = acc2[m];
  }
  __syncthreads();  // the sums are in P

  // ---- the result: out (one split) or the workspace, then the last split sums
  const int nsplit = a.nsplit;
  T* out = static_cast<T*>(a.out);
  auto finish = [&](float v, int n) {  // + b2 in K7's order (f32, one rounding) or K4's
    const float b = a.b2[n];
    if (BF && a.bias_after_round) return round_bf16(v) + round_bf16(b);
    return v + b;
  };
  for (int i = tid; i < mrows * Dc; i += nthreads) {  // a column's row parts summed in order
    const int row = i / Dc, col = i - row * Dc, grp = col >> 5;
    float v = 0.f;
    for (int p = 0; p < ks; ++p) v += sm.P[((p * nw + grp) * R + row) * FC + (col & 31)];
    if (nsplit == 1) store(out + (size_t)(m0 + row) * D + n0 + col, finish(v, n0 + col));
    else a.ws[((size_t)(tile * nsplit + split) * R + row) * D + n0 + col] = v;
  }
  // no block leaves while a peer may still read its g
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (nsplit == 1) return;
  __threadfence();
  __syncthreads();
  unsigned* counter = a.counters + tile * cs + rank;
  if (tid == 0) *sm.flag = atomicAdd(counter, 1u) == static_cast<unsigned>(nsplit - 1);
  __syncthreads();
  if (!*sm.flag) return;
  __threadfence();
  const int q4 = Dc / 4;
  for (int i = tid; i < mrows * q4; i += nthreads) {
    const int row = i / q4, col = (i - row * q4) * 4;
    const float* src = a.ws + ((size_t)tile * nsplit * R + row) * D + n0 + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = 0; q0 < nsplit; q0 += 16) {  // sixteen splits' loads in flight, summed in index order
      float4 p[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (q0 + j < nsplit) p[j] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(q0 + j) * R * D));
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (q0 + j < nsplit) v.x += p[j].x, v.y += p[j].y, v.z += p[j].z, v.w += p[j].w;
    }
    T* o = out + (size_t)(m0 + row) * D + n0 + col;
    store(o, finish(v.x, n0 + col));
    store(o + 1, finish(v.y, n0 + col + 1));
    store(o + 2, finish(v.z, n0 + col + 2));
    store(o + 3, finish(v.w, n0 + col + 3));
  }
  if (tid == 0) *counter = 0u;  // every split has arrived: ready for the next launch
}

using KernelFn = void (*)(FfnArgs);

KernelFn instance(int bf16, int mt) {
  static const KernelFn table[2][4] = {
      {ffn_kernel<float, 1>, ffn_kernel<float, 2>, ffn_kernel<float, 3>, ffn_kernel<float, 4>},
      {ffn_kernel<__nv_bfloat16, 1>, ffn_kernel<__nv_bfloat16, 2>, ffn_kernel<__nv_bfloat16, 3>,
       ffn_kernel<__nv_bfloat16, 4>}};
  return table[bf16][mt - 1];
}

size_t smem_bytes(int bf16, int mt, int D, int cs, int ks) {
  switch (mt + 4 * bf16) {
    case 1: return Smem<float, 1>::bytes(D, cs, ks);
    case 2: return Smem<float, 2>::bytes(D, cs, ks);
    case 3: return Smem<float, 3>::bytes(D, cs, ks);
    case 4: return Smem<float, 4>::bytes(D, cs, ks);
    case 5: return Smem<__nv_bfloat16, 1>::bytes(D, cs, ks);
    case 6: return Smem<__nv_bfloat16, 2>::bytes(D, cs, ks);
    case 7: return Smem<__nv_bfloat16, 3>::bytes(D, cs, ks);
    default: return Smem<__nv_bfloat16, 4>::bytes(D, cs, ks);
  }
}

struct Plan {
  int cs, ks, threads, tiles, mt, steps;
  size_t smem;
};

// The shape's cluster size, warps, row tiles and shared memory; false if
// the kernel does not take it.
bool shape_plan(int M, int D, int F, int bf16, Plan* p) {
  if (M <= 0 || D <= 0 || F <= 0 || D % 32) return false;
  int cs = MAX_CS;
  while ((D / 32) % cs) --cs;  // the largest cluster whose blocks own whole warps of columns
  const int nw = D / (32 * cs);
  p->cs = cs;
  p->ks = 2 * 32 * nw <= MAX_THREADS && cs % 2 == 0 ? 2 : 1;  // warps to each 32 columns
  p->threads = 32 * nw * p->ks;
  if (p->threads > MAX_THREADS || F % (FC * cs)) return false;
  p->tiles = (M + TILE_ROWS - 1) / TILE_ROWS;
  const int rows = M < TILE_ROWS ? M : TILE_ROWS;
  p->mt = (rows + 15) / 16;
  p->steps = F / (FC * cs);
  p->smem = smem_bytes(bf16, p->mt, D, cs, p->ks);
  return p->smem <= 232448;
}

cudaLaunchConfig_t config(const Plan& p, int nsplit, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs * nsplit, p.tiles);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises an instance's shared-memory cap to what the launch needs.
cudaError_t allow_smem(int bf16, int mt, size_t smem) {
  static size_t allowed[2][4] = {};
  if (smem <= allowed[bf16][mt - 1]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(instance(bf16, mt), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed[bf16][mt - 1] = smem;
  return err;
}

}  // namespace

// The plan of a shape: plan[0] cluster size, [1] splits of F (clusters per
// row tile), [2] row tiles, [3] rows per tile in the workspace, [4] the
// workspace's f32 count (0 with one split). The splits fill the clusters
// the card holds at once, as evenly as the steps allow. Returns a CUDA
// error code (0 on success).
extern "C" int ffn_plan(int M, int D, int F, int x_bf16, long long* plan) {
  Plan p;
  if (!shape_plan(M, D, F, x_bf16 != 0, &p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(x_bf16 != 0, p.mt, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(p, 1, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, instance(x_bf16 != 0, p.mt), &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nsplit = 1;
  if (clusters > p.tiles) {
    int cap = clusters / p.tiles;
    cap = cap < p.steps ? cap : p.steps;
    const int per = (p.steps + cap - 1) / cap;  // steps per split
    nsplit = (p.steps + per - 1) / per;
  }
  plan[0] = p.cs;
  plan[1] = nsplit;
  plan[2] = p.tiles;
  plan[3] = 16 * p.mt;
  plan[4] = nsplit > 1 ? (long long)p.tiles * nsplit * 16 * p.mt * D : 0;
  return 0;
}

// x: [M, D] f32 or bf16 (x_bf16); qw1 int8 [D, F], s1 f32 [D/32, F], b1 f32
// [F]; qw2 int8 [F, D], s2 f32 [F/32, D], b2 f32 [D]; out: [M, D] in x's
// dtype. ws: f32 of ws_floats and counters: uint32 [tiles x cs], zero at
// the first launch (the kernel leaves them zero), both from ffn_plan with
// the same nsplit. gelu_erf: 0 tanh, 1 erf; bias_after_round: 1 for K4's
// order. Needs D % 32 == 0, F a multiple of 32 x the cluster size, 16-byte
// aligned tensors. One launch on `stream`; returns its CUDA error code.
extern "C" int fused_ffn(const void* x, int x_bf16, const void* qw1, const void* s1, const void* b1,
                         const void* qw2, const void* s2, const void* b2, void* out, void* ws,
                         long long ws_floats, void* counters, int M, int D, int F, int nsplit,
                         int gelu_erf, int bias_after_round, void* stream) {
  Plan p;
  if (!shape_plan(M, D, F, x_bf16 != 0, &p) || nsplit < 1 || nsplit > p.steps) return static_cast<int>(cudaErrorInvalidValue);
  if (nsplit > 1 && ws_floats < (long long)p.tiles * nsplit * 16 * p.mt * D) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(x_bf16 != 0, p.mt, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  FfnArgs a;
  a.x = x;
  a.qw1 = static_cast<const int8_t*>(qw1);
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.qw2 = static_cast<const int8_t*>(qw2);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<unsigned*>(counters);
  a.M = M, a.D = D, a.F = F, a.cs = p.cs, a.ks = p.ks, a.nsplit = nsplit, a.gelu_erf = gelu_erf;
  a.bias_after_round = bias_after_round;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(p, nsplit, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, instance(x_bf16 != 0, p.mt), a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
