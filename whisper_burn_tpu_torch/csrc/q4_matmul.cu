// Kernel A: quantized matmul y[M, N] = x[M, K] @ (qw[K, N] * scales[K/32, N])
// with a fused epilogue (none, +bias, +bias then GELU).
//
// Replaces the TPU kernels of whisper_burn_tpu/ops/pallas_q4.py (_kernel
// K5, _kernel_stacked K1): the stacked form is this kernel with the weight
// pointer offset to one layer by the wrapper. The fused FFN of
// ops/pallas_ffn.py (K4, K7) is kernel I, csrc/ffn.cu.
//
// Two regimes in one source, all instances of q4_matmul_kernel, one launch
// per call, chosen by q4_matmul_regime() from M and x's dtype:
//
// (a) Weight-read regime: every f32 x, and bf16 x below MMA_MIN_ROWS rows
//     (the decode step, prefill, logits: M = 1-40). Bound on the H100 by
//     the weight read, one byte per weight and 4/32 of scales (1.7-2.2 us
//     a decode projection, 23 us the logits), against x's few KB. Design:
//     a block owns 64 columns and one K slice; a thread block cluster of up
//     to 8 blocks splits K, so the narrow projections still put hundreds
//     of warps in flight, and each weight byte comes from HBM once,
//     whatever M. The slices meet through distributed shared memory in
//     rank order, the k-groups of a block in shared memory in order: a
//     fixed order of summation, no atomics, so two calls give bitwise
//     equal results. The epilogue runs after the full sum. Codes become
//     floats four at a time by byte-permute into a biased float and one
//     subtraction (no I2F).
//     - f32 x (math in f32, the plain version to 1e-5): the block copies
//       its whole weight slice into shared memory with 16-byte cp.async,
//       then every 8-row group of x reads it there; a thread walks one
//       32-row scale block for 4 columns and applies the scale once.
//     - bf16 x (up to 64 rows): each warp streams its K steps through a
//       private cp.async ring and runs mma.sync on codes dequantized to
//       bf16, x's rows padded to 16: eight FMAs a code on CUDA cores at
//       M = 8 cost more than the weight read they hide behind.
//
// (b) Tensor-core regime: bf16 x at and above MMA_MIN_ROWS rows (the
//     encoder's 1536 and the cross fill's 1500 rows). Bound by operations
//     (2MKN at 989 TFLOP/s). Design: 128 x 128 block tiles, K steps of 32
//     (one scale row), a 4-stage cp.async pipeline for the x and code
//     tiles; while 8 warps run mma.sync.m16n8k16 (bf16 in, f32 accumulate)
//     from ldmatrix fragments on one step, they dequantize the next step's
//     codes to bf16 into the other of two B tiles: one barrier a step.
//     Ragged M and N are masked (zero-filled loads, predicated stores), the
//     epilogue fused.
//
// Rounding, as the Pallas kernels round: for bf16 x every weight is
// bf16(code x bf16(scale)) (pallas_q4.py casts codes and scales to the
// compute dtype and multiplies there). A code (at most 8 bits) times a bf16
// scale is exact in f32, so rounding the f32 product once gives bf16's
// multiply. Each scale is rounded once, by the thread that staged it,
// before the barrier that publishes it. f32 x dequantizes in f32. A bias
// is added in the output dtype after the sum is rounded to it, as the JAX
// package adds it to the kernel's result (models/decoder.py, ops/linear.py).
//
// MMA_MIN_ROWS = 64, by measurement (PERF.md, kernel A's findings): at 63 rows
// the weight-read form beats the 128-row tiles on every decode shape but
// the 52224-wide logits, and 64 rows is as many as its four m16 tiles take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int MMA_MIN_ROWS = 64;  // bf16 x of at least this many rows takes (b)

// ---- shared helpers -------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = (x + 0.044715f * x * x * x) * 0.7978845608028654f;
  return x * 0.5f * (tanhf(inner) + 1.0f);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// epilogue: 0 none, 1 +bias, 2 +bias then tanh-GELU, 3 +bias then erf-GELU;
// the bias is added in the output dtype TY, to the sum rounded to it
template <typename TY>
__device__ __forceinline__ float epilogue_op(float v, const float* bias, int n, int epilogue) {
  if (epilogue >= 1) v = std::is_same<TY, float>::value ? v + bias[n] : round_bf16(round_bf16(v) + round_bf16(bias[n]));
  if (epilogue == 2) v = gelu_tanh(v);
  if (epilogue == 3) v = gelu_erf(v);
  return v;
}

// Four int8 codes of a word -> four exact floats: each byte, offset to
// unsigned by the xor, becomes the low byte of 2^23's float, whose value is
// then 2^23 + code + 128.
__device__ __forceinline__ void codes_to_float4(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + j)) - 8388736.0f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past src_bytes (0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Codes [n, n + 16) of one weight row into shared memory, zeros past N.
// Rows are 16-byte aligned when N % 16 == 0 (n16); else (N % 4 == 0) the
// chunk goes as four 4-byte copies.
__device__ __forceinline__ void load_codes16(int8_t* dst, const int8_t* row, int n, int N, bool n16) {
  if (n16) {
    const bool ok = n < N;
    cp_async16(dst, ok ? row + n : row, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = n + 4 * j < N;
      cp_async4(dst + 4 * j, ok ? row + n + 4 * j : row, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

// four staged f32 scales rounded to bf16 in place (the bf16 forms' weights
// are bf16(code x bf16(scale)))
__device__ __forceinline__ void round_scales4(float* p) {
  float4 v = *reinterpret_cast<float4*>(p);
  v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
  *reinterpret_cast<float4*>(p) = v;
}

// ---- (a) weight-read regime ------------------------------------------------

constexpr int WR_BN = 64;               // columns per block
constexpr int WR_LANES = WR_BN / 4;     // threads across a row, 4 columns each
constexpr int WR_KB_MAX = 32;           // scale blocks per K slice (1024 rows)
constexpr int WR_MAX_SLICES = 8;        // K slices: the cluster's blocks

__host__ __device__ constexpr int wr_smem_bytes(int kbm, int mg) {
  // codes [kbm*32][BN] i8, x [kbm*32][mg] f32, k-group partials
  // [kbm][mg][BN] f32, the block's sum [mg][BN] f32
  return kbm * 32 * WR_BN + kbm * 32 * mg * 4 + kbm * mg * WR_BN * 4 + mg * WR_BN * 4;
}

template <int MG, typename TX, typename TY>
__device__ __forceinline__ void weight_read(const TX* __restrict__ x, const int8_t* __restrict__ qw,
                                            const float* __restrict__ scales,
                                            const float* __restrict__ bias, TY* __restrict__ y, int M,
                                            int K, int N, int epilogue) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nb = K / 32;
  const int kbm = (nb + S - 1) / S;  // the largest slice, which sizes shared memory
  const int kb0 = rank * nb / S;
  const int nkb = (rank + 1) * nb / S - kb0;  // this slice's scale blocks
  const int ks = nkb * 32, k0 = kb0 * 32;
  const int n0 = blockIdx.x * WR_BN;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const bool n16 = (N % 16) == 0;

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ws = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + kbm * 32 * WR_BN);
  float* red = xs + kbm * 32 * MG;
  float* part = red + kbm * MG * WR_BN;

  // the whole weight slice, once: 4 chunks of 16 codes per row
  for (int i = tid; i < ks * 4; i += nthreads) {
    const int r = i >> 2, c = (i & 3) * 16;
    load_codes16(ws + r * WR_BN + c, qw + (size_t)(k0 + r) * N, n0 + c, N, n16);
  }
  cp_async_commit();

  const int c4 = tid % WR_LANES;  // this thread's 4 columns
  const int g = tid / WR_LANES;   // and its scale block in the slice
  const int nc = n0 + c4 * 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < nkb && nc < N) s = *reinterpret_cast<const float4*>(scales + (size_t)(kb0 + g) * N + nc);

  const int outs = MG * WR_BN;
  const int o_lo = rank * outs / S, o_hi = (rank + 1) * outs / S;
  for (int m0 = 0; m0 < M; m0 += MG) {
    // x rows m0 .. m0+MG of the slice, as f32 [k][m]: all loads issued
    // before any store (ks <= 2 * nthreads), so they wait on memory once
    float xg[MG][2];
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = tid + h * nthreads;
        xg[m][h] = m0 + m < M && k < ks ? to_f(x[(size_t)(m0 + m) * K + k0 + k]) : 0.f;
      }
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (tid + h * nthreads < ks) xs[(tid + h * nthreads) * MG + m] = xg[m][h];
    cp_async_wait<0>();
    __syncthreads();
    if (g < nkb) {
      float acc[MG][4];
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
#pragma unroll 4
      for (int rr = 0; rr < 32; ++rr) {
        // neighbouring k-groups of a warp start one row apart: no bank conflict
        const int r = g * 32 + ((rr + g) & 31);
        float f[4];
        codes_to_float4(*reinterpret_cast<const uint32_t*>(ws + r * WR_BN + c4 * 4), f);
        const float* xr = xs + r * MG;
        float xv[MG];
        if constexpr (MG % 4 == 0) {
#pragma unroll
          for (int m = 0; m < MG; m += 4) {
            const float4 t = *reinterpret_cast<const float4*>(xr + m);
            xv[m] = t.x, xv[m + 1] = t.y, xv[m + 2] = t.z, xv[m + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < MG; ++m) xv[m] = xr[m];
        }
#pragma unroll
        for (int m = 0; m < MG; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv[m], f[j], acc[m][j]);
      }
#pragma unroll
      for (int m = 0; m < MG; ++m)
        *reinterpret_cast<float4*>(red + (g * MG + m) * WR_BN + c4 * 4) =
            make_float4(acc[m][0] * s.x, acc[m][1] * s.y, acc[m][2] * s.z, acc[m][3] * s.w);
    }
    __syncthreads();
    // the block's sum over its scale blocks, in order
    for (int o = tid; o < outs; o += nthreads) {
      float v = 0.f;
      for (int gg = 0; gg < nkb; ++gg) v += red[gg * outs + o];
      part[o] = v;
    }
    cluster.sync();
    // rank r finishes outputs [o_lo, o_hi): the slices' sums in rank order
    for (int o = o_lo + tid; o < o_hi; o += nthreads) {
      const int m = o / WR_BN, n = n0 + o % WR_BN;
      if (m0 + m >= M || n >= N) continue;
      float v = 0.f;
      for (int q = 0; q < S; ++q) v += *cluster.map_shared_rank(part + o, q);
      store(y + (size_t)(m0 + m) * N + n, epilogue_op<TY>(v, bias, n, epilogue));
    }
    cluster.sync();  // peers have read `part` before it is reused or freed
  }
}

// The bf16 form: the same split of K over the cluster, but each warp streams
// its own K steps (one 32-row scale block each) through a private cp.async
// ring, with no block barrier in the loop: codes [32][64] (4 lanes to a
// row's 64 bytes), their scale row and x's rows of the step. Each half step
// of 16 rows is dequantized to bf16 into the warp's B tile (code x bf16
// scale, rounded once, as the tensor-core regime), and mma.sync takes x's rows
// padded to 16 (rows past M read a zero row). The block's warps meet in
// shared memory; each block then pushes its partial sums to the block of
// the cluster that owns those outputs (distributed shared memory), and one
// cluster barrier later every block sums what it received in rank order:
// fixed orders, as in the f32 form.
constexpr int WM_COLS = 64;           // columns per block: 8 n8 tiles
constexpr int WM_WARPS = 4;           // warps of a block, each every 4th K step of the slice
constexpr int WM_STAGES = 3;          // K steps in flight per warp
constexpr int WM_CS = WM_COLS + 16;   // code row stride (bytes): 80, conflict-free rows
constexpr int WM_XS = 40;             // x row stride (bf16): 80 B, ldmatrix conflict-free
constexpr int WM_BS = WM_COLS + 8;    // B tile row stride (bf16): 144 B
constexpr int WM_MAX_ROWS = 64;       // x rows the bf16 form takes: 4 m16 tiles

// per warp and stage: codes [32][80] i8, scales [64] f32, x [M][40] bf16
__host__ __device__ constexpr int wm_stage_bytes(int m) { return 32 * WM_CS + WM_COLS * 4 + m * WM_XS * 2; }
// a warp's ring and its B tile of half a step [16][72] bf16
__host__ __device__ constexpr int wm_warp_bytes(int m) { return WM_STAGES * wm_stage_bytes(m) + 16 * WM_BS * 2; }
__host__ __device__ constexpr int wm_chunk(int m, int slices) { return (m * WM_COLS + slices - 1) / slices; }
// the partial sums a block receives, [slices][chunk] f32 (at most M*64 + 7)
__host__ __device__ constexpr int wm_recv_bytes(int m) { return (m * WM_COLS + WR_MAX_SLICES + 3) / 4 * 16; }
// the warps' rings, the partial sums received, a zero x row
__host__ __device__ constexpr int wm_smem_bytes(int m) {
  return WM_WARPS * wm_warp_bytes(m) + wm_recv_bytes(m) + WM_XS * 2;
}

template <int MT, typename TY>
__device__ __forceinline__ void weight_read_mma(const __nv_bfloat16* __restrict__ x,
                                                const int8_t* __restrict__ qw,
                                                const float* __restrict__ scales,
                                                const float* __restrict__ bias, TY* __restrict__ y,
                                                int M, int K, int N, int epilogue) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nb = K / 32;
  const int kb0 = rank * nb / S;
  const int nkb = (rank + 1) * nb / S - kb0;
  const int n0 = blockIdx.x * WM_COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool n16 = (N % 16) == 0;
  const int outs = M * WM_COLS, chunk = wm_chunk(M, S);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* mine = smem + warp * wm_warp_bytes(M);
  __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(mine + WM_STAGES * wm_stage_bytes(M));  // [16][WM_BS]
  float* recv = reinterpret_cast<float*>(smem + WM_WARPS * wm_warp_bytes(M));  // [S][chunk]
  __nv_bfloat16* zero =
      reinterpret_cast<__nv_bfloat16*>(smem + WM_WARPS * wm_warp_bytes(M) + wm_recv_bytes(M));  // [WM_XS]
  if (threadIdx.x < WM_XS / 2) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  // a block may write to a peer's shared memory only once the peer runs:
  // arrive now, wait before the first push
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  auto codes = [&](int st) { return reinterpret_cast<int8_t*>(mine + st * wm_stage_bytes(M)); };
  auto scl = [&](int st) { return reinterpret_cast<float*>(codes(st) + 32 * WM_CS); };
  auto xs = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(scl(st) + WM_COLS); };

  // this warp's steps: the slice's scale blocks warp, warp + 4, ...
  const int my_steps = warp < nkb ? (nkb - warp + WM_WARPS - 1) / WM_WARPS : 0;
  auto load = [&](int i, int st) {
    const int k = (kb0 + warp + i * WM_WARPS) * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // 32 rows x 4 chunks; 4 lanes cover a row's 64 bytes
      const int r = (lane >> 2) + 8 * j, c = (lane & 3) * 16;
      load_codes16(codes(st) + r * WM_CS + c, qw + (size_t)(k + r) * N, n0 + c, N, n16);
    }
    if (lane < WM_COLS / 4) {
      const bool ok = n0 + lane * 4 < N;
      cp_async16(scl(st) + lane * 4, ok ? scales + (size_t)(k / 32) * N + n0 + lane * 4 : scales, ok ? 16 : 0);
    }
    for (int i2 = lane; i2 < M * 4; i2 += 32) {
      const int r = i2 >> 2, c = (i2 & 3) * 8;
      cp_async16(xs(st) + r * WM_XS + c, x + (size_t)r * K + k + c, 16);
    }
  };

  float acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < WM_STAGES - 1; ++st) {
    if (st < my_steps) load(st, st);
    cp_async_commit();
  }
  __syncthreads();  // the zero row
  for (int i = 0; i < my_steps; ++i) {
    const int st = i % WM_STAGES;
    cp_async_wait<WM_STAGES - 2>();
    if (lane < WM_COLS / 4) round_scales4(scl(st) + lane * 4);  // the four this lane staged
    __syncwarp();
    if (i + WM_STAGES - 1 < my_steps) load(i + WM_STAGES - 1, (i + WM_STAGES - 1) % WM_STAGES);
    cp_async_commit();
    const __nv_bfloat16* xst = xs(st);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      {  // dequantize rows 16h .. 16h+15, 32 codes a lane: bf16(code x bf16 scale)
        const int r = lane & 15, c0 = (lane >> 4) * 32;
        const uint4* q = reinterpret_cast<const uint4*>(codes(st) + (16 * h + r) * WM_CS + c0);
        const float4* sc = reinterpret_cast<const float4*>(scl(st) + c0);
        uint4* dst = reinterpret_cast<uint4*>(bt + r * WM_BS + c0);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint4 w = q[c];
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          uint32_t out[8];
#pragma unroll
          for (int hh = 0; hh < 4; ++hh) {
            float f[4];
            codes_to_float4(words[hh], f);
            const float4 s4 = sc[c * 4 + hh];
            out[2 * hh] = pack_bf16(f[0] * s4.x, f[1] * s4.y);
            out[2 * hh + 1] = pack_bf16(f[2] * s4.z, f[3] * s4.w);
          }
          dst[2 * c] = make_uint4(out[0], out[1], out[2], out[3]);
          dst[2 * c + 1] = make_uint4(out[4], out[5], out[6], out[7]);
        }
      }
      __syncwarp();
      uint32_t a[MT][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + (lane & 15);
        const int c = 16 * h + (lane >> 4) * 8;
        ldmatrix_x4(a[mt], r < M ? xst + r * WM_XS + c : zero + c);
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t t[4];
        const int mat = lane >> 3;
        ldmatrix_x4_trans(t, bt + ((mat & 1) * 8 + (lane & 7)) * WM_BS + j * 8 + (mat >> 1) * 8);
        b[j][0] = t[0], b[j][1] = t[1], b[j + 1][0] = t[2], b[j + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[mt][j], a[mt], b[j]);
      __syncwarp();  // the B tile is read before the next half refills it
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // each warp's sums into its own (now idle) ring, rows below M
  float* part = reinterpret_cast<float*>(mine);  // [M][64]
  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + gr + h * 8;
        if (m < M)
          *reinterpret_cast<float2*>(part + m * WM_COLS + j * 8 + gc) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
  __syncthreads();
  if (S > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // the block's sum over its warps, in order, pushed to the output's owner
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < WM_WARPS && w < nkb; ++w)
      v += reinterpret_cast<const float*>(smem + w * wm_warp_bytes(M))[o];
    const int owner = o / chunk;
    float* dst = recv + rank * chunk + (o - owner * chunk);
    if (S == 1) *dst = v;
    else *cluster.map_shared_rank(dst, owner) = v;
  }
  if (S == 1) __syncthreads();
  else cluster.sync();  // every push has landed; no block touches another's memory after this
  const int o_lo = rank * chunk, o_hi = min(outs, o_lo + chunk);
  for (int o = o_lo + threadIdx.x; o < o_hi; o += blockDim.x) {
    const int m = o / WM_COLS, n = n0 + o % WM_COLS;
    if (n >= N) continue;
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += recv[q * chunk + (o - o_lo)];
    store(y + (size_t)m * N + n, epilogue_op<TY>(v, bias, n, epilogue));
  }
}

// ---- (b) tensor-core regime -----------------------------------------------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_STAGES = 4, TC_THREADS = 256;
constexpr int TC_AS = TC_BK + 8;  // x tile row stride (bf16): 80 B, ldmatrix conflict-free
constexpr int TC_BS = TC_BN + 8;  // B tile row stride (bf16): 272 B

struct TcSmem {
  __nv_bfloat16 a[TC_STAGES][TC_BM][TC_AS];
  int8_t c[TC_STAGES][TC_BK][TC_BN];
  float s[TC_STAGES][TC_BN];
  __nv_bfloat16 b[2][TC_BK][TC_BS];  // dequantized codes: the step in the mma, the next one
};

template <typename TY>
__device__ __forceinline__ void tensor_core(const __nv_bfloat16* __restrict__ x,
                                            const int8_t* __restrict__ qw,
                                            const float* __restrict__ scales,
                                            const float* __restrict__ bias, TY* __restrict__ y,
                                            int M, int K, int N, int epilogue) {
  extern __shared__ __align__(16) unsigned char smem[];
  TcSmem& sm = *reinterpret_cast<TcSmem*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int kt_n = K / TC_BK;
  const bool n16 = (N % 16) == 0;

  auto load = [&](int kt, int st) {
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int i = tid; i < TC_BM * TC_BK / 8; i += TC_THREADS) {  // x: 4 chunks of 8 a row
      const int r = i >> 2, c = (i & 3) * 8;
      const bool ok = m0 + r < M;
      cp_async16(&sm.a[st][r][c], ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok ? 16 : 0);
    }
    {  // codes: 8 chunks of 16 a row
      const int r = tid >> 3, c = (tid & 7) * 16;
      load_codes16(&sm.c[st][r][c], qw + (size_t)(k0 + r) * N, n0 + c, N, n16);
    }
    if (tid < TC_BN / 4) {  // this K step's scale row
      const bool ok = n0 + tid * 4 < N;
      cp_async16(&sm.s[st][tid * 4], ok ? scales + (size_t)(k0 / 32) * N + n0 + tid * 4 : scales,
                 ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < kt_n) load(st, st);
    cp_async_commit();
  }
  // dequantize a step's codes into B tile `buf`: 16 codes a thread, bf16(code x bf16 scale)
  auto dequantize = [&](int st, int buf) {
    const int r = tid >> 3, c = (tid & 7) * 16;
    const uint4 q = *reinterpret_cast<const uint4*>(&sm.c[st][r][c]);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    uint32_t out[8];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float f[4];
      codes_to_float4(words[w], f);
      const float4 sc = *reinterpret_cast<const float4*>(&sm.s[st][c + 4 * w]);
      out[2 * w] = pack_bf16(f[0] * sc.x, f[1] * sc.y);
      out[2 * w + 1] = pack_bf16(f[2] * sc.z, f[3] * sc.w);
    }
    uint4* dst = reinterpret_cast<uint4*>(&sm.b[buf][r][c]);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  };
  cp_async_wait<TC_STAGES - 2>();
  if (tid < TC_BN / 4 && kt_n > 0) round_scales4(&sm.s[0][tid * 4]);  // the four this thread staged
  __syncthreads();
  if (kt_n > 0) dequantize(0, 0);
  // one barrier a step: after it, step kt's B tile and step kt+1's codes
  // are in place; the step dequantizes kt+1 while its mma runs on kt
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % TC_STAGES;
    cp_async_wait<TC_STAGES - 3>();
    // step kt+1's scale row has landed; its dequantize follows the barrier
    if (tid < TC_BN / 4 && kt + 1 < kt_n) round_scales4(&sm.s[(kt + 1) % TC_STAGES][tid * 4]);
    __syncthreads();
    if (kt + TC_STAGES - 1 < kt_n) load(kt + TC_STAGES - 1, (kt + TC_STAGES - 1) % TC_STAGES);
    cp_async_commit();
    if (kt + 1 < kt_n) dequantize((kt + 1) % TC_STAGES, (kt + 1) & 1);
    const int buf = kt & 1;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], &sm.a[st][wm * 64 + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t t[4];
        const int mat = lane >> 3;
        ldmatrix_x4_trans(t, &sm.b[buf][kk + (mat & 1) * 8 + (lane & 7)][wn * 32 + j * 8 + (mat >> 1) * 8]);
        b[j][0] = t[0], b[j][1] = t[1], b[j + 1][0] = t[2], b[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + gc;
      if (n >= N) continue;  // N is even: n + 1 < N with n
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + gr + h * 8;
        if (m >= M) continue;
        store2(y + (size_t)m * N + n, epilogue_op<TY>(acc[i][j][2 * h], bias, n, epilogue),
               epilogue_op<TY>(acc[i][j][2 * h + 1], bias, n + 1, epilogue));
      }
    }
}

// ---- the kernel: both regimes as instances of one template ---------------

template <int REGIME, int MG, typename TX, typename TY>
__global__ void __launch_bounds__(REGIME == 1                          ? TC_THREADS
                                  : std::is_same<TX, float>::value ? WR_LANES * WR_KB_MAX
                                                                   : WM_WARPS * 32)
q4_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ qw,
                 const float* __restrict__ scales, const float* __restrict__ bias,
                 TY* __restrict__ y, int M, int K, int N, int epilogue) {
  // REGIME 0, weight read: f32 x in f32 on CUDA cores (MG rows of x a
  // pass), bf16 x on tensor cores (MG m16 tiles); REGIME 1: tiled tensor cores
  if constexpr (REGIME == 0 && std::is_same<TX, float>::value) {
    weight_read<MG, TX, TY>(x, qw, scales, bias, y, M, K, N, epilogue);
  } else if constexpr (REGIME == 0) {
    weight_read_mma<MG, TY>(x, qw, scales, bias, y, M, K, N, epilogue);
  } else {
    tensor_core<TY>(x, qw, scales, bias, y, M, K, N, epilogue);
  }
}

// Raises a kernel's shared-memory cap; each caller keeps the result in a
// static of its own instance, so it runs once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename TX, typename TY>
int launch(void (*kernel)(const TX*, const int8_t*, const float*, const float*, TY*, int, int, int, int),
           dim3 grid, dim3 block, unsigned cluster_y, int smem, cudaStream_t stream, const void* x,
           const int8_t* qw, const float* s, const float* b, void* y, int M, int K, int N,
           int epilogue) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster_y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TX*>(x), qw, s, b, static_cast<TY*>(y), M,
                           K, N, epilogue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MG, typename TX, typename TY>
int launch_weight_read(const void* x, const int8_t* qw, const float* s, const float* b, void* y,
                       int M, int K, int N, int epilogue, cudaStream_t stream) {
  const int nb = K / 32;
  const int slices = nb < WR_MAX_SLICES ? nb : WR_MAX_SLICES;
  const int kbm = (nb + slices - 1) / slices;
  if (kbm > WR_KB_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t smem_err = allow_smem(q4_matmul_kernel<0, MG, TX, TY>, wr_smem_bytes(WR_KB_MAX, MG));
  if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
  return launch<TX, TY>(q4_matmul_kernel<0, MG, TX, TY>, dim3((N + WR_BN - 1) / WR_BN, slices),
                        dim3(WR_LANES * kbm), slices, wr_smem_bytes(kbm, MG), stream, x, qw, s, b,
                        y, M, K, N, epilogue);
}

template <int MT, typename TY>
int launch_weight_read_mma(const void* x, const int8_t* qw, const float* s, const float* b, void* y,
                           int M, int K, int N, int epilogue, cudaStream_t stream) {
  // K slices: enough blocks for two a streaming multiprocessor, at most 8
  constexpr int kTargetBlocks = 2 * 132;
  const int nb = K / 32, tiles = (N + WM_COLS - 1) / WM_COLS;
  int slices = (kTargetBlocks + tiles - 1) / tiles;
  slices = slices < WR_MAX_SLICES ? slices : WR_MAX_SLICES;
  slices = slices < nb ? slices : nb;
  static const cudaError_t smem_err =
      allow_smem(q4_matmul_kernel<0, MT, __nv_bfloat16, TY>, wm_smem_bytes(16 * MT));
  if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
  return launch<__nv_bfloat16, TY>(q4_matmul_kernel<0, MT, __nv_bfloat16, TY>, dim3(tiles, slices),
                                   dim3(WM_WARPS * 32), slices, wm_smem_bytes(M), stream, x, qw,
                                   s, b, y, M, K, N, epilogue);
}

template <typename TX, typename TY>
int dispatch(int regime, const void* x, const int8_t* qw, const float* s, const float* b, void* y,
             int M, int K, int N, int epilogue, cudaStream_t stream) {
  if (regime == 1) {
    if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
      static const cudaError_t smem_err = allow_smem(q4_matmul_kernel<1, 1, TX, TY>, sizeof(TcSmem));
      if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
      return launch<TX, TY>(q4_matmul_kernel<1, 1, TX, TY>,
                            dim3((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM), dim3(TC_THREADS),
                            1, static_cast<int>(sizeof(TcSmem)), stream, x, qw, s, b, y, M, K, N,
                            epilogue);
    }
    return static_cast<int>(cudaErrorInvalidValue);  // f32 x never takes tensor cores
  }
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (M > WM_MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
    if (M > 48) return launch_weight_read_mma<4, TY>(x, qw, s, b, y, M, K, N, epilogue, stream);
    if (M > 32) return launch_weight_read_mma<3, TY>(x, qw, s, b, y, M, K, N, epilogue, stream);
    if (M > 16) return launch_weight_read_mma<2, TY>(x, qw, s, b, y, M, K, N, epilogue, stream);
    return launch_weight_read_mma<1, TY>(x, qw, s, b, y, M, K, N, epilogue, stream);
  } else {
    // f32 x: rows of x per pass over the shared weight slice
    if (M > 4) return launch_weight_read<8, TX, TY>(x, qw, s, b, y, M, K, N, epilogue, stream);
    if (M > 2) return launch_weight_read<4, TX, TY>(x, qw, s, b, y, M, K, N, epilogue, stream);
    if (M > 1) return launch_weight_read<2, TX, TY>(x, qw, s, b, y, M, K, N, epilogue, stream);
    return launch_weight_read<1, TX, TY>(x, qw, s, b, y, M, K, N, epilogue, stream);
  }
}

}  // namespace

// The regime q4_matmul takes: 1 (tensor cores) for bf16 x of at least
// MMA_MIN_ROWS rows, else 0 (weight read).
extern "C" int q4_matmul_regime(int M, int x_bf16) { return x_bf16 && M >= MMA_MIN_ROWS ? 1 : 0; }

// q4_matmul in the given regime, whatever M (for timing the two against
// each other); regime 1 needs bf16 x.
extern "C" int q4_matmul_in_regime(int regime, const void* x, int x_bf16, const void* qw,
                                   const void* scales, const void* bias, void* y, int y_bf16,
                                   int M, int K, int N, int epilogue, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scales);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && y_bf16) return dispatch<__nv_bfloat16, __nv_bfloat16>(regime, x, w, s, b, y, M, K, N, epilogue, st);
  if (x_bf16) return dispatch<__nv_bfloat16, float>(regime, x, w, s, b, y, M, K, N, epilogue, st);
  if (y_bf16) return dispatch<float, __nv_bfloat16>(regime, x, w, s, b, y, M, K, N, epilogue, st);
  return dispatch<float, float>(regime, x, w, s, b, y, M, K, N, epilogue, st);
}

// x: [M, K] f32 or bf16 (x_bf16); qw: int8 [K, N]; scales: f32 [K/32, N];
// bias: f32 [N] (read when epilogue >= 1); y: [M, N] f32 or bf16 (y_bf16).
// epilogue: 0 none, 1 +bias, 2 +bias then tanh-GELU, 3 +bias then erf-GELU.
// Needs K % 32 == 0, N % 4 == 0, 16-byte aligned x, qw and scales, and
// for f32 x K <= 8192 (8 slices of at most 1024 rows; cudaErrorInvalidValue
// beyond). One launch on `stream`. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int q4_matmul(const void* x, int x_bf16, const void* qw, const void* scales,
                         const void* bias, void* y, int y_bf16, int M, int K, int N,
                         int epilogue, void* stream) {
  return q4_matmul_in_regime(q4_matmul_regime(M, x_bf16), x, x_bf16, qw, scales, bias, y, y_bf16,
                             M, K, N, epilogue, stream);
}
