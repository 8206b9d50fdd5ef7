// Kernel J: the LayerNorm, optionally with the residual add before it, in
// one pass over the rows.
//
// Replaces no TPU kernel: the JAX package leaves its LayerNorm
// (whisper_burn_tpu/models/layers.py:layer_norm) to XLA, which fuses it.
// The port's plain version (ops/layer_norm.py:layer_norm_plain) is eleven
// PyTorch launches a call, six of them passes over the rows in f32; the
// model step calls it twice an encoder layer, three times a decoder layer
// and once before the logits, in the prompt and in every decode step.
//
// Computes, for each row of x [rows, D] (bf16 or f32):
//   s    = x + r                    (with a residual r; rounded to x's dtype)
//   mean = sum(s) / D               (f32)
//   c    = s - mean
//   var  = sum(c * c) / D           (the two-pass variance, not Welford)
//   y    = (c * rsqrt(var + eps)) * g + b, rounded once to x's dtype
// with every product and sum rounded on its own (no FMA contraction), as
// the plain version's separate launches round them; g and b are f32 [D].
// Only the order of the two row sums differs from the plain version's.
// With the residual it writes s as well, so the block's add and the next
// norm are one launch.
//
// Bound: memory. Each row is read once and written once (twice with the
// residual: x and r read, s and y written): 2 * rows * D * bytes, 4x with
// the residual (126 MB each way at 49,152 rows of Large-V3's 1280 bf16,
// 75 µs; 150 µs with the residual). At the decode step's 8-40 rows the
// launch is the time. Design: one warp per row, the row held in registers
// between the two reductions (VPL 16-byte vectors a lane, loaded all at
// once), sums by warp shuffles, WARPS rows a block and the grid sized to
// the rows, so one form serves 32 rows and 49,152. Rows may be strided
// (an outer and an inner row stride; the last dim contiguous), so the
// encoder's final norm over x[:, :1500] reads its rows in place. No
// synchronisation and no allocation, so a CUDA graph captures it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // rows a block
constexpr int THREADS = 32 * WARPS;

struct Args {
  const void* x;
  const void* r;  // null: no residual
  void* s;        // [rows, D], the sum (with a residual)
  void* y;        // [rows, D]
  const float* g;
  const float* b;
  int rows, inner, D;
  long long x_outer, x_inner, r_outer, r_inner;  // row strides in elements
  float eps;
};

// a 16-byte vector of E elements of T, unpacked to and packed from f32
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int E = 4;
  __device__ static void unpack(uint4 w, float* f) {
    f[0] = __uint_as_float(w.x), f[1] = __uint_as_float(w.y), f[2] = __uint_as_float(w.z), f[3] = __uint_as_float(w.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(uint4 w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) f[2 * q] = __uint_as_float(u[q] << 16), f[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
  }
  __device__ static uint32_t bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(bits(f[0]) | bits(f[1]) << 16, bits(f[2]) | bits(f[3]) << 16, bits(f[4]) | bits(f[5]) << 16,
                      bits(f[6]) | bits(f[7]) << 16);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int VPL, bool RES>
__global__ void __launch_bounds__(THREADS) layer_norm_kernel(Args a) {
  using P = Pack<T>;
  constexpr int E = P::E;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= a.rows) return;
  const int nv = a.D / E;  // vectors a row
  const long long o = row / a.inner, i = row % a.inner;
  const uint4* xr = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + o * a.x_outer + i * a.x_inner);

  uint4 in[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k)
    if (lane + 32 * k < nv) in[k] = xr[lane + 32 * k];
  if constexpr (RES) {
    const uint4* rr =
        reinterpret_cast<const uint4*>(static_cast<const T*>(a.r) + o * a.r_outer + i * a.r_inner);
    uint4* sr = reinterpret_cast<uint4*>(static_cast<T*>(a.s) + static_cast<long long>(row) * a.D);
    uint4 res[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (lane + 32 * k < nv) res[k] = rr[lane + 32 * k];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k >= nv) continue;
      float xs[E], rv[E];
      P::unpack(in[k], xs);
      P::unpack(res[k], rv);
#pragma unroll
      for (int e = 0; e < E; ++e) xs[e] = __fadd_rn(xs[e], rv[e]);
      in[k] = P::pack(xs);  // s rounded to T, as PyTorch's add rounds it
      sr[lane + 32 * k] = in[k];
    }
  }

  float v[VPL][E];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (lane + 32 * k < nv) {
      P::unpack(in[k], v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[k][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, v[k][e]);
  }
  const float inv_d = 1.0f / static_cast<float>(a.D);
  const float mean = __fmul_rn(warp_sum(sum), inv_d);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[k][e] = __fsub_rn(v[k][e], mean);
      if (lane + 32 * k < nv) sq = __fadd_rn(sq, __fmul_rn(v[k][e], v[k][e]));
    }
  const float rs = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), a.eps));

  uint4* yr = reinterpret_cast<uint4*>(static_cast<T*>(a.y) + static_cast<long long>(row) * a.D);
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = lane + 32 * k;
    if (j >= nv) continue;
    const float4* g4 = reinterpret_cast<const float4*>(a.g + j * E);
    const float4* b4 = reinterpret_cast<const float4*>(a.b + j * E);
    float out[E];
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 gq = g4[q], bq = b4[q];
      const float gv[4] = {gq.x, gq.y, gq.z, gq.w}, bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) out[4 * q + u] = __fadd_rn(__fmul_rn(__fmul_rn(v[k][4 * q + u], rs), gv[u]), bv[u]);
    }
    yr[j] = P::pack(out);
  }
}

template <typename T, bool RES>
int launch(const Args& a, int vpl, cudaStream_t stream) {
  const dim3 grid((a.rows + WARPS - 1) / WARPS);
  switch (vpl) {
#define CASE(N) \
  case N: layer_norm_kernel<T, N, RES><<<grid, THREADS, 0, stream>>>(a); break;
    CASE(4) CASE(5) CASE(8) CASE(10)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the smallest instance with at least `need` vectors a lane: D 1024 and
// 1280 (Medium, Large-V3) exactly in bf16 and f32, smaller D with lanes
// idle; four instances a form keep the build short
int vectors_a_lane(int need) {
  constexpr int sizes[] = {4, 5, 8, 10};
  for (int n : sizes)
    if (n >= need) return n;
  return 0;
}

}  // namespace

// x: [outer, inner, D] rows at element strides (x_outer, x_inner), the last
// dim contiguous; r (or null) the same at (r_outer, r_inner); s (with r)
// and y contiguous [outer * inner, D]; g, b f32 [D]. dtype 0 bf16, 1 f32.
// D a multiple of 8 and every row 16-byte aligned (the wrapper checks).
extern "C" int layer_norm(const void* x, const void* r, void* s, void* y, const float* g, const float* b,
                          int outer, int inner, int D, long long x_outer, long long x_inner,
                          long long r_outer, long long r_inner, int dtype, float eps, void* stream) {
  const int elems = dtype == 0 ? 8 : 4;  // a 16-byte vector's
  const int vpl = vectors_a_lane((D / elems + 31) / 32);
  if (D <= 0 || D % 8 != 0 || vpl == 0 || inner <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, r, s, y, g, b, outer * inner, inner, D, x_outer, x_inner, r_outer, r_inner, eps};
  if (a.rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return r ? launch<__nv_bfloat16, true>(a, vpl, st) : launch<__nv_bfloat16, false>(a, vpl, st);
  return r ? launch<float, true>(a, vpl, st) : launch<float, false>(a, vpl, st);
}
