// Kernels D and D'. Kernel D: non-causal whole-sequence attention for the
// encoder, on the packed [B, T, D] layout with 64-wide heads as slices of
// D. Keys at `valid` and above are masked (the encoder pads T to a
// multiple of 128 once for its whole layer stack); rows at `valid` and
// above are computed like the others and discarded by the caller.
//
// Replaces whisper_burn_tpu/ops/pallas_encoder_attention.py:_packed_kernel
// (reached through flash_prefill.prefill_attention). The TPU kernel holds a
// whole [T, T] score block in VMEM; this one never materializes scores.
// Bound on the H100: operations (4 * T * valid * 64 per head and stream,
// about 97 GFLOP per Large-V3 layer at B=8), since q/k/v are read once.
// Design: a flash loop with online softmax. One block per (128-query tile,
// head, stream), one thread per query row holding q and the running output
// in registers; 64-key tiles of K and V are staged in shared memory as f32
// and read as broadcasts (every thread reads the same key), 16 keys per
// softmax rescale. Simple and exact in f32 accumulation; tensor cores are
// later work.
//
// Kernel D', encoder_attention_heads, replaces the head-blocked
// whisper_burn_tpu/ops/pallas_encoder_attention.py:_kernel (K10, reached
// only through that module's encoder_attention op: no model path calls
// it). The same attention on the TPU kernel's layout: q and k head-major
// [B, H, Tp, 64], v and the output transposed [B, H, 64, Tp], Tp a
// multiple of 128, keys at `valid` and above masked. Bound and design:
// those of kernel D, whose flash loop (encoder_attn) it shares through the
// HEADS layout parameter. The transposed values are staged into shared
// memory with consecutive threads on consecutive keys (coalesced reads)
// into rows padded by 4 floats (a 4-way bank conflict instead of 32-way);
// the output rows are written with consecutive threads on consecutive
// queries.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int BQ = 128;  // queries per block, one per thread
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int SUB = 16;  // keys per online-softmax update

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// HEADS = false: q, k, v, out packed [B, T, D], head h at channels
// h * 64 ..; HEADS = true: q, k [B, H, T, 64], v and out [B, H, 64, T]
template <typename T, bool HEADS>
__device__ void encoder_attn(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, int Tn, int D,
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
    qv[c] = q_ok ? to_f(q[qk_at(qi, c)]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  for (int t0 = 0; t0 < valid; t0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * DH; e += BQ) {
      int r = e / DH, c = e % DH;
      ks[r][c] = t0 + r < valid ? to_f(k[qk_at(t0 + r, c)]) : 0.f;
      if (HEADS) r = e % BK, c = e / BK;  // transposed values: consecutive keys
      vs[r][c] = t0 + r < valid ? to_f(v[v_at(t0 + r, c)]) : 0.f;
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
    for (int c = 0; c < DH; ++c) store(out + v_at(qi, c), acc[c] * inv);
  }
}

template <typename T>
__global__ void __launch_bounds__(BQ)
encoder_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, int Tn, int D, int valid) {
  encoder_attn<T, false>(q, k, v, out, Tn, D, valid);
}

template <typename T>
__global__ void __launch_bounds__(BQ)
encoder_heads_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int Tn, int D, int valid) {
  encoder_attn<T, true>(q, k, v, out, Tn, D, valid);
}

template <bool HEADS, typename T>
void launch_typed(const void* q, const void* k, const void* v, void* out, int Tn, int D, int valid,
                  dim3 grid, cudaStream_t st) {
  auto kernel = HEADS ? encoder_heads_kernel<T> : encoder_attn_kernel<T>;
  kernel<<<grid, BQ, 0, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), static_cast<T*>(out), Tn, D, valid);
}

template <bool HEADS>
int launch(const void* q, const void* k, const void* v, void* out, int bf16, int B, int T, int D,
           int H, int valid, void* stream) {
  dim3 grid((T + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_typed<HEADS, __nv_bfloat16>(q, k, v, out, T, D, valid, grid, st);
  } else {
    launch_typed<HEADS, float>(q, k, v, out, T, D, valid, grid, st);
  }
  return static_cast<int>(cudaGetLastError());
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
// contiguous; D = H * 64; keys t >= valid masked (1 <= valid <= T).
extern "C" int encoder_attention_heads(const void* q, const void* k, const void* v, void* out,
                                       int bf16, int B, int T, int D, int H, int valid,
                                       void* stream) {
  return launch<true>(q, k, v, out, bf16, B, T, D, H, valid, stream);
}
