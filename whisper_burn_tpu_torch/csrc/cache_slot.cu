// Kernel F: the self-cache slot writer, in two forms, both one launch a
// decode step.
//
// Replaces whisper_burn_tpu/ops/pallas_cache.py:_kernel (K9, via
// write_cache_slot): the deferred self-cache write of a decode step, one
// token position across all layers and streams. The TPU kernel reads and
// rewrites the whole 8-row tile holding `pos` because Mosaic cannot store a
// single sublane row; here only the rows that change are written.
//
// Slot form (write_cache_slots): cache[:, :, pos] = new[:, :, 0] for up to
// three (cache, new) pairs of their own row widths in one launch: the self
// K and V rows (int8, uint8 int4 pairs, bf16 or f32) and the f32 scale row
// (whose lanes the JAX package writes by dynamic_update_slice beside K9).
// Bound: `new` read once and the rows written once, 2 * rows * row bytes
// of each pair (memory; 0.05-2 µs at the decode paths' shapes, where a
// launch's fixed cost is the time). Design: the grid is sized to the bytes,
// each pair with its own blocks (at most SLOT_WAVES blocks an SM); each
// thread issues VPT vector loads of `new` (16 bytes where the row width and
// pointers allow, else the widest that divides them) before it reads `pos`,
// so the loads and the position's read are in flight together (the old
// form read `pos` first and waited two round trips).
//
// Beam form (write_cache_slots_beam): the beam step's whole self-cache
// update, the slot write fused with the gather of the streams by their
// parent beams. With X the step's cache and Y the other buffer of the pair,
// for every pair (K, V, scales):
//   Y[l, i, t]   = X[l, src[i], t]       for t < pos
//   Y[l, i, pos] = new[l, src[i], 0]
// which is K9 followed by the JAX package's jnp.take(..., src, axis=1)
// (whisper_burn_tpu/models/beam.py:222-232). Rows past pos of Y are left
// as they were: no kernel reads them (the self-attention kernels read keys
// below pos and merge the current token). Bound: the rows <= pos written
// once for every stream and read once for each distinct parent (streams of
// one parent read its rows through L2), (BW + parents) * L * (pos + 1) *
// row bytes (memory; at most 0.23 ms at Large-V3's int8 cache of 40
// streams at pos 115, all parents distinct). Design: one block per
// (layer, stream) row block of Y; it reads src[i] and pos, then copies one
// contiguous run of (pos + 1) rows of each pair, the first pos from X's
// run of stream src[i] and the last from `new`, VPT vectors in flight a
// thread (the old reorder, three index_selects, moved every row of ctx). A
// block for each pair instead (38 registers against 64, twice the blocks
// an SM) read 1-3% slower, timed in another call than this design.
//
// Both forms read `pos` (and the beam form `src`) from device memory, so a
// captured CUDA graph replays them at each step's values. A position
// outside [0, T) writes nothing. Any element size: the kernels move bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VPT = 4;         // vectors in flight a thread
constexpr int PAIRS = 3;       // K, V, scales
constexpr int SLOT_WAVES = 4;  // at most this many slot-form blocks an SM, per pair

// the widest vector (16, 8, 4, 2 or 1 bytes) that divides the row width
// and every base pointer
int vector_bytes(int rb, const void* a, const void* b, const void* c) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) | static_cast<uintptr_t>(rb);
  for (int vb = 16; vb > 1; vb /= 2)
    if (any % vb == 0) return vb;
  return 1;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// Dispatch `body.template run<V>()` on a vector width of 16, 8, 4, 2 or 1.
template <typename Body>
__device__ __forceinline__ void by_width(int vb, const Body& body) {
  switch (vb) {
    case 16: body.template run<uint4>(); break;
    case 8: body.template run<uint2>(); break;
    case 4: body.template run<uint32_t>(); break;
    case 2: body.template run<uint16_t>(); break;
    default: body.template run<uint8_t>(); break;
  }
}

// ---------------------------------------------------------------- slot form

struct SlotPair {
  char* cache;     // [rows, T, row bytes]
  const char* nw;  // [rows, row bytes]
  int vb;          // bytes a vector
  int nv;          // vectors a row
  int n;           // vectors of all rows
  int block0;      // the pair's first block
};

struct SlotArgs {
  SlotPair p[PAIRS];
  int pairs, T;
  const int* pos;
};

struct SlotBody {
  SlotPair p;
  int block, blocks, T;
  const int* pos_at;

  template <typename V>
  __device__ __forceinline__ void run() const {
    const V* src = reinterpret_cast<const V*>(p.nw);
    V* dst = reinterpret_cast<V*>(p.cache);
    for (int base = block * THREADS * VPT; base < p.n; base += blocks * THREADS * VPT) {
      V v[VPT];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int i = base + j * THREADS + threadIdx.x;
        if (i < p.n) v[j] = src[i];
      }
      const int pos = *pos_at;  // after the loads: the round trips overlap
      if (pos < 0 || pos >= T) return;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int i = base + j * THREADS + threadIdx.x;
        if (i < p.n) {
          const int r = i / p.nv;
          dst[((size_t)r * T + pos) * p.nv + (i - r * p.nv)] = v[j];
        }
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS) slot_kernel(SlotArgs a) {
  // the pair whose blocks hold this one (constant indices: no local copy)
  int k = 0;
  if (a.pairs > 1 && (int)blockIdx.x >= a.p[1].block0) k = 1;
  if (a.pairs > 2 && (int)blockIdx.x >= a.p[2].block0) k = 2;
  const SlotPair p = k == 0 ? a.p[0] : k == 1 ? a.p[1] : a.p[2];
  const int end = k + 1 < a.pairs ? (k == 0 ? a.p[1].block0 : a.p[2].block0) : (int)gridDim.x;
  by_width(p.vb, SlotBody{p, (int)blockIdx.x - p.block0, end - p.block0, a.T, a.pos});
}

// ---------------------------------------------------------------- beam form

struct BeamPair {
  char* y;         // [L, BW, T, row bytes]: the buffer written
  const char* x;   // [L, BW, T, row bytes]: the step's rows
  const char* nw;  // [L, BW, row bytes]: the slot's rows, before the gather
  int vb;          // bytes a vector
  int nv;          // vectors a row
};

struct BeamArgs {
  BeamPair p[PAIRS];
  int pairs, BW, T;
  const int* src;
  const int* pos;
};

struct BeamBody {
  BeamPair p;
  size_t to, from;  // the (layer, stream) row blocks of Y and of X / new
  int T, pos;

  template <typename V>
  __device__ __forceinline__ void run() const {
    const int n_old = pos * p.nv, n = n_old + p.nv;
    const V* x = reinterpret_cast<const V*>(p.x) + from * T * p.nv;
    const V* nw = reinterpret_cast<const V*>(p.nw) + from * p.nv;
    V* y = reinterpret_cast<V*>(p.y) + to * T * p.nv;
    for (int base = 0; base < n; base += THREADS * VPT) {
      V v[VPT];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int i = base + j * THREADS + threadIdx.x;
        if (i < n) v[j] = i < n_old ? x[i] : nw[i - n_old];
      }
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int i = base + j * THREADS + threadIdx.x;
        if (i < n) y[i] = v[j];
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS) slot_beam_kernel(BeamArgs a) {
  const int pos = *a.pos;
  if (pos < 0 || pos >= a.T) return;
  const int job = blockIdx.x, l = job / a.BW, i = job - l * a.BW;
  const size_t from = (size_t)l * a.BW + min(max(a.src[i], 0), a.BW - 1);
  by_width(a.p[0].vb, BeamBody{a.p[0], (size_t)job, from, a.T, pos});
  if (a.pairs > 1) by_width(a.p[1].vb, BeamBody{a.p[1], (size_t)job, from, a.T, pos});
  if (a.pairs > 2) by_width(a.p[2].vb, BeamBody{a.p[2], (size_t)job, from, a.T, pos});
}

}  // namespace

// Slot form. For each pair k with rb_k > 0 (pairs with rb_k == 0 are left
// out; the present ones come first): cache_k [rows, T, rb_k] bytes, new_k
// [rows, rb_k]; pos: one int32 in device memory. One launch. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int write_cache_slots(void* c0, const void* n0, int rb0, void* c1, const void* n1, int rb1,
                                 void* c2, const void* n2, int rb2, int rows, int T, const int* pos,
                                 void* stream) {
  void* caches[PAIRS] = {c0, c1, c2};
  const void* news[PAIRS] = {n0, n1, n2};
  const int rbs[PAIRS] = {rb0, rb1, rb2};
  SlotArgs a{};
  a.T = T;
  a.pos = pos;
  const int cap = SLOT_WAVES * sm_count();
  int blocks = 0;
  for (int k = 0; k < PAIRS; ++k) {
    if (rbs[k] <= 0 || rows <= 0) continue;
    SlotPair& p = a.p[a.pairs++];
    p.cache = static_cast<char*>(caches[k]);
    p.nw = static_cast<const char*>(news[k]);
    p.vb = vector_bytes(rbs[k], caches[k], news[k], news[k]);
    p.nv = rbs[k] / p.vb;
    p.n = rows * p.nv;
    p.block0 = blocks;
    const int need = (p.n + THREADS * VPT - 1) / (THREADS * VPT);
    blocks += need < cap ? need : cap;
  }
  if (blocks) slot_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Beam form. For each pair k with rb_k > 0: y_k and x_k [L, BW, T, rb_k]
// bytes (two buffers), new_k [L, BW, rb_k]; src: BW int32 in device memory,
// each stream's parent stream; pos: one int32 in device memory. One launch.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int write_cache_slots_beam(void* y0, const void* x0, const void* n0, int rb0, void* y1,
                                      const void* x1, const void* n1, int rb1, void* y2, const void* x2,
                                      const void* n2, int rb2, int L, int BW, int T, const int* src,
                                      const int* pos, void* stream) {
  void* ys[PAIRS] = {y0, y1, y2};
  const void* xs[PAIRS] = {x0, x1, x2};
  const void* news[PAIRS] = {n0, n1, n2};
  const int rbs[PAIRS] = {rb0, rb1, rb2};
  BeamArgs a{};
  a.BW = BW;
  a.T = T;
  a.src = src;
  a.pos = pos;
  for (int k = 0; k < PAIRS; ++k) {
    if (rbs[k] <= 0) continue;
    BeamPair& p = a.p[a.pairs++];
    p.y = static_cast<char*>(ys[k]);
    p.x = static_cast<const char*>(xs[k]);
    p.nw = static_cast<const char*>(news[k]);
    p.vb = vector_bytes(rbs[k], ys[k], xs[k], news[k]);
    p.nv = rbs[k] / p.vb;
  }
  if (a.pairs && L * BW > 0)
    slot_beam_kernel<<<L * BW, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
