// Kernel F: write_cache_slot, cache[:, :, pos, :] = new[:, :, 0, :] in place.
//
// Replaces whisper_burn_tpu/ops/pallas_cache.py:_kernel (via
// write_cache_slot): the deferred self-cache write of a decode step, one
// token position across all layers and streams. The TPU kernel reads and
// rewrites the whole 8-row tile holding `pos` because Mosaic cannot store a
// single sublane row; here only the row `pos` of every (layer, stream) is
// written. Bound: the bytes moved, `new` read once and the rows written
// once (2 * L * B * row bytes, memory). Design: one thread per 16 bytes
// (one uint4 load and store) when the row width and both base pointers
// allow it, else one thread per byte; consecutive threads on consecutive
// bytes of a row, so each row is one coalesced run. Any element size: the
// kernel moves bytes. `pos` is one int32 in device memory that each thread
// reads (the decode loop keeps the position on the card, and a captured
// CUDA graph replays fixed arguments); a position outside [0, T) writes
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename V>
__global__ void __launch_bounds__(THREADS)
slot_kernel(V* __restrict__ cache, const V* __restrict__ src, int rows, int T,
            const int* __restrict__ pos_at, int nvec) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int pos = *pos_at;
  if (i >= (size_t)rows * nvec || pos < 0 || pos >= T) return;
  const size_t r = i / nvec, j = i % nvec;
  cache[(r * T + pos) * nvec + j] = src[r * nvec + j];
}

template <typename V>
int launch(void* cache, const void* src, int rows, int T, const int* pos, int nvec, cudaStream_t st) {
  const size_t n = (size_t)rows * nvec;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if (blocks) {
    slot_kernel<V><<<blocks, THREADS, 0, st>>>(static_cast<V*>(cache), static_cast<const V*>(src),
                                               rows, T, pos, nvec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cache: [rows, T, row_bytes] bytes (rows = L * B); src: [rows, row_bytes];
// pos: one int32 in device memory, 0 <= *pos < T. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int write_cache_slot(void* cache, const void* src, int rows, int T, const int* pos,
                                int row_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) return launch<uint4>(cache, src, rows, T, pos, row_bytes / 16, st);
  return launch<uint8_t>(cache, src, rows, T, pos, row_bytes, st);
}
