// Write-path kernel for Hopper (sm_90a): the device slot set.
//
// Replaces the XLA scatters `.at[rows, cols].set(vals)` of
//   K9 keto_tpu/check/tpu_engine.py:2542 `_apply_ell_patch` (bucket slots of
//      deleted or restored iterated edges),
//      keto_tpu/check/tpu_engine.py:2665 `_apply_overlay_delta` (the resident
//      [K, C] overlay gather matrix and its [K] dst vector),
//      keto_tpu/graph/label_build.py:433-446 `_Mirror.flush_device` (the
//      label build's device label rows)
//   -> keto_slot_set.
// The Python wrapper and the plain PyTorch version live in
// keto_tpu_torch/check/kernels.py (`slot_set`); the wrapper does the copy
// where the reference's update is functional, and keeps only the last entry
// per slot before the launch, so no two threads write one word.
//
// One thread per entry i writes buf[rows[i] * ld + cols[i]] = vals[i]. A 1-D
// target is the case ld = 1, cols = 0. An entry outside [0, n_rows) x [0, ld)
// writes nothing and sets *err, which the wrapper reads and raises on: an
// out-of-range patch is a bug in the layout, never a write to drop quietly.
//
// Bound. Each entry reads 12 bytes and writes 4: memory-bound, and at the
// engine's sizes (a few to a few thousand entries) launch-bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

__global__ void slot_set_kernel(int32_t* __restrict__ buf, int64_t ld,
                                int64_t n_rows,
                                const int32_t* __restrict__ rows,
                                const int32_t* __restrict__ cols,
                                const int32_t* __restrict__ vals, int64_t m,
                                int32_t* __restrict__ err) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = rows[i];
    const int64_t c = cols[i];
    if (r < 0 || r >= n_rows || c < 0 || c >= ld) {
      atomicOr(err, 1);
      continue;
    }
    buf[r * ld + c] = vals[i];
  }
}

}  // namespace

// Plain C entry point (ctypes). Launches on `stream` and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
extern "C" int keto_slot_set(int32_t* buf, int32_t ld, int64_t n_rows,
                             const int32_t* rows, const int32_t* cols,
                             const int32_t* vals, int64_t m, int32_t* err,
                             void* stream) {
  if (m > 0) {
    slot_set_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
        buf, ld, n_rows, rows, cols, vals, m, err);
  }
  return static_cast<int>(cudaGetLastError());
}
