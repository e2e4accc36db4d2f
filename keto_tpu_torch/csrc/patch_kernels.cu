// Write-path kernel for Hopper (sm_90a): the device slot set.
//
// Replaces the XLA scatters `.at[rows, cols].set(vals)` of
//   K9 keto_tpu/check/tpu_engine.py:2542 `_apply_ell_patch` (bucket slots of
//      deleted or restored iterated edges),
//      keto_tpu/check/tpu_engine.py:2665 `_apply_overlay_delta` (the resident
//      [K, C] overlay gather matrix and its [K] dst vector),
//      keto_tpu/graph/label_build.py:433-446 `_Mirror.flush_device` (the
//      label build's device label rows),
//      keto_tpu/list/tpu_engine.py:337 (the list layouts' bucket slots)
//   -> keto_slot_set.
// The Python side lives in keto_tpu_torch/check/kernels.py (`slot_set_many`,
// `slot_set_plan`): it keeps the last entry per slot, in slot order, checks
// every entry against its target before anything is uploaded (an
// out-of-range entry raises there, every target untouched), and builds the
// one buffer this kernel reads.
//
// One launch a call, over every target of the call. The buffer holds
//   desc int64 [n_targets][6]: out, src (0 in place), words of the target,
//        its entries [first, end) and its first block;
//   keys int32 [n_entries]: each entry's word in its target, ascending
//        within a target; vals int32 [n_entries].
// A functional target (src != 0) gets a block for each `tile` of its words:
// the block copies its words from src into out, 16 bytes a thread where
// both are 16-byte aligned, waits on __syncthreads, then writes the entries
// that fall in its words (warp 0 finds them in the sorted keys with two
// 32-way searches). No two blocks touch one word, so the copy and the patch
// need no ordering across blocks and one launch replaces clone() plus a
// scatter. An in-place target gets a block for each `tile` of its entries.
// Warp 0 of each block finds its target among the descriptors (their first
// blocks ascend). A key outside the target is dropped, as a guard: the
// host has refused such entries.
//
// Bound: bytes. A functional target is read and written once, every entry
// read once and written once. At the engine's sizes (a few to a few
// thousand entries, targets up to a few MB) a launch's latency is larger,
// so the design's aim is one launch and no host read a call, with the
// least host work: the host sends the descriptors and the entries, the
// block table is worked out here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The first index in [lo, hi) whose key is >= x (hi when none), by one
// warp: 32 evenly spaced probes narrow the range 32-fold a round.
__device__ int32_t lower_bound_warp(const int32_t* __restrict__ keys, int32_t lo, int32_t hi,
                                    int64_t x, int lane) {
  while (hi - lo > 32) {
    const int32_t step = (hi - lo + 31) / 32;
    const int32_t p = lo + lane * step;
    const int c = __popc(__ballot_sync(kFull, p < hi && keys[p] < x));
    if (c == 0) return lo;
    const int32_t next_hi = lo + c * step;
    lo = lo + (c - 1) * step + 1;
    hi = next_hi < hi ? next_hi : hi;
  }
  return lo + __popc(__ballot_sync(kFull, lo + lane < hi && keys[lo + lane] < x));
}

__global__ void __launch_bounds__(kThreads)
slot_set_kernel(const int64_t* __restrict__ desc, int32_t n_targets,
                const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
                int32_t tile) {
  __shared__ int32_t s_t, s_lo, s_hi;
  const int64_t b = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int32_t t = -1;  // the last target whose first block is <= b
    for (int32_t t0 = 0; t0 < n_targets; t0 += 32) {
      const int32_t i = t0 + lane;
      t += __popc(__ballot_sync(kFull, i < n_targets && desc[6 * i + 5] <= b));
    }
    const int64_t* d = desc + 6 * t;
    const int64_t j = b - d[5];
    const int32_t e0 = static_cast<int32_t>(d[3]), e1 = static_cast<int32_t>(d[4]);
    int32_t lo, hi;
    if (d[1] != 0) {
      lo = lower_bound_warp(keys, e0, e1, j * tile, lane);
      hi = lower_bound_warp(keys, lo, e1, (j + 1) * tile, lane);
    } else {
      const int64_t first = e0 + j * tile;
      lo = static_cast<int32_t>(first);
      hi = static_cast<int32_t>(first + tile < e1 ? first + tile : e1);
    }
    if (lane == 0) {
      s_t = t;
      s_lo = lo;
      s_hi = hi;
    }
  }
  __syncthreads();
  const int64_t* d = desc + 6 * s_t;
  int32_t* out = reinterpret_cast<int32_t*>(d[0]);
  const int32_t* src = reinterpret_cast<const int32_t*>(d[1]);
  const int64_t words = d[2];
  if (src != nullptr) {
    const int64_t start = (b - d[5]) * tile;
    const int64_t end = start + tile < words ? start + tile : words;
    int64_t i = start;
    if (((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
      const int64_t vend = start + ((end - start) & ~int64_t{3});  // start is a multiple of 4
      for (int64_t w = start + 4 * threadIdx.x; w < vend; w += 4 * blockDim.x)
        *reinterpret_cast<int4*>(out + w) = *reinterpret_cast<const int4*>(src + w);
      i = vend;
    }
    for (int64_t w = i + threadIdx.x; w < end; w += blockDim.x) out[w] = src[w];
    __syncthreads();  // the copy lands before the entries overwrite it
  }
  for (int32_t e = s_lo + threadIdx.x; e < s_hi; e += blockDim.x) {
    const int32_t k = keys[e];
    if (k >= 0 && k < words) out[k] = vals[e];
  }
}

}  // namespace

// Plain C entry point (ctypes). Launches on `stream` and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
extern "C" int keto_slot_set(const int32_t* plan, int32_t n_targets, int32_t n_blocks,
                             int64_t n_entries, int32_t tile, void* stream) {
  if (n_targets < 1 || tile < 4 || (tile & 3)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* desc = reinterpret_cast<const int64_t*>(plan);
  const int32_t* keys = plan + 12 * static_cast<int64_t>(n_targets);
  if (n_blocks > 0) {
    slot_set_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        desc, n_targets, keys, keys + n_entries, tile);
  }
  return static_cast<int>(cudaGetLastError());
}
