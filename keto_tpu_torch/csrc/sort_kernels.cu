// Snapshot-build kernel for Hopper (sm_90a): the stable argsort.
//
// Replaces the XLA program of
//   K8 keto_tpu/graph/device_build.py:54 `_sort_fn.many` (:66,
//      `jnp.argsort(k, stable=True)` per key array)
//   -> keto_radix_hist, keto_radix_scan, keto_radix_scatter, driven pass by
//      pass from keto_tpu_torch/graph/sort_kernels.py (`radix_argsort`).
// The Python wrapper and the plain PyTorch version (`radix_argsort_ref`,
// the same passes in tensor code) live in keto_tpu_torch/graph/sort_kernels.py.
//
// Algorithm. A least-significant-digit radix sort of (int32 key, int32 index)
// pairs: 8-bit digits, 4 passes. Keys are read as uint32 with the sign bit
// flipped (key ^ 0x80000000), so negative keys order before positive ones as
// int32 does. Each pass runs three kernels over tiles of kTile keys:
//   1. keto_radix_hist: digit counts per tile into hist[256][n_tiles]
//      (digit-major);
//   2. keto_radix_scan: the exclusive scan of hist in digit-major order, in
//      two levels: block d scans row d in place and writes the row total to
//      totals[d]; the scatter kernel scans the 256 totals itself;
//   3. keto_radix_scatter: ranks every key stably inside its tile and writes
//      (key, index) to totals_scan[d] + hist[d][tile] + rank.
// An LSD sort is stable when every pass is: inside a tile each warp takes a
// contiguous run of kTile / 8 keys, 32 at a time in lane order; lanes holding
// the same digit find each other with __match_any_sync and rank by the
// popcount of the lower lanes; per-warp digit counts in shared memory, scanned
// in warp order, order the warps. So equal digits keep their input order.
//
// Bound. Each pass reads every key for the histogram, then every key and index
// and writes both: 20 bytes per key per pass, 80 bytes per key for the sort
// (the histogram rows, 1 KiB per tile, are small beside it). Memory-bound; the
// scatter's writes are not coalesced, which a later PR can fix by staging the
// sorted tile in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                      // keys per thread
constexpr int kTile = kThreads * kItems;        // keys per tile: 4096
constexpr int kWarpRun = kTile / kWarps;        // contiguous keys per warp
constexpr int kDigits = 256;

__device__ __forceinline__ uint32_t digit_of(int32_t key, int shift) {
  return ((static_cast<uint32_t>(key) ^ 0x80000000u) >> shift) & 0xFFu;
}

// hist[d * n_tiles + tile] = number of keys of the tile with digit d.
__global__ void radix_hist_kernel(const int32_t* __restrict__ keys, int64_t n,
                                  int shift, int64_t n_tiles,
                                  int32_t* __restrict__ hist) {
  __shared__ int32_t s_hist[kDigits];
  const int64_t tile = blockIdx.x;
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = tile * kTile;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int64_t i = base + j;
    if (i < n) atomicAdd(&s_hist[digit_of(keys[i], shift)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * n_tiles + tile] = s_hist[threadIdx.x];
}

// Inclusive scan of one value per thread over the block (kThreads threads).
__device__ __forceinline__ int32_t block_inclusive_scan(int32_t v,
                                                        int32_t* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += s_warp[warp - 1];
  __syncthreads();  // s_warp is reused by the caller's next scan
  return v;
}

// Block d: exclusive scan of hist row d in place; totals[d] = the row sum.
__global__ void radix_scan_kernel(int32_t* __restrict__ hist, int64_t n_tiles,
                                  int32_t* __restrict__ totals) {
  __shared__ int32_t s_warp[kWarps];
  int32_t* row = hist + blockIdx.x * n_tiles;
  int32_t carry = 0;
  for (int64_t c0 = 0; c0 < n_tiles; c0 += kThreads) {
    const int64_t i = c0 + threadIdx.x;
    const int32_t v = i < n_tiles ? row[i] : 0;
    const int32_t inc = block_inclusive_scan(v, s_warp);
    if (i < n_tiles) row[i] = carry + inc - v;
    // the last thread's inclusive value is the chunk's sum
    __shared__ int32_t s_sum;
    if (threadIdx.x == kThreads - 1) s_sum = inc;
    __syncthreads();
    carry += s_sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One pass's stable scatter of tile blockIdx.x. `idx_in` null means the
// identity (the first pass).
__global__ void radix_scatter_kernel(const int32_t* __restrict__ keys_in,
                                     const int32_t* __restrict__ idx_in,
                                     int64_t n, int shift, int64_t n_tiles,
                                     const int32_t* __restrict__ hist,
                                     const int32_t* __restrict__ totals,
                                     int32_t* __restrict__ keys_out,
                                     int32_t* __restrict__ idx_out) {
  __shared__ int32_t s_base[kDigits];          // global start of digit d here
  __shared__ int32_t s_count[kWarps][kDigits]; // per-warp digit counts
  __shared__ int32_t s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;

  // digit starts: exclusive scan of the totals plus this tile's row offset
  {
    const int32_t t = totals[threadIdx.x];
    const int32_t inc = block_inclusive_scan(t, s_warp);
    s_base[threadIdx.x] = inc - t + hist[threadIdx.x * n_tiles + tile];
  }
  for (int d = lane; d < kDigits; d += 32) s_count[warp][d] = 0;
  __syncwarp();

  const int64_t run = tile * kTile + (int64_t)warp * kWarpRun;
  const uint32_t lower = (1u << lane) - 1u;
  // first sweep: the warp's digit counts
  for (int c = 0; c < kWarpRun; c += 32) {
    const int64_t i = run + c + lane;
    const uint32_t d = i < n ? digit_of(keys_in[i], shift) : kDigits;
    const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
    if (d < kDigits && (peers & lower) == 0) s_count[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // warp order: turn the counts into each warp's exclusive start per digit
  {
    const int d = threadIdx.x;
    int32_t acc = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = s_count[w][d];
      s_count[w][d] = acc;
      acc += c;
    }
  }
  __syncthreads();
  // second sweep: rank and write
  for (int c = 0; c < kWarpRun; c += 32) {
    const int64_t i = run + c + lane;
    const bool valid = i < n;
    const int32_t key = valid ? keys_in[i] : 0;
    const uint32_t d = valid ? digit_of(key, shift) : kDigits;
    const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
    if (valid) {
      const int32_t before = s_count[warp][d];
      const int32_t pos = s_base[d] + before + __popc(peers & lower);
      keys_out[pos] = key;
      idx_out[pos] = idx_in != nullptr ? idx_in[i] : static_cast<int32_t>(i);
    }
    __syncwarp();
    if (valid && (peers & lower) == 0) s_count[warp][d] += __popc(peers);
    __syncwarp();
  }
}

inline int tiles_of(int64_t n) {
  return static_cast<int>((n + kTile - 1) / kTile);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry points (ctypes). Each launches on `stream` and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.

extern "C" int keto_radix_tile() { return kTile; }

extern "C" int keto_radix_hist(const int32_t* keys, int64_t n, int32_t shift,
                               int32_t* hist, void* stream) {
  const int64_t n_tiles = tiles_of(n);
  if (n_tiles > 0) {
    radix_hist_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        keys, n, shift, n_tiles, hist);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_radix_scan(int32_t* hist, int64_t n, int32_t* totals,
                               void* stream) {
  const int64_t n_tiles = tiles_of(n);
  if (n_tiles > 0) {
    radix_scan_kernel<<<kDigits, kThreads, 0, (cudaStream_t)stream>>>(
        hist, n_tiles, totals);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_radix_scatter(const int32_t* keys_in, const int32_t* idx_in,
                                  int64_t n, int32_t shift, const int32_t* hist,
                                  const int32_t* totals, int32_t* keys_out,
                                  int32_t* idx_out, void* stream) {
  const int64_t n_tiles = tiles_of(n);
  if (n_tiles > 0) {
    radix_scatter_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        keys_in, idx_in, n, shift, n_tiles, hist, totals, keys_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}
