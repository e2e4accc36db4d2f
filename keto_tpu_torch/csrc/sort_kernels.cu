// Snapshot-build kernel for Hopper (sm_90a): the stable argsort.
//
// Replaces the XLA program of
//   K8 keto_tpu/graph/device_build.py:54 `_sort_fn.many` (:66,
//      `jnp.argsort(k, stable=True)` per key array)
//   -> keto_radix_hist once per sort, then keto_radix_pass once per pass
//      that runs, driven from keto_tpu_torch/graph/sort_kernels.py
//      (`radix_argsort_many`).
// The Python wrapper and the plain PyTorch version (`radix_argsort_ref`,
// the same passes in tensor code) live in keto_tpu_torch/graph/sort_kernels.py.
//
// Algorithm. A least-significant-digit radix sort of (int32 key, int32 index)
// pairs: 8-bit digits, up to 4 passes. Keys are read as uint32 with the sign
// bit flipped (key ^ 0x80000000), so negative keys order before positive ones
// as int32 does.
//   1. keto_radix_hist reads every key once and adds the four global digit
//      histograms hist[4][256] (per-block shared counts, one atomic per
//      non-zero (pass, digit) per block). The wrapper copies them back and
//      skips every pass whose histogram has a single non-zero digit: a stable
//      pass over a constant digit is the identity permutation.
//   2. keto_radix_pass, one launch per pass that runs, in the onesweep
//      pattern: each block takes the next tile of kTile keys from a global
//      counter, ranks its keys stably in shared memory, learns where each
//      digit's run of the tile starts in the output (the digit's global start,
//      an exclusive scan of the pass's histogram, plus the digit's counts in
//      all earlier tiles, by a decoupled look-back over per-(tile, digit)
//      status words), stages the ranked pairs in shared memory in digit order
//      and writes them out so that consecutive threads write consecutive
//      slots inside each digit's run.
// Stability: inside a tile each warp takes a contiguous run of kTile / 8 keys,
// 32 at a time in lane order; lanes holding the same digit find each other
// with __match_any_sync and rank by the popcount of the lower lanes;
// per-warp digit counts in shared memory, scanned in warp order, order the
// warps. The look-back adds the counts of the tiles with a smaller tile id
// only, so equal digits keep their input order across tiles too.
// Forward progress: a block's tile id comes from the counter, not from
// blockIdx.x, so a block only waits on tiles whose blocks already run; each
// block publishes its own counts before it waits.
// The status word holds a flag in its top two bits (kAggregate: the tile's
// own count; kPrefix: the count over tiles 0..t) and the count below, so
// the flag and its count are one 32-bit store and a load sees both or
// neither; counts stay below 2^30 (the wrapper refuses n >= 2^30). Each
// pass gets status words and a tile counter of its own, zeroed by the
// wrapper before the sort.
//
// Bound. Bytes: the histogram reads 4 bytes a key; a pass reads the key
// (4) and, after the first pass that runs, the index (4), and writes the
// index (4) and, before the last pass, the key (4). With 3 passes run
// (the build's node ids, < 2^23): 4 + 12 + 16 + 12 = 44 bytes a key.
// The first pass reads no index (it is the identity); the last writes no
// key. Shared memory per block: the staged tile (32 KiB) and the per-warp
// counts (8 KiB), within the 48 KiB of static shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                      // keys per thread
constexpr int kTile = kThreads * kItems;        // keys per tile: 4096
constexpr int kWarpRun = kTile / kWarps;        // contiguous keys per warp
constexpr int kDigits = 256;
static_assert(kThreads == kDigits, "one thread per digit in the per-digit steps");
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the histogram: keys per warp per loop step, per lane; blocks per SM
constexpr int kHistUnroll = 8;
constexpr int kHistBlocks = 132 * 4;

constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kPrefix = 2u << 30;
constexpr uint32_t kCountMask = kAggregate - 1u;

__device__ __forceinline__ uint32_t digit_of(int32_t key, int shift) {
  return ((static_cast<uint32_t>(key) ^ 0x80000000u) >> shift) & 0xFFu;
}

// hist[p * 256 + d] += the number of keys whose digit p is d (hist arrives
// zeroed). A warp whose valid lanes all hold one digit adds once for all of
// them, so a constant digit costs no shared-memory contention.
__global__ void __launch_bounds__(kThreads) radix_hist_kernel(const int32_t* __restrict__ keys,
                                                              int64_t n,
                                                              int32_t* __restrict__ hist) {
  __shared__ int32_t s_hist[kPasses * kDigits];
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t step = 32 * kHistUnroll;
  const int64_t stride = (int64_t)gridDim.x * kWarps * step;
  // the loop bound depends on the warp only, so every lane iterates together
  for (int64_t base = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * step; base < n;
       base += stride) {
    int32_t key[kHistUnroll];
    bool valid[kHistUnroll];
#pragma unroll
    for (int j = 0; j < kHistUnroll; ++j) {
      const int64_t i = base + j * 32 + lane;
      valid[j] = i < n;
      key[j] = valid[j] ? keys[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kHistUnroll; ++j) {
      const unsigned live = __ballot_sync(kFull, valid[j]);
      if (live == 0) continue;  // warp-uniform; lane 0 is valid otherwise
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const uint32_t d = digit_of(key[j], 8 * p);
        const uint32_t d0 = __shfl_sync(kFull, d, 0);
        if (__all_sync(kFull, !valid[j] || d == d0)) {
          if (lane == 0) atomicAdd(&s_hist[p * kDigits + d0], __popc(live));
        } else if (valid[j]) {
          atomicAdd(&s_hist[p * kDigits + d], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads) {
    if (s_hist[i]) atomicAdd(hist + i, s_hist[i]);
  }
}

// Inclusive scan of one value per thread over the block (kThreads threads).
__device__ __forceinline__ int32_t block_inclusive_scan(int32_t v, int32_t* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += s_warp[warp - 1];
  __syncthreads();  // s_warp is reused by the caller's next scan
  return v;
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// One pass of the sort over the tile the block draws from `tile_counter`.
// `idx_in` null means the identity (the first pass that runs); `keys_out`
// null means the last pass (only the index is written). `hist` is this
// pass's 256 global digit counts; `status` [n_tiles][256] and
// `tile_counter` arrive zeroed.
__global__ void __launch_bounds__(kThreads) radix_pass_kernel(
    const int32_t* __restrict__ keys_in, const int32_t* __restrict__ idx_in, int64_t n,
    int shift, const int32_t* __restrict__ hist, uint32_t* status, int32_t* tile_counter,
    int32_t* __restrict__ keys_out, int32_t* __restrict__ idx_out) {
  __shared__ int32_t s_keys[kTile];             // the tile in digit order
  __shared__ int32_t s_idx[kTile];
  __shared__ int32_t s_count[kWarps][kDigits];  // per-warp digit counts, then offsets
  __shared__ int32_t s_start[kDigits];          // digit's start inside the tile
  __shared__ int32_t s_base[kDigits];           // output slot of tile slot 0, per digit
  __shared__ int32_t s_warp[kWarps];
  __shared__ int32_t s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1);
  for (int d = lane; d < kDigits; d += 32) s_count[warp][d] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t run = tile * kTile + (int64_t)warp * kWarpRun;
  const uint32_t lower = (1u << lane) - 1u;

  // 1. the warp's keys in registers, each ranked among the warp's earlier
  //    keys of its digit
  int32_t key[kItems];
  int32_t rank[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = run + c * 32 + lane;
    key[c] = i < n ? keys_in[i] : 0;
  }
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = run + c * 32 + lane;
    const uint32_t d = i < n ? digit_of(key[c], shift) : kDigits;
    const uint32_t peers = __match_any_sync(kFull, d);
    const int32_t before = d < kDigits ? s_count[warp][d] : 0;
    rank[c] = before + __popc(peers & lower);
    __syncwarp();
    if (d < kDigits && (peers & lower) == 0) s_count[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2. thread d: the warps' offsets inside digit d's run of the tile, the
  //    tile's count, published at once for the tiles after this one
  const int d = threadIdx.x;
  int32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int32_t c = s_count[w][d];
    s_count[w][d] = count;
    count += c;
  }
  uint32_t* my_status = status + tile * kDigits + d;
  store_status(my_status, (tile == 0 ? kPrefix : kAggregate) | static_cast<uint32_t>(count));
  const int32_t start = block_inclusive_scan(count, s_warp) - count;
  s_start[d] = start;
  const int32_t h = hist[d];
  const int32_t global_start = block_inclusive_scan(h, s_warp) - h;  // syncs s_start too

  // 3. stage the tile in digit order
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = run + c * 32 + lane;
    if (i < n) {
      const uint32_t dc = digit_of(key[c], shift);
      const int32_t pos = s_start[dc] + s_count[warp][dc] + rank[c];
      s_keys[pos] = key[c];
      s_idx[pos] = idx_in != nullptr ? idx_in[i] : static_cast<int32_t>(i);
    }
  }

  // 4. thread d: the look-back over earlier tiles' counts of digit d
  int32_t earlier = 0;
  if (tile > 0) {
    for (int64_t t = tile - 1;;) {
      const uint32_t w = load_status(status + t * kDigits + d);
      if ((w & ~kCountMask) == 0) continue;  // tile t has not published yet
      earlier += static_cast<int32_t>(w & kCountMask);
      if (w & kPrefix) break;
      --t;
    }
    store_status(my_status, kPrefix | static_cast<uint32_t>(earlier + count));
  }
  s_base[d] = global_start + earlier - start;
  __syncthreads();

  // 5. write out in tile order: consecutive threads write consecutive slots
  //    inside each digit's run
  const int64_t left = n - tile * kTile;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  for (int j = threadIdx.x; j < tile_n; j += kThreads) {
    const int32_t k = s_keys[j];
    const int32_t pos = s_base[digit_of(k, shift)] + j;
    if (keys_out != nullptr) keys_out[pos] = k;
    idx_out[pos] = s_idx[j];
  }
}

inline int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry points (ctypes). Each launches on `stream` and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.

extern "C" int keto_radix_tile() { return kTile; }

// hist: int32[4][256], zeroed by the caller; the four digit histograms of
// `keys` are added into it.
extern "C" int keto_radix_hist(const int32_t* keys, int64_t n, int32_t* hist, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads * kHistUnroll - 1) / (kThreads * kHistUnroll);
    if (blocks > kHistBlocks) blocks = kHistBlocks;
    radix_hist_kernel<<<static_cast<int>(blocks), kThreads, 0, (cudaStream_t)stream>>>(keys, n,
                                                                                       hist);
  }
  return static_cast<int>(cudaGetLastError());
}

// One pass over digit `shift / 8`: status holds n_tiles * 256 words and
// counter one, both zeroed by the caller.
extern "C" int keto_radix_pass(const int32_t* keys_in, const int32_t* idx_in, int64_t n,
                               int32_t shift, const int32_t* hist, uint32_t* status,
                               int32_t* counter, int32_t* keys_out, int32_t* idx_out,
                               void* stream) {
  const int64_t n_tiles = tiles_of(n);
  if (n_tiles > 0) {
    radix_pass_kernel<<<static_cast<int>(n_tiles), kThreads, 0, (cudaStream_t)stream>>>(
        keys_in, idx_in, n, shift, hist, status, counter, keys_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}
