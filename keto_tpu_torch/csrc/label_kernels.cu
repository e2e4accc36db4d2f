// Label-route kernels for Hopper (sm_90a): the 2-hop intersection of Check,
// its witness for the explain path, and the two programs of the device
// label build.
//
// Replaces the XLA programs:
//   K3 `label_step`            (keto_tpu/check/tpu_engine.py:310)  -> keto_label_step
//   K4 `label_step_witness`    (keto_tpu/check/tpu_engine.py:352)  -> keto_label_witness
//   K6 `_sweep_step().step`    (keto_tpu/graph/label_build.py:150) -> keto_sweep_step
//   K7 `_covered_fn().covered` (keto_tpu/graph/label_build.py:183) -> keto_covered
// The Python wrappers and the plain PyTorch versions live in
// keto_tpu_torch/check/kernels.py (K3) and keto_tpu_torch/graph/label_kernels.py
// (K6, K7); the build (nvcc, plain C ABI, ctypes) in keto_tpu_torch/_build.py.
// Torch holds every array as int32; bitmaps are read as uint32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int kMaxGroups = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kIntMax = 0x7fffffff;

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

// K3. Per pair (a, b): does any OUT(a) entry equal any IN(b) entry? A hit
// sets the owning query's bit in `out` (zeroed by the caller): the
// reference's `at[pq].max` followed by its bit pack, as one atomicOr.
//
// Bound: operations where the label rows are wide (Wo·Wi int32 compares a
// pair), else the bytes of the pairs' label rows. Design: one warp per
// pair. Each lane holds Wo/32 OUT entries in a register (the loop over i0
// covers Wo < 32 and Wo > 32); the warp walks the Wi IN entries, which all
// lanes load together (one broadcast load per entry), and folds its lanes'
// matches with __any_sync, stopping at the first hit. The compare is brute
// force, so it assumes nothing about the order of the entries. OUT_PAD (-1)
// and IN_PAD (-2) never compare equal, and pad pairs name the all-pad row,
// so neither can hit. Pairs naming a row outside [0, rows) never hit.
__global__ void label_step_kernel(const int32_t* __restrict__ out_lab, int32_t Wo,
                                  const int32_t* __restrict__ in_lab, int32_t Wi,
                                  int64_t rows, const int32_t* __restrict__ entries,
                                  int64_t P, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int32_t* pa = entries;
  const int32_t* pb = entries + P;
  const int32_t* pq = entries + 2 * P;
  for (int64_t p = warp; p < P; p += n_warps) {  // uniform across the warp
    const int32_t a = pa[p];
    const int32_t b = pb[p];
    if (a < 0 || a >= rows || b < 0 || b >= rows) continue;
    const int32_t* orow = out_lab + (int64_t)a * Wo;
    const int32_t* irow = in_lab + (int64_t)b * Wi;
    bool hit = false;
    for (int32_t i0 = 0; i0 < Wo && !hit; i0 += 32) {
      const int32_t i = i0 + lane;
      const bool valid = i < Wo;
      const int32_t x = valid ? orow[i] : 0;
      bool mine = false;
      for (int32_t j = 0; j < Wi; ++j) mine |= (x == irow[j]);
      hit = __any_sync(kFull, valid && mine);
    }
    if (hit && lane == 0) {
      const int32_t q = pq[p];
      atomicOr(out + (q >> 5), 1u << (q & 31));
    }
  }
}

// K4. Per pair (a, b): the smallest OUT(a) entry that equals some IN(b)
// entry, or -1 when none does (the reference's argmin over the same compare
// K3 reduces to one bit).
//
// Bound: as K3's; the explain path launches it with one pair, so in serving
// it is a launch. Design: K3's warp per pair and register-held OUT entries,
// with no exit on the first hit: each lane keeps the minimum of its matching
// entries (INT_MAX when it has none, or no valid slot where Wo < 32), the
// warp takes __reduce_min_sync over the signed values and __any_sync over
// the found flags, and lane 0 writes the minimum or -1. Brute force, so it
// assumes nothing about the order of the entries; the pads (-1, -2) never
// compare equal. Pairs naming a row outside [0, rows) write -1.
__global__ void label_witness_kernel(const int32_t* __restrict__ out_lab, int32_t Wo,
                                     const int32_t* __restrict__ in_lab, int32_t Wi,
                                     int64_t rows, const int32_t* __restrict__ pa,
                                     const int32_t* __restrict__ pb, int64_t P,
                                     int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t p = warp; p < P; p += n_warps) {  // uniform across the warp
    const int32_t a = pa[p];
    const int32_t b = pb[p];
    if (a < 0 || a >= rows || b < 0 || b >= rows) {
      if (lane == 0) out[p] = -1;
      continue;
    }
    const int32_t* orow = out_lab + (int64_t)a * Wo;
    const int32_t* irow = in_lab + (int64_t)b * Wi;
    int32_t best = kIntMax;
    bool found = false;
    for (int32_t i0 = 0; i0 < Wo; i0 += 32) {
      const int32_t i = i0 + lane;
      if (i >= Wo) continue;
      const int32_t x = orow[i];
      bool mine = false;
      for (int32_t j = 0; j < Wi; ++j) mine |= (x == irow[j]);
      if (mine) {
        found = true;
        best = x < best ? x : best;
      }
    }
    best = __reduce_min_sync(kFull, best);
    found = __any_sync(kFull, found);
    if (lane == 0) out[p] = found ? best : -1;
  }
}

// K6. One frontier wave of a batch of landmark BFSs over every ELL group:
// row r of the flattened groups gathers X over its slots (P), then at its
// destination d: N = P & ~V, store = N & ~cov, V |= N, S |= store,
// X2 = store (prune) or N. A d outside [0, n_dst) is dropped. `active`
// (state[0]) is set when any X2 word is nonzero and `visits` (state[1])
// gains the popcount of N; X2 arrives zeroed, and state is added into.
//
// The sharded build (K10c, keto_tpu/parallel/sharded.py:559) runs the same
// kernel once per shard: X is the halo-exchanged bitmap in GLOBAL rows,
// V/S/cov/X2 are the shard's LOCAL rows, n_dst = rps drops the routing's
// padding sentinel, and every shard adds into one state pair (the psums of
// active and visits). Unsharded, n_dst = n + 1 and no dst is dropped.
//
// Bound: bytes — each ELL slot index is read once and each names one X
// word per landmark word; the masks touch V, S, cov and X2 once per dst
// word. Design: one thread per (group row, word), the word index fastest,
// so a warp reads wt-word runs of each source row; the group of a row is
// found in a descriptor table in shared memory (few groups, linear scan).
// dst rows are distinct across groups, so every V/S/X2 word has one
// writer, and rows outside every dst keep N = 0 as in the reference. The
// gathers read X and the wave writes X2: Jacobi, as the reference. Warp
// reductions fold `visits` and `active` into one atomic each.
__global__ void sweep_step_kernel(const int32_t* __restrict__ slots,
                                  const int32_t* __restrict__ dst,
                                  const int64_t* __restrict__ desc, int32_t G,
                                  int64_t n_rows, const uint32_t* __restrict__ X,
                                  uint32_t* __restrict__ V, uint32_t* __restrict__ S,
                                  const uint32_t* __restrict__ cov,
                                  uint32_t* __restrict__ X2, int32_t wt, int64_t n_dst,
                                  int32_t prune, int32_t* __restrict__ state) {
  __shared__ int64_t sdesc[3 * kMaxGroups];
  for (int i = threadIdx.x; i < 3 * G; i += blockDim.x) sdesc[i] = desc[i];
  __syncthreads();
  unsigned visits = 0;
  bool active = false;
  const int64_t n = n_rows * wt;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = idx / wt;
    const int32_t d = dst[r];
    if (d < 0 || d >= n_dst) continue;
    const int32_t w = static_cast<int32_t>(idx - r * wt);
    int g = 0;
    while (g + 1 < G && sdesc[3 * (g + 1)] <= r) ++g;
    const int64_t cap = sdesc[3 * g + 1];
    const int32_t* row = slots + sdesc[3 * g + 2] + (r - sdesc[3 * g]) * cap;
    uint32_t acc = 0;
    for (int64_t j = 0; j < cap; ++j) acc |= X[(int64_t)row[j] * wt + w];
    const int64_t at = (int64_t)d * wt + w;
    const uint32_t v = V[at];
    const uint32_t nw = acc & ~v;
    if (nw) {
      const uint32_t st = nw & ~cov[at];
      V[at] = v | nw;
      if (st) S[at] |= st;
      const uint32_t x2 = prune ? st : nw;
      if (x2) {
        X2[at] = x2;
        active = true;
      }
      visits += __popc(nw);
    }
  }
  visits = __reduce_add_sync(kFull, visits);
  active = __any_sync(kFull, active);
  if ((threadIdx.x & 31) == 0) {
    if (visits) atomicAdd(state + 1, static_cast<int32_t>(visits));
    if (active) state[0] = 1;
  }
}

// K7. Per node row: OR of masks[k] over the row's entries x with U[k] == x,
// k the left searchsorted position of x in the sorted table U. `out`
// arrives zeroed.
//
// Bound: bytes — one read of every label entry, the table, and one write
// of the output. Design: one thread per row, the table and its masks in
// shared memory (at most lanes × max_width values: 4,096 values and 32 KB
// of masks at the defaults), a binary search per entry. Pads (-1, -2) are
// never in U, which holds node ids, so they never hit. Where the table
// does not fit in shared memory the searches read it from device memory.
__global__ void covered_kernel(const int32_t* __restrict__ lab, int64_t rows,
                               int32_t width, const int32_t* __restrict__ U,
                               int64_t u, const uint32_t* __restrict__ masks,
                               int32_t wt, uint32_t* __restrict__ out,
                               int32_t use_smem) {
  extern __shared__ uint32_t smem[];
  const int32_t* tU = U;
  const uint32_t* tM = masks;
  if (use_smem) {
    int32_t* sU = reinterpret_cast<int32_t*>(smem);
    uint32_t* sM = smem + u;
    for (int64_t i = threadIdx.x; i < u; i += blockDim.x) sU[i] = U[i];
    for (int64_t i = threadIdx.x; i < u * wt; i += blockDim.x) sM[i] = masks[i];
    __syncthreads();
    tU = sU;
    tM = sM;
  }
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; row < rows;
       row += (int64_t)gridDim.x * blockDim.x) {
    const int32_t* lr = lab + row * width;
    uint32_t* orow = out + row * wt;
    for (int32_t k = 0; k < width; ++k) {
      const int32_t x = lr[k];
      int64_t lo = 0, hi = u;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (tU[mid] < x) lo = mid + 1; else hi = mid;
      }
      if (lo < u && tU[lo] == x) {
        for (int32_t w = 0; w < wt; ++w) orow[w] |= tM[lo * wt + w];
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry points (ctypes). Each launches on `stream` and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.

extern "C" int keto_label_step(const int32_t* out_lab, int32_t Wo, const int32_t* in_lab,
                               int32_t Wi, int64_t rows, const int32_t* entries, int64_t P,
                               uint32_t* out, void* stream) {
  label_step_kernel<<<blocks_for(32 * P), kThreads, 0, (cudaStream_t)stream>>>(
      out_lab, Wo, in_lab, Wi, rows, entries, P, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_label_witness(const int32_t* out_lab, int32_t Wo, const int32_t* in_lab,
                                  int32_t Wi, int64_t rows, const int32_t* pa, const int32_t* pb,
                                  int64_t P, int32_t* out, void* stream) {
  label_witness_kernel<<<blocks_for(32 * P), kThreads, 0, (cudaStream_t)stream>>>(
      out_lab, Wo, in_lab, Wi, rows, pa, pb, P, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_sweep_step(const int32_t* slots, const int32_t* dst, const int64_t* desc,
                               int32_t G, int64_t n_rows, const uint32_t* X, uint32_t* V,
                               uint32_t* S, const uint32_t* cov, uint32_t* X2, int32_t wt,
                               int64_t n_dst, int32_t prune, int32_t* state, void* stream) {
  if (G > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  sweep_step_kernel<<<blocks_for(n_rows * wt), kThreads, 0, (cudaStream_t)stream>>>(
      slots, dst, desc, G, n_rows, X, V, S, cov, X2, wt, n_dst, prune, state);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_covered(const int32_t* lab, int64_t rows, int32_t width, const int32_t* U,
                            int64_t u, const uint32_t* masks, int32_t wt, uint32_t* out,
                            void* stream) {
  // the table in shared memory when it fits the 227 KB a block may use
  const int64_t bytes = u * 4 + u * wt * 4;
  const bool use_smem = bytes <= 200 * 1024;
  const size_t smem = use_smem ? static_cast<size_t>(bytes) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        covered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  covered_kernel<<<blocks_for(rows), kThreads, smem, (cudaStream_t)stream>>>(
      lab, rows, width, U, u, masks, wt, out, use_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
