// Reverse-query kernel for Hopper (sm_90a): the list fixpoint in one launch.
//
// Replaces the XLA program of
//   K5 keto_tpu/list/tpu_engine.py:76 `list_step` (its lax.while_loop at :114)
//   -> keto_list_fixpoint: every guarded step of the run in ONE cooperative
//      launch, the steps' phases separated by grid-wide barriers and the loop
//      guard tested on the device.
// The Python wrapper (`list_step_cuda`) and the plain PyTorch version
// (`list_step_ref`) live in keto_tpu_torch/list/kernels.py. Check keeps K1/K2's
// own entry points (csrc/check_kernels.cu).
//
// Layout. The reached bitmap R is uint32 [n_rows + 1, 1] (torch int32): bit q
// of row r means "listing q reached layout row r"; row n_rows is the all-zero
// row every bucket sentinel and overlay hole points at. The degree buckets
// tile the active prefix [0, n_active): bucket b's valid rows land at rows
// first[b] .. first[b] + rows[b] - 1.
//
// One step, in the reference's order (tpu_engine.py:97-107):
//   1. the pull and commit: R'[i] = R[i] | OR_j R[nbrs[i, j]] for every active
//      row i, read from R and written to the other buffer R' (Jacobi);
//   2. with an overlay pending, ovo[k] = OR_c R'[ov_nbrs[k, c]], read from the
//      COMMITTED R' into a separate buffer;
//   3. R'[ov_dst[k]] |= ovo[k], dropping a destination outside the bitmap's
//      rows (the padding dst = n_rows + 1); a destination may be a PASSIVE row
//      (no base neighbour, past n_active).
// A barrier ends each phase. The step changed when any word of R grew, over
// all rows: phases 1 and 3 raise the last changed step (atomicMax, so every
// block reads the same answer after the barrier).
//
// Buffers. Ra and Rb both start as R0. With the pull on, step s reads one and
// writes the other's active prefix; rows past n_active change only in phase 3,
// which writes both buffers, so they agree everywhere outside the prefix and
// the result is the buffer the last step wrote (ctl[2] says which). Without
// the pull both are one buffer. Overlay destinations are distinct (the engine
// groups the overlay by destination row); the scatter ORs atomically all the
// same, as the per-step kernel it replaces did.
//
// Loop guard, as lax.while_loop(changed && it < it_cap, fori_loop(block_iters,
// cond(changed, step))): `it < it_cap` is tested only where a block of
// block_iters steps begins; a step that changes nothing ends the run (the
// guarded steps after it are no-ops). ctl (int32[4], zeroed by the caller):
// [0] the last changed step + 1, and on return [1] steps run, [2] 1 when Rb
// holds the result, [3] changed at exit (the run was cut by it_cap).
//
// Bound. Bytes: per step the bucket rows' slot indices, the gathered R words
// and the active prefix read and written; the overlay's K·C indices, words
// and K destinations. Design: buckets, like K6's groups, run one after another
// in a phase, each starting where the previous one's threads left off; a
// bucket of cap >= 32 gives each row one warp (lanes split the slots and fold
// with __reduce_or_sync), narrower buckets one thread per row. The bucket
// table arrives by value and sits in shared memory. Index math is 32-bit (the
// wrapper checks the sizes).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;
constexpr int kWideCap = 32;
constexpr unsigned kFull = 0xffffffffu;

struct ListBuckets {
  const int32_t* nbrs[kMaxBuckets];
  int32_t rows[kMaxBuckets];   // valid rows
  int32_t cap[kMaxBuckets];
  int32_t first[kMaxBuckets];  // first active row
  int32_t n;
};

__global__ void __launch_bounds__(kThreads)
list_fixpoint_kernel(const __grid_constant__ ListBuckets bk, uint32_t* Ra, uint32_t* Rb,
                     const int32_t* __restrict__ ov_nbrs, int32_t K, int32_t C,
                     const int32_t* __restrict__ ov_dst, uint32_t* ovo, int32_t n_rows_total,
                     int32_t it_cap, int32_t block_iters, int32_t* ctl) {
  __shared__ const int32_t* s_nbrs[kMaxBuckets];
  __shared__ int32_t s_rows[kMaxBuckets], s_cap[kMaxBuckets], s_first[kMaxBuckets];
  __shared__ int32_t s_last;
  if (threadIdx.x < bk.n) {
    s_nbrs[threadIdx.x] = bk.nbrs[threadIdx.x];
    s_rows[threadIdx.x] = bk.rows[threadIdx.x];
    s_cap[threadIdx.x] = bk.cap[threadIdx.x];
    s_first[threadIdx.x] = bk.first[threadIdx.x];
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const bool pull = bk.n > 0;
  uint32_t* cur = Ra;
  uint32_t* nxt = pull ? Rb : Ra;
  int it = 0;
  bool changed = true;
  for (;;) {
    if (it % block_iters == 0 && it >= it_cap) break;
    bool grew = false;
    if (pull) {
      int lead = 0, wlead = 0;
      for (int b = 0; b < bk.n; ++b) {
        const int rows = s_rows[b], cap = s_cap[b], first = s_first[b];
        const int32_t* nb = s_nbrs[b];
        if (cap < kWideCap) {
          int i = tid - lead;
          if (i < 0) i += nthreads;
          for (; i < rows; i += nthreads) {
            const int32_t* row = nb + i * cap;
            uint32_t acc = 0;
            for (int j = 0; j < cap; ++j) acc |= cur[row[j]];
            const uint32_t old = cur[first + i];
            nxt[first + i] = old | acc;
            grew |= (acc & ~old) != 0;
          }
          lead = (lead + rows % nthreads) % nthreads;
        } else {
          int i = warp - wlead;
          if (i < 0) i += nwarps;
          for (; i < rows; i += nwarps) {  // uniform across the warp
            const int32_t* row = nb + i * cap;
            uint32_t acc = 0;
            for (int j = lane; j < cap; j += 32) acc |= cur[row[j]];
            acc = __reduce_or_sync(kFull, acc);
            if (lane == 0) {
              const uint32_t old = cur[first + i];
              nxt[first + i] = old | acc;
              grew |= (acc & ~old) != 0;
            }
          }
          wlead = (wlead + rows % nwarps) % nwarps;
        }
      }
      if (__any_sync(kFull, grew) && lane == 0) atomicMax(ctl, it + 1);
      grew = false;
      grid.sync();
    }
    if (K > 0) {
      for (int k = tid; k < K; k += nthreads) {  // from the committed buffer
        const int32_t* row = ov_nbrs + k * C;
        uint32_t acc = 0;
        for (int c = 0; c < C; ++c) acc |= nxt[row[c]];
        ovo[k] = acc;
      }
      grid.sync();
      for (int k = tid; k < K; k += nthreads) {
        const int32_t d = ov_dst[k];
        const uint32_t v = ovo[k];
        if (d < 0 || d >= n_rows_total || v == 0) continue;
        const uint32_t old = atomicOr(nxt + d, v);
        if ((old | v) != old) {
          grew = true;
          if (cur != nxt) atomicOr(cur + d, v);
        }
      }
      if (__any_sync(kFull, grew) && lane == 0) atomicMax(ctl, it + 1);
      grid.sync();
    }
    if (threadIdx.x == 0) s_last = *reinterpret_cast<volatile int32_t*>(ctl);
    __syncthreads();
    changed = s_last >= it + 1;
    __syncthreads();
    ++it;
    if (pull) {
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
    if (!changed) break;
  }
  if (tid == 0) {
    ctl[1] = it;
    ctl[2] = cur == Rb && pull ? 1 : 0;
    ctl[3] = changed ? 1 : 0;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry point (ctypes). It launches on `stream` and returns the launch's
// error code, or cudaGetLastError(), so a refused launch surfaces in the Python
// wrapper. `nbrs`, `rows` and `caps` are host arrays of `nb` buckets.

extern "C" int keto_list_fixpoint(const int64_t* nbrs, const int32_t* rows, const int32_t* caps,
                                  int32_t nb, uint32_t* Ra, uint32_t* Rb,
                                  const int32_t* ov_nbrs, int32_t K, int32_t C,
                                  const int32_t* ov_dst, uint32_t* ovo, int32_t n_rows_total,
                                  int32_t it_cap, int32_t block_iters, int32_t* ctl,
                                  void* stream) {
  if (nb < 0 || nb > kMaxBuckets || block_iters < 1 || (K > 0 && C < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  ListBuckets bk{};
  bk.n = nb;
  int64_t work = K, wide = 0, first = 0;
  for (int b = 0; b < nb; ++b) {
    bk.nbrs[b] = reinterpret_cast<const int32_t*>(nbrs[b]);
    bk.rows[b] = rows[b];
    bk.cap[b] = caps[b];
    bk.first[b] = static_cast<int32_t>(first);
    first += rows[b];
    if (caps[b] >= kWideCap) wide += 32 * static_cast<int64_t>(rows[b]);
    else wide += rows[b];
  }
  if (wide > work) work = wide;
  int grid = 0;
  cudaError_t e = coresident_grid(list_fixpoint_kernel, kThreads, work, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&bk, &Ra, &Rb, &ov_nbrs, &K, &C, &ov_dst, &ovo, &n_rows_total, &it_cap,
                  &block_iters, &ctl};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(list_fixpoint_kernel), grid, kThreads,
                                  args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
