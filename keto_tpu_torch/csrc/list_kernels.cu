// Reverse-query kernels for Hopper (sm_90a): the list fixpoint's overlay stage.
//
// Replaces the XLA program of
//   K5 keto_tpu/list/tpu_engine.py:76 `list_step` (jitted at :114)
//   -> keto_pull (K1, csrc/check_kernels.cu) at W = 1 over the layout's degree
//      buckets, keto_commit, then keto_pull again (the overlay's gather) and
//      keto_list_scatter for the delta overlay, and keto_close, one guarded
//      step at a time.
// The Python wrapper (`list_step_cuda`, the host-driven loop) and the plain
// PyTorch version (`list_step_ref`) live in keto_tpu_torch/list/kernels.py.
//
// Layout. The reached bitmap R is uint32 [n_rows + 1, 1] (torch int32): bit q
// of row r means "listing q reached layout row r"; row n_rows is the all-zero
// row every bucket sentinel and overlay hole points at.
//
// Order of one step, as the reference's (tpu_engine.py:97-107):
//   1. P = pull(R) over the bucket-covered prefix (keto_pull, Jacobi);
//   2. R[:n_active] |= P (keto_commit, raises step_changed);
//   3. ovo[k] = OR_c R[ov_nbrs[k, c]], read from the COMMITTED R of step 2 and
//      written to a separate buffer (keto_pull with no destination rows, at
//      offset 0 of ovo), so no overlay row is read after another thread has
//      written it in the same step;
//   4. R[ov_dst[k]] |= ovo[k] (keto_list_scatter), dropping a destination
//      outside the bitmap's rows (the padding dst = n_rows + 1), raising
//      step_changed when a word grows. A destination may be a PASSIVE row
//      (no base neighbour, past n_active): the check step's overlay stage
//      (which ORs into P, over the active prefix only) would miss it, and its
//      changed flag would not see the write.
// The step's changed flag is therefore "any word of R grew", over all rows.
// Destinations are distinct (the engine groups the overlay by destination),
// so the OR of the scatter equals the reference's set of R[d] | ovo.
//
// Bound. Bytes: the scatter reads K indices and K words and updates at most K
// words of R. At the engine's sizes (a few hundred overlay rows) it is
// launch-bound.

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

__device__ __forceinline__ bool halted(const int32_t* state) {
  return state != nullptr && state[0] == 0;
}

// R[dst[k]] |= ovo[k] for dst[k] in [0, n_rows_total); state[2] = 1 when a
// word grew.
__global__ void list_scatter_kernel(const int32_t* __restrict__ dst, int64_t K,
                                    const uint32_t* __restrict__ ovo,
                                    uint32_t* __restrict__ R,
                                    int64_t n_rows_total,
                                    int32_t* __restrict__ state) {
  if (halted(state)) return;
  bool grew = false;
  for (int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; k < K;
       k += (int64_t)gridDim.x * blockDim.x) {
    const int32_t d = dst[k];
    const uint32_t v = ovo[k];
    if (d < 0 || d >= n_rows_total || v == 0) continue;
    const uint32_t old = atomicOr(R + d, v);
    if ((old | v) != old) grew = true;
  }
  if (grew && state != nullptr) state[2] = 1;
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry point (ctypes). It launches on `stream` and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.

extern "C" int keto_list_scatter(const int32_t* dst, int64_t K,
                                 const uint32_t* ovo, uint32_t* R,
                                 int64_t n_rows_total, int32_t* state,
                                 void* stream) {
  if (K > 0) {
    list_scatter_kernel<<<blocks_for(K), kThreads, 0, (cudaStream_t)stream>>>(
        dst, K, ovo, R, n_rows_total, state);
  }
  return static_cast<int>(cudaGetLastError());
}
