// Check-path kernels for Hopper (sm_90a): the bit-packed BFS fixpoint.
//
// Replaces the XLA programs of keto_tpu/check/tpu_engine.py:
//   K1 `_pull`      (tpu_engine.py:89)  -> keto_pull
//   K2 `check_step` (tpu_engine.py:110) -> keto_seed, keto_pull, keto_commit,
//                                          keto_close, keto_answer_pack
// The Python wrappers and the plain PyTorch versions of each live in
// keto_tpu_torch/check/kernels.py; the build (nvcc, plain C ABI, ctypes) in
// keto_tpu_torch/_build.py.
//
// Layout. Bitmaps are uint32 [rows, W]: bit q&31 of word q>>5 in row v means
// "query q has reached node v". R has n_int+1 rows (row n_int is the all-zero
// row every ELL sentinel points at); P, the pull output, has n_active+1 rows
// (row n_active stays zero: passive and absent targets read it). Torch holds
// both as int32; the kernels reinterpret them as uint32.
//
// Bound. Every kernel is a gather or a scatter of 4-byte words with one OR per
// word loaded: memory-bound. The pull streams R rows once per in-edge slot;
// one thread per (row, word) with the word index fastest makes a warp read
// 128 contiguous bytes of one source row while the neighbour index is a
// broadcast load. Work is integer ORs only, so no tensor-core path applies.
//
// The fixpoint is Jacobi, like the reference: each step pulls into P from the
// R of the previous step, then keto_commit folds P into R. Pulling into R in
// place would converge in fewer steps and change the reported iteration
// count. The loop guard lives on the device (int32 state {changed, iters,
// step_changed}): every step kernel returns at once while changed == 0, so
// the host can enqueue a block of steps and read the state once per block,
// reproducing lax.while_loop(cond, fori_loop(cond(step))) word for word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// grid-stride loops: enough blocks to fill 132 SMs several times over
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

// Seed scatter: for each (row, query) entry of e1 and e2 whose row lies in
// [0, n_int], set the query's bit in R (and, for e2, in ans_base). The
// reference scatter-adds onto disjoint bits, so OR is exact; padding rows
// (n_int+1) fall outside and are dropped like its mode="drop".
__global__ void seed_kernel(const int32_t* __restrict__ entries, int64_t S1,
                            int64_t S2, int32_t n_int, int32_t W,
                            uint32_t* __restrict__ R,
                            uint32_t* __restrict__ ans_base) {
  const int64_t n = S1 + S2;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    const bool e2 = j >= S1;
    const int64_t k = e2 ? j - S1 : j;
    const int32_t* rows = e2 ? entries + 2 * S1 : entries;
    const int64_t S = e2 ? S2 : S1;
    const int32_t row = rows[k];
    const int32_t q = rows[S + k];
    if (row < 0 || row > n_int) continue;
    const int64_t at = (int64_t)row * W + (q >> 5);
    const uint32_t bit = 1u << (q & 31);
    atomicOr(R + at, bit);
    if (e2) atomicOr(ans_base + at, bit);
  }
}

// One ELL gather-OR: out row i = OR over j < cap of R[nbrs[i, j]]. Without
// `dst`, row i lands at P[offset + i] (a degree bucket: buckets tile the
// active prefix, so no scatter). With `dst`, row i ORs into P[dst[i]] and
// destinations outside [0, n_dst) are dropped (the delta-overlay stage).
__global__ void pull_kernel(const int32_t* __restrict__ nbrs, int64_t n_rows,
                            int32_t cap, const int32_t* __restrict__ dst,
                            int64_t offset, int64_t n_dst,
                            const uint32_t* __restrict__ R,
                            uint32_t* __restrict__ P, int32_t W,
                            const int32_t* __restrict__ state) {
  if (halted(state)) return;
  const int64_t n = n_rows * W;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = idx / W;
    const int32_t w = static_cast<int32_t>(idx - i * W);
    const int32_t* row = nbrs + i * cap;
    uint32_t acc = 0;
    for (int32_t j = 0; j < cap; ++j) acc |= R[(int64_t)row[j] * W + w];
    if (dst == nullptr) {
      P[(offset + i) * W + w] = acc;
    } else {
      const int32_t d = dst[i];
      if (d >= 0 && d < n_dst && acc) atomicOr(P + (int64_t)d * W + w, acc);
    }
  }
}

// R[:n_active] |= P, raising state.step_changed when any word grew.
__global__ void commit_kernel(const uint32_t* __restrict__ P,
                              uint32_t* __restrict__ R, int64_t n,
                              int32_t* __restrict__ state) {
  if (halted(state)) return;
  bool grew = false;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t old = R[idx];
    const uint32_t nxt = old | P[idx];
    if (nxt != old) {
      R[idx] = nxt;
      grew = true;
    }
  }
  if (grew) state[2] = 1;
}

// Ends one guarded step: changed = step_changed, step_changed = 0, iters += 1
// — only while the loop is still running.
__global__ void close_kernel(int32_t* state) {
  if (state[0]) {
    state[0] = state[2];
    state[2] = 0;
    state[1] += 1;
  }
}

// Decisions: interior targets read P (the pull of the fixpoint) OR ans_base
// (the host-propagated one-hop term); sink targets OR the fixpoint bits of
// their interior in-neighbours. Bits pack into out[0:W]; out[W] = iters,
// out[W+1] = truncated (changed at exit). `out` arrives zeroed.
__global__ void answer_pack_kernel(const int32_t* __restrict__ entries,
                                   int64_t S1, int64_t S2, int64_t SA,
                                   int64_t B, int32_t n_active,
                                   const uint32_t* __restrict__ P,
                                   const uint32_t* __restrict__ ans_base,
                                   const uint32_t* __restrict__ R, int32_t W,
                                   const int32_t* __restrict__ state,
                                   uint32_t* __restrict__ out) {
  const int32_t* a_rows = entries + 2 * S1 + 2 * S2;
  const int32_t* a_q = a_rows + SA;
  const int32_t* targets = a_q + SA;
  const int64_t n = B + SA;
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (first == 0) {
    out[W] = state ? static_cast<uint32_t>(state[1]) : 0u;
    out[W + 1] = state ? static_cast<uint32_t>(state[0]) : 0u;
  }
  for (int64_t idx = first; idx < n; idx += (int64_t)gridDim.x * blockDim.x) {
    int32_t q;
    uint32_t word;
    if (idx < B) {
      q = static_cast<int32_t>(idx);
      const int32_t t = targets[idx];
      const int32_t t_act = t < n_active ? t : n_active;
      word = P[(int64_t)t_act * W + (q >> 5)] | ans_base[(int64_t)t * W + (q >> 5)];
    } else {
      const int64_t j = idx - B;
      q = a_q[j];
      word = R[(int64_t)a_rows[j] * W + (q >> 5)];
    }
    if ((word >> (q & 31)) & 1u) atomicOr(out + (q >> 5), 1u << (q & 31));
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry points (ctypes). Each launches on `stream` and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.

extern "C" int keto_seed(const int32_t* entries, int64_t S1, int64_t S2,
                         int32_t n_int, int32_t W, uint32_t* R,
                         uint32_t* ans_base, void* stream) {
  seed_kernel<<<blocks_for(S1 + S2), kThreads, 0, (cudaStream_t)stream>>>(
      entries, S1, S2, n_int, W, R, ans_base);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_pull(const int32_t* nbrs, int64_t n_rows, int32_t cap,
                         const int32_t* dst, int64_t offset, int64_t n_dst,
                         const uint32_t* R, uint32_t* P, int32_t W,
                         const int32_t* state, void* stream) {
  pull_kernel<<<blocks_for(n_rows * W), kThreads, 0, (cudaStream_t)stream>>>(
      nbrs, n_rows, cap, dst, offset, n_dst, R, P, W, state);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_commit(const uint32_t* P, uint32_t* R, int64_t n,
                           int32_t* state, void* stream) {
  commit_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(P, R, n,
                                                                      state);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_close(int32_t* state, void* stream) {
  close_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(state);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_answer_pack(const int32_t* entries, int64_t S1, int64_t S2,
                                int64_t SA, int64_t B, int32_t n_active,
                                const uint32_t* P, const uint32_t* ans_base,
                                const uint32_t* R, int32_t W,
                                const int32_t* state, uint32_t* out,
                                void* stream) {
  answer_pack_kernel<<<blocks_for(B + SA), kThreads, 0,
                       (cudaStream_t)stream>>>(entries, S1, S2, SA, B, n_active,
                                               P, ans_base, R, W, state, out);
  return static_cast<int>(cudaGetLastError());
}
