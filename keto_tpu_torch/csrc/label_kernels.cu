// Label-route kernels for Hopper (sm_90a): the 2-hop intersection of Check,
// its witness for the explain path, and the two programs of the device
// label build.
//
// Replaces the XLA programs:
//   K3 `label_step`            (keto_tpu/check/tpu_engine.py:310)  -> keto_label_step
//   K4 `label_step_witness`    (keto_tpu/check/tpu_engine.py:352)  -> keto_label_witness
//   K6 `_sweep_step().step`    (keto_tpu/graph/label_build.py:150) and the
//      sweep loop around it (:269-281), with K10c's per-shard wave
//      (keto_tpu/parallel/sharded.py:559)                          -> keto_sweep_run
//   K7 `_covered_fn().covered` (keto_tpu/graph/label_build.py:183) and the
//      lane-mask table of `_compute_covered` (:193-221)         -> keto_covered
// The Python wrappers and the plain PyTorch versions live in
// keto_tpu_torch/check/kernels.py (K3) and keto_tpu_torch/graph/label_kernels.py
// (K6, K7); the build (nvcc, plain C ABI, ctypes) in keto_tpu_torch/_build.py.
// Torch holds every array as int32; bitmaps are read as uint32.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
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

// K6, and K10c's per-shard wave. One orientation's sweep run to its fixpoint
// in ONE cooperative launch: waves of a batch of landmark BFSs over every ELL
// group, separated by grid-wide barriers, with the stop test on the device.
// Row r of group g gathers X over its slots (P), then at its destination
// row base[g] + d, d = dst[r]: N = P & ~V, store = N & ~cov, V |= N,
// S |= store, X' = store (prune) or N. A d outside [0, n_dst) is dropped.
//
// Unsharded, base = 0 and n_dst = n + 1 (nothing is dropped). Sharded (the
// reference's shard_map program, keto_tpu/parallel/sharded.py:559), shard s
// owns the rows [s·rps, (s+1)·rps) of every bitmap, its routed groups carry
// base = s·rps and local dst rows, and n_dst = rps drops the routing's
// padding sentinel; the gathers read global rows of the halo-exchanged
// bitmap, so shard s's local row r sits at global row s·rps + r.
//
// Buffers. X0 is the seeded frontier. Unsharded (halo = 0), wave 0 reads X0
// and the waves after it ping-pong between Xa and Xb (wave k writes Xa for
// even k, Xb for odd k, and reads the other): Jacobi, as the reference. Every
// dst row of the written buffer is written each wave (0 where the row adds
// nothing) and no other row ever is, so neither buffer needs zeroing between
// waves. Sharded (halo = 1), every wave reads the gathered bitmap X0 and
// writes the shards' slabs Xa; then, while the run goes on, an explicit halo
// phase between two barriers copies every slab into X0 (the all_gather).
//
// Stop test, as the host loop of keto_tpu/graph/label_build.py:269-281: after
// wave k's barrier every block adds wave k's visits (an int64 slot of three,
// k % 3, reset by block 0 two waves ahead of its reuse) to its running total
// and reads the last active wave (raised with atomicMax, so every block reads
// the same answer). The run stops when the budget is given and the total
// exceeds it (the remaining budget below 0: the crossing wave counted, as
// the reference subtracts after each wave) or when the wave was inactive.
// ctl (int64[8], zeroed by the caller): [0..2] the visit slots, [3] the last
// active wave + 1, and on return [4] waves run, [5] total visits, [6] dry,
// [7] 1 when the wave cap (every bit of V set once) was passed.
//
// Bound: bytes, per wave — each ELL slot index is read once and names one X
// word per landmark word, and the masks touch V, S, cov and X' once per dst
// word. Design: a group of cap >= 32 gives each row one warp (the lanes split
// the slots, four words at a time, and fold with __reduce_or_sync); narrower
// groups give each (row, word) one thread, the word index fastest. Groups run
// one after another inside a wave, each starting where the previous one's
// threads left off, so small groups do not pile onto the first blocks. The
// descriptor table (start row, rows, cap, slot offset, base) sits in shared
// memory. Index math is 32-bit: the wrapper checks that the slot count and
// rows·wt stay below 2^31. Buffers written during the run are read with
// plain loads (never through the read-only path), so a wave sees the writes
// before the barrier.
constexpr int kSweepThreads = 256;
constexpr int kMaxSweepGroups = 256;
constexpr int kWideCap = 32;

__device__ __forceinline__ void sweep_store(uint32_t acc, int at, uint32_t* V, uint32_t* S,
                                            const uint32_t* __restrict__ cov, uint32_t* Xw,
                                            int prune, unsigned& visits, bool& active) {
  const uint32_t v = V[at];
  const uint32_t nw = acc & ~v;
  uint32_t st = 0;
  if (nw) {
    st = nw & ~cov[at];
    V[at] = v | nw;
    if (st) S[at] |= st;
    visits += __popc(nw);
  }
  const uint32_t x2 = prune ? st : nw;
  Xw[at] = x2;
  active |= x2 != 0;
}

__global__ void __launch_bounds__(kSweepThreads)
sweep_run_kernel(const int32_t* __restrict__ slots, const int32_t* __restrict__ dst,
                 const int32_t* __restrict__ desc, int32_t G, int32_t wt, int32_t n_dst,
                 int32_t words, int32_t halo, uint32_t* X0, uint32_t* Xa, uint32_t* Xb,
                 uint32_t* V, uint32_t* S, const uint32_t* __restrict__ cov, int32_t prune,
                 int32_t has_budget, long long budget, long long max_waves,
                 long long* ctl) {
  __shared__ int32_t sd[5 * kMaxSweepGroups];
  __shared__ long long s_visits;
  __shared__ long long s_active;
  for (int i = threadIdx.x; i < 5 * G; i += blockDim.x) sd[i] = desc[i];
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  long long total = 0;
  bool dry = false, over = false;
  long long k = 0;
  for (;; ++k) {
    if (tid == 0) ctl[(k + 1) % 3] = 0;  // wave k+1's slot, last read after wave k-2
    const uint32_t* Xr = halo ? X0 : (k == 0 ? X0 : ((k & 1) ? Xa : Xb));
    uint32_t* Xw = halo ? Xa : ((k & 1) ? Xb : Xa);
    unsigned visits = 0;
    bool active = false;
    int lead = 0, wlead = 0;  // work handed out so far this wave
    for (int g = 0; g < G; ++g) {
      const int start = sd[5 * g], rows = sd[5 * g + 1], cap = sd[5 * g + 2];
      const int off = sd[5 * g + 3], base = sd[5 * g + 4];
      if (cap < kWideCap) {
        const int items = rows * wt;
        int i = tid - lead % nthreads;
        if (i < 0) i += nthreads;
        for (; i < items; i += nthreads) {
          const int r = i / wt;
          const int w = i - r * wt;
          const int d = dst[start + r];
          if (d < 0 || d >= n_dst) continue;
          const int32_t* row = slots + off + r * cap;
          uint32_t acc = 0;
          for (int j = 0; j < cap; ++j) acc |= Xr[row[j] * wt + w];
          sweep_store(acc, (base + d) * wt + w, V, S, cov, Xw, prune, visits, active);
        }
        lead = (lead + items % nthreads) % nthreads;
      } else {
        int r = warp - wlead % nwarps;
        if (r < 0) r += nwarps;
        for (; r < rows; r += nwarps) {  // uniform across the warp
          const int d = dst[start + r];
          if (d < 0 || d >= n_dst) continue;
          const int32_t* row = slots + off + r * cap;
          for (int w0 = 0; w0 < wt; w0 += 4) {
            uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
            for (int j = lane; j < cap; j += 32) {
              const uint32_t* x = Xr + row[j] * wt + w0;
              a0 |= x[0];
              if (w0 + 1 < wt) a1 |= x[1];
              if (w0 + 2 < wt) a2 |= x[2];
              if (w0 + 3 < wt) a3 |= x[3];
            }
            a0 = __reduce_or_sync(kFull, a0);
            a1 = __reduce_or_sync(kFull, a1);
            a2 = __reduce_or_sync(kFull, a2);
            a3 = __reduce_or_sync(kFull, a3);
            if (lane < 4 && w0 + lane < wt) {
              const uint32_t acc = lane == 0 ? a0 : lane == 1 ? a1 : lane == 2 ? a2 : a3;
              sweep_store(acc, (base + d) * wt + w0 + lane, V, S, cov, Xw, prune, visits,
                          active);
            }
          }
        }
        wlead = (wlead + rows % nwarps) % nwarps;
      }
    }
    visits = __reduce_add_sync(kFull, visits);
    active = __any_sync(kFull, active);
    if (lane == 0) {
      if (visits)
        atomicAdd(reinterpret_cast<unsigned long long*>(ctl + k % 3),
                  static_cast<unsigned long long>(visits));
      if (active) atomicMax(ctl + 3, k + 1);
    }
    grid.sync();
    if (threadIdx.x == 0) {
      s_visits = *reinterpret_cast<volatile long long*>(ctl + k % 3);
      s_active = *reinterpret_cast<volatile long long*>(ctl + 3);
    }
    __syncthreads();
    total += s_visits;
    const bool was_active = s_active >= k + 1;
    __syncthreads();  // s_* are rewritten after the next barrier only
    if (has_budget && total > budget) {
      dry = true;
      break;
    }
    if (!was_active) break;
    if (k + 1 >= max_waves) {
      over = true;
      break;
    }
    if (halo) {  // the all_gather: every shard's slab into the gathered bitmap
      for (int i = tid; i < words; i += nthreads) X0[i] = Xa[i];
      grid.sync();
    }
  }
  if (tid == 0) {
    ctl[4] = k + 1;
    ctl[5] = total;
    ctl[6] = dry ? 1 : 0;
    ctl[7] = over ? 1 : 0;
  }
}

// K7. covered[u] = OR of the lane bits of the batch lanes j whose own
// pre-batch label row shares a non-pad entry with row u of `lab` (the
// reference's searchsorted over the union U of the own entries, with a lane
// mask per value). `own` is the batch's own rows as the host mirror holds
// them, [lanes, own_width]; the host has checked that each of their entries
// is the pad or a node row in [0, T), T = lab's rows.
//
// THREE stream-ordered launches a call, no host read:
//   1. covered_table_kernel: the lane-mask table, atomicOr(table[v][j/32],
//      1 << j%32) for each own entry v in [0, T) of lane j. `table` is
//      int32[T, wt], allocated once by the caller, zero between calls;
//   2. covered_pass_kernel: a group of `group` lanes a row (4 to 32; a
//      warp holds 32/group rows, neighbouring rows at neighbouring
//      addresses, a thread a group of rows per launch, no loop; lane `sub`
//      of the group writes the words w0 + sub), each lane reading `vec`
//      entries at once (16 bytes where the width allows), one table gather
//      per entry in [0, T) (pads and entries outside are skipped: no own
//      entry can equal them), the words OR-reduced across the group by
//      shuffles and written once. Rows [T, out_rows) are written 0 (the
//      sharded sweep's padding rows);
//   3. covered_table_kernel again: the same slots cleared, so the table is
//      zero for the next call without a memset of the whole table.
// One cooperative launch with the phases between grid barriers was tried
// first and ran slower at config 4's shapes: a co-resident grid walks the
// rows in a loop whose iterations wait on each other, and the barriers
// cost (PERF.md).
// The table (484 KB at wt 1, 968 KB at wt 2 at config 4's rows) stays in
// the 50 MB L2, so its gathers are not device-memory bytes.
//
// Bound: bytes — one read of `lab` and of the own rows, one write of the
// output. The pass reads the table only after the first launch ended, so
// through the read-only path. Index math: rows and words in 64 bits.
constexpr int kCoverThreads = 256;

__global__ void __launch_bounds__(kCoverThreads)
covered_table_kernel(const int32_t* __restrict__ own, int32_t items, int32_t own_width,
                     int32_t T, int32_t wt, uint32_t* __restrict__ table, int32_t clear) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= items) return;
  const int32_t v = own[i];
  if (v < 0 || v >= T) return;
  const int j = i / own_width;
  uint32_t* w = table + static_cast<int64_t>(v) * wt + (j >> 5);
  if (clear) *w = 0;
  else atomicOr(w, 1u << (j & 31));
}

__device__ __forceinline__ void covered_gather(int32_t x, int32_t T,
                                               const uint32_t* __restrict__ table, int32_t wt,
                                               int32_t w0, uint32_t* a) {
  if (x < 0 || x >= T) return;
  const uint32_t* t = table + static_cast<int64_t>(x) * wt + w0;
  a[0] |= t[0];
  if (w0 + 1 < wt) a[1] |= t[1];
  if (w0 + 2 < wt) a[2] |= t[2];
  if (w0 + 3 < wt) a[3] |= t[3];
}

// The pass, specialised at compile time on the load width (VEC entries a
// load) and the lanes a row (GROUP), and held to 8 blocks an SM (all 64
// warps resident): each lane has one load in flight, so the rows in flight
// are the warps resident.
template <int VEC, int GROUP>
__global__ void __launch_bounds__(kCoverThreads, 8)
covered_pass_kernel(const int32_t* __restrict__ lab, int32_t T, int32_t width,
                    const uint32_t* __restrict__ table, int32_t wt,
                    uint32_t* __restrict__ out, int32_t out_rows) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (GROUP - 1);
  const int64_t row = (tid >> 5) * (32 / GROUP) + lane / GROUP;
  const int32_t* lr = lab + row * width;
  for (int w0 = 0; w0 < wt; w0 += 4) {  // uniform across the warp
    uint32_t a[4] = {0, 0, 0, 0};
    if (row < T) {
      for (int k = VEC * sub; k < width; k += VEC * GROUP) {
        if (VEC == 4) {
          const int4 q = *reinterpret_cast<const int4*>(lr + k);
          covered_gather(q.x, T, table, wt, w0, a);
          covered_gather(q.y, T, table, wt, w0, a);
          covered_gather(q.z, T, table, wt, w0, a);
          covered_gather(q.w, T, table, wt, w0, a);
        } else {
          covered_gather(lr[k], T, table, wt, w0, a);
        }
      }
    }
#pragma unroll
    for (int off = GROUP >> 1; off; off >>= 1) {
      a[0] |= __shfl_xor_sync(kFull, a[0], off);
      if (w0 + 1 < wt) a[1] |= __shfl_xor_sync(kFull, a[1], off);
      if (w0 + 2 < wt) a[2] |= __shfl_xor_sync(kFull, a[2], off);
      if (w0 + 3 < wt) a[3] |= __shfl_xor_sync(kFull, a[3], off);
    }
    if (sub < 4 && w0 + sub < wt && row < out_rows)
      out[row * wt + w0 + sub] = sub == 0 ? a[0] : sub == 1 ? a[1] : sub == 2 ? a[2] : a[3];
  }
}

template <int VEC>
void covered_pass(int group, int64_t blocks, cudaStream_t s, const int32_t* lab, int32_t T,
                  int32_t width, const uint32_t* table, int32_t wt, uint32_t* out,
                  int32_t out_rows) {
  const unsigned g = static_cast<unsigned>(blocks);
#define KETO_PASS(G)                                                                 \
  case G:                                                                            \
    covered_pass_kernel<VEC, G><<<g, kCoverThreads, 0, s>>>(lab, T, width, table, wt, \
                                                          out, out_rows);          \
    break
  switch (group) {
    KETO_PASS(4);
    KETO_PASS(8);
    KETO_PASS(16);
    default:
    KETO_PASS(32);
  }
#undef KETO_PASS
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

extern "C" int keto_sweep_run(const int32_t* slots, const int32_t* dst, const int32_t* desc,
                              int32_t G, int32_t wt, int32_t n_dst, int32_t words,
                              int32_t halo, uint32_t* X0, uint32_t* Xa, uint32_t* Xb,
                              uint32_t* V, uint32_t* S, const uint32_t* cov, int32_t prune,
                              int32_t has_budget, int64_t budget, int64_t* ctl, int64_t work,
                              void* stream) {
  if (G < 1 || G > kMaxSweepGroups || wt < 1) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t e = coresident_grid(sweep_run_kernel, kSweepThreads, work, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long budget_ll = budget;
  long long max_waves = static_cast<long long>(words) * 32 + 2;
  long long* ctl_ll = reinterpret_cast<long long*>(ctl);
  void* args[] = {&slots, &dst, &desc, &G, &wt, &n_dst, &words, &halo, &X0, &Xa, &Xb,
                  &V, &S, &cov, &prune, &has_budget, &budget_ll, &max_waves, &ctl_ll};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sweep_run_kernel), grid,
                                  kSweepThreads, args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_covered(const int32_t* lab, int32_t T, int32_t width, const int32_t* own,
                            int32_t lanes, int32_t own_width, int32_t wt, uint32_t* table,
                            uint32_t* out, int32_t out_rows, int32_t vec, void* stream) {
  if (T < 1 || width < 1 || lanes < 1 || own_width < 1 || wt < 1 || out_rows < T ||
      lanes > 32 * wt || (vec != 1 && vec != 4) || width % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  // Lanes a row: a power of two covering the row's loads, at most a warp, and
  // at least 4, since lane `sub` of the group writes the words w0 + sub.
  int group = 4;
  while (group < 32 && group * vec < width) group <<= 1;
  const int rows_per_block = kCoverThreads / group;
  const int64_t blocks = (static_cast<int64_t>(out_rows) + rows_per_block - 1) / rows_per_block;
  const int32_t items = lanes * own_width;
  const int table_blocks = (items + kCoverThreads - 1) / kCoverThreads;
  cudaStream_t s = (cudaStream_t)stream;
  covered_table_kernel<<<table_blocks, kCoverThreads, 0, s>>>(own, items, own_width, T, wt,
                                                              table, 0);
  if (vec == 4) covered_pass<4>(group, blocks, s, lab, T, width, table, wt, out, out_rows);
  else covered_pass<1>(group, blocks, s, lab, T, width, table, wt, out, out_rows);
  covered_table_kernel<<<table_blocks, kCoverThreads, 0, s>>>(own, items, own_width, T, wt,
                                                              table, 1);
  return static_cast<int>(cudaGetLastError());
}
