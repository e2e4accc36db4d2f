// Check-path kernels for Hopper (sm_90a): the bit-packed BFS fixpoint.
//
// Replaces the XLA programs of keto_tpu/check/tpu_engine.py:
//   K1 `_pull`      (tpu_engine.py:89)  -> keto_pull: one launch over every
//      bucket (the device function `pull_task`, which the run below runs too)
//   K2 `check_step` (tpu_engine.py:110) -> keto_seed, keto_check_run (the whole
//      guarded fixpoint in ONE cooperative launch), keto_answer_pack
// and the fixpoint of K10a `sharded_check_step` (keto_tpu/parallel/sharded.py:327),
// which keto_check_run runs over every row-range shard at once, its halo
// all-gather a phase of each hop (csrc/shard_kernels.cu holds its answer).
// Sharded, the seeds and the run also count the frontier bits they set
// (`pop`, the reference's psum of popcount(R_fix)): each adds the bits its
// writes newly set, a block reduction and one atomicAdd a block, so no
// kernel reads R again for it. Unsharded, `pop` is null and they count
// nothing.
// The Python wrappers and the plain PyTorch versions live in
// keto_tpu_torch/check/kernels.py and keto_tpu_torch/parallel/sharded.py; the
// build (nvcc, plain C ABI, ctypes) in keto_tpu_torch/_build.py.
//
// Layout. Bitmaps are uint32 [rows, W]: bit q&31 of word q>>5 in row v means
// "query q has reached node v". R has n_int+1 rows (row n_int is the all-zero
// row every ELL sentinel points at); P, the pull output, has n_active+1 rows
// (row n_active stays zero: passive and absent targets read it). Sharded, R,
// G (its gathered copy) and P are [g·rps, W] and shard s owns the rows
// [s·rps, (s+1)·rps): a global row id is the row. Torch holds every bitmap as
// int32; the kernels read them as uint32, 16 bytes at a time (uint4) where W
// is a multiple of 4 and the buffers are 16-byte aligned, else a word at a
// time.
//
// The pull. The degree buckets arrive as a table of bucket RUNS, passed by
// value (keto_pull reads it from the constant bank; keto_check_run copies it
// into shared memory): run r gathers its rows[r] rows of nbrs[r]
// (int32 [rows, cap], neighbour ids = rows of the source bitmap) into the
// output rows out[r], out[r] + 1, ...; the runs tile the active prefix in
// order (unsharded, one run a bucket; sharded, one a shard's slice of a
// bucket). Work is row-major: a TEAM of lanes owns a row, 1 << is item lanes
// (the row's words, as vectors) by 1 << ss slot lanes (its neighbours),
// is + ss <= 5, so a warp holds 32 >> (is + ss) rows; a row longer than a
// warp's kUnroll vectors a lane is cut into 1 << cs chunks, one warp each.
// Each lane loads its neighbour ids itself (lanes of a team read the same id
// at once: one broadcast transaction), gathers kUnroll vectors a slot and
// folds the slot lanes with shuffles; lane 0 of each slot group stores. A
// warp's rows (or chunk) are a task; tasks are numbered run after run
// (warp0[r] is run r's first), a chunked run's chunk-major (every row's first
// chunk, then every row's second, as index_select's grid: the stores spread
// over rows, which measured faster than a row's chunks side by side), so no
// index divides. Wide caps (past 1,024)
// loop over their slots, narrow widths (W = 1, 3, 5) take the word-wide path,
// and every output word is written. Index math is 32-bit: the wrapper refuses
// bitmaps or bucket matrices of 2^31 words or more.
//
// Bound: bytes. A pull must read each bucket slot once, each distinct source
// row once and write the P rows. A 16 KB row (config 3, W = 4,096) is 16
// warp tasks of 1 KB, each lane's two 16-byte loads in flight at once after
// one id load: the access pattern of an index_select. P is stored evict-first
// (__stcs), so the source rows, read again by other rows, keep the L2. At
// config 3 the pull writes 130 MB and reads 23 MB of distinct rows: it runs
// at the card's practical write rate, as index_select does (rows sorted by
// source, for L1 reuse, measured no faster).
//
// The fixpoint (keto_check_run) is Jacobi, like the reference: every pull of
// a step reads R (sharded: G) as it stood before any commit of that step, and
// P is not R. One step, its phases split by grid barriers:
//   1. sharded only, the halo: every slab of R copied into G (lax.all_gather);
//   2. the pull of every run (from R, or G) into P;
//   3. with an overlay, ovo[k] = OR_c src[ov_nbrs[k, c]] ORed (atomicOr) into
//      P[base + ov_dst[k]], dropping a destination outside [0, n_dst): the
//      reference's p.at[ov_dst].set(p[ov_dst] | ovo, mode="drop"), landing
//      after the bucket row it ORs into;
//   4. the commit R[:n_active] |= P[:n_active], raising the last changed
//      step with atomicMax (every block reads the same answer after the
//      barrier).
// The loop guard is lax.while_loop(changed && it < it_cap, fori_loop(
// block_iters, cond(changed, step))) word for word: `it < it_cap` is tested
// only where a block of block_iters steps begins, so iters may pass it_cap by
// up to block_iters - 1, and a step that changes nothing ends the run (the
// guarded no-op steps after it do nothing, so P keeps the pull of the last
// step run: the answer's p_fix). The halo is copied only on steps that run.
// ctl (int32[3], zeroed by the caller): on return [0] changed at exit (the
// truncation flag), [1] steps run; [2] is the last changed step + 1.
// keto_answer_pack and keto_shard_answer read [0] and [1]. With `pop` (a
// uint32 on the card; COUNT) each commit thread keeps popc(nxt & ~old) of
// the words it grows in a register across the steps, and adds it after the
// last one (a block reduction, one atomicAdd a block). With `counts`
// (int64[2] on the card, never reset here) the run adds its steps and its
// halo copies: the launch counts of the pull and the halo, which no host
// read between the seeds and the answer could give. With `stamps` (int64
// [stamp_steps, kStamps], for measurement; null on the path) thread 0 of
// block 0 writes %globaltimer (ns) where each of the first stamp_steps
// steps begins and after each of its barriers: the phases' times as they
// run on the co-resident grid, barrier waits included.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "answer.cuh"
#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// grid-stride loops: enough blocks to fill 132 SMs several times over
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRuns = 64;
// vectors a lane of a pull task gathers, and a lane of the run's commit and
// halo phases moves at once (2 and 4 measured alike at config 3, 1 and 8
// slower)
constexpr int kUnroll = 2;
// stamps a step of a measured keto_check_run (see the header)
constexpr int kStamps = 5;

__device__ __forceinline__ long long globaltimer_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

// The bucket runs of one pull: see the header. shape = is | ss << 8 | cs << 16
// | rs << 24 (a chunked run's row tasks, padded to 1 << rs).
struct PullRuns {
  const int32_t* nbrs[kMaxRuns];
  int32_t rows[kMaxRuns];
  int32_t cap[kMaxRuns];
  int32_t out[kMaxRuns];
  int32_t shape[kMaxRuns];
  int32_t warp0[kMaxRuns + 1];
  int32_t n;
};

// The overlay stage: row k ORs into P[(k / per) * stride + dst[k]], dropped
// unless 0 <= dst[k] < n_dst (unsharded: per = rows, stride 0, n_dst =
// n_active; sharded: per = K rows a shard, stride rps, n_dst = rps).
struct Overlay {
  const int32_t* nbrs;
  const int32_t* dst;
  int32_t rows, cap, per, stride, n_dst, shape, warps;
};

// The table in shared memory, for indexing by a run number.
struct RunsShared {
  const int32_t* nbrs[kMaxRuns];
  int32_t rows[kMaxRuns], cap[kMaxRuns], out[kMaxRuns], shape[kMaxRuns];
  int32_t warp0[kMaxRuns + 1];
};

__device__ __forceinline__ void load_runs(const PullRuns& t, RunsShared* s) {
  for (int r = threadIdx.x; r < t.n; r += blockDim.x) {
    s->nbrs[r] = t.nbrs[r];
    s->rows[r] = t.rows[r];
    s->cap[r] = t.cap[r];
    s->out[r] = t.out[r];
    s->shape[r] = t.shape[r];
  }
  for (int r = threadIdx.x; r <= t.n; r += blockDim.x) s->warp0[r] = t.warp0[r];
  __syncthreads();
}

__device__ __forceinline__ uint32_t vor(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint4 vor(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ bool vne(uint32_t a, uint32_t b) { return a != b; }
__device__ __forceinline__ bool vne(uint4 a, uint4 b) {
  return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0;
}
__device__ __forceinline__ uint32_t shfl_or(uint32_t v, int off) {
  return v | __shfl_xor_sync(kFull, v, off);
}
__device__ __forceinline__ uint4 shfl_or(uint4 v, int off) {
  return make_uint4(shfl_or(v.x, off), shfl_or(v.y, off), shfl_or(v.z, off), shfl_or(v.w, off));
}
__device__ __forceinline__ void or_into(uint32_t* p, uint32_t v) {
  if (v) atomicOr(p, v);
}
__device__ __forceinline__ void or_into(uint4* p, uint4 v) {
  uint32_t* w = reinterpret_cast<uint32_t*>(p);
  or_into(w, v.x);
  or_into(w + 1, v.y);
  or_into(w + 2, v.z);
  or_into(w + 3, v.w);
}
// the bits of `nxt` that `old` lacks
__device__ __forceinline__ unsigned popc_new(uint32_t nxt, uint32_t old) {
  return __popc(nxt & ~old);
}
__device__ __forceinline__ unsigned popc_new(uint4 nxt, uint4 old) {
  return popc_new(nxt.x, old.x) + popc_new(nxt.y, old.y) + popc_new(nxt.z, old.z) +
         popc_new(nxt.w, old.w);
}

// K1's device function: warp task `task` of one run (or of the overlay, with
// OVERLAY). A task is 32 >> (is + ss) rows, or, for a row wider than one
// warp's kUnroll vectors a lane, one chunk of kUnroll · 32 vectors of one row
// (1 << cs chunks a row): a wide row is spread over several warps, each
// with its loads in flight at once. Rows past the run's end, and dropped
// overlay rows, load nothing but still join the warp's shuffles. IT is the
// row's length in vectors. Source rows are read with plain loads: inside
// keto_check_run the commit writes them between pulls.
template <typename V, bool OVERLAY>
__device__ __forceinline__ void pull_task(const int32_t* __restrict__ nbrs, int rows, int cap,
                                          int shape, int out, const int32_t* __restrict__ dst,
                                          int per, int stride, int n_dst, int task, const V* src,
                                          V* __restrict__ P, unsigned IT, int lane) {
  const int is = shape & 0xff;
  const int ts = is + ((shape >> 8) & 0xff);
  const int cs = (shape >> 16) & 0xff;
  const int tl = lane & ((1 << ts) - 1);
  const int il = tl & ((1 << is) - 1);
  const int sl = tl >> is;
  const int ni = 1 << is, nsl = 1 << (ts - is);
  const int rs = (shape >> 24) & 0xff;
  const int ct = cs ? task >> rs : 0;
  const int rt = cs ? task & ((1 << rs) - 1) : task;
  const unsigned i0 = static_cast<unsigned>(ct) * (ni * kUnroll);
  const int row = (rt << (5 - ts)) + (lane >> ts);
  int orow = -1;
  if (row < rows && i0 < IT) {
    if (OVERLAY) {
      const int d = __ldg(dst + row);
      if (d >= 0 && d < n_dst) orow = (row / per) * stride + d;
    } else {
      orow = out + row;
    }
  }
  V acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = V{};
  if (orow >= 0) {
    const int32_t* ids = nbrs + static_cast<unsigned>(row) * static_cast<unsigned>(cap);
    for (int j = sl; j < cap; j += nsl) {
      const V* s = src + static_cast<unsigned>(__ldg(ids + j)) * IT;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned it = i0 + u * ni + il;
        if (it < IT) acc[u] = vor(acc[u], s[it]);
      }
    }
  }
  for (int off = ni; off < (1 << ts); off <<= 1) {  // uniform: one run a warp
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = shfl_or(acc[u], off);
  }
  if (orow >= 0 && sl == 0) {
    V* o = P + static_cast<unsigned>(orow) * IT;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned it = i0 + u * ni + il;
      if (it < IT) {
        if (OVERLAY) or_into(o + it, acc[u]);
        else __stcs(o + it, acc[u]);  // evict-first: keep L2 for the source rows
      }
    }
  }
}

// Every bucket run's tasks, a warp a task, in a grid of `nwarps` warps. The
// table is the launch's own parameter (keto_pull: its blocks are short, so
// they read it from the constant bank, warp-uniform, with no prologue) or a
// copy in shared memory (keto_check_run).
template <typename V, typename Table>
__device__ __forceinline__ void pull_runs(const Table& t, int n, const V* src, V* P, unsigned IT,
                                          int warp, int nwarps, int lane) {
  const int total = t.warp0[n];
  int r = 0;
  for (int task = warp; task < total; task += nwarps) {
    while (task >= t.warp0[r + 1]) ++r;  // tasks ascend: r only moves on
    pull_task<V, false>(t.nbrs[r], t.rows[r], t.cap[r], t.shape[r], t.out[r], nullptr, 0, 0, 0,
                        task - t.warp0[r], src, P, IT, lane);
  }
}

// keto_pull: every run's tasks in one full grid (a warp a task).
template <typename V>
__global__ void __launch_bounds__(kThreads)
pull_kernel(const __grid_constant__ PullRuns t, const V* R, V* __restrict__ P, unsigned IT) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  pull_runs<V>(t, t.n, R, P, IT, warp, (gridDim.x * blockDim.x) >> 5, threadIdx.x & 31);
}

// keto_check_run: the whole guarded fixpoint (see the header). halo = 0:
// unsharded, the pulls read R; halo > 0: the halo phase copies `halo` vectors
// of R into G each step run, and the pulls read G. `commit` vectors of R (the
// active prefix) take the commit.
template <typename V, bool COUNT>
__global__ void __launch_bounds__(kThreads)
check_run_kernel(const __grid_constant__ PullRuns t, const __grid_constant__ Overlay ov, V* R,
                 V* G, unsigned halo, V* P, unsigned commit, unsigned IT, int32_t it_cap,
                 int32_t block_iters, int32_t* ctl, long long* counts, long long* stamps,
                 int32_t stamp_steps, uint32_t* pop) {
  __shared__ RunsShared s;
  __shared__ int32_t s_last;
  load_runs(t, &s);
  cg::grid_group grid = cg::this_grid();
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const V* src = halo ? G : R;
  int it = 0, copies = 0;
  unsigned fresh = 0;  // COUNT: bits this thread's commits set
  bool changed = true;
  // stamp k of this step: 0 begun, 1 halo done, 2 pull done, 3 overlay done, 4 committed
  auto stamp = [&](int k) {
    if (stamps && tid == 0 && it < stamp_steps) stamps[it * kStamps + k] = globaltimer_ns();
  };
  for (;;) {
    if (it % block_iters == 0 && it >= it_cap) break;
    stamp(0);
    if (halo) {  // the all_gather: every shard's slab into the gathered bitmap
      for (unsigned i0 = tid; i0 < halo; i0 += kUnroll * nthreads) {
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned i = i0 + u * nthreads;
          if (i < halo) v[u] = R[i];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned i = i0 + u * nthreads;
          if (i < halo) G[i] = v[u];
        }
      }
      ++copies;
      grid.sync();
    }
    stamp(1);
    pull_runs<V>(s, t.n, src, P, IT, warp, nwarps, lane);
    grid.sync();
    stamp(2);
    if (ov.rows) {  // from the same snapshot as the buckets, after their rows
      for (int task = warp; task < ov.warps; task += nwarps)
        pull_task<V, true>(ov.nbrs, ov.rows, ov.cap, ov.shape, 0, ov.dst, ov.per, ov.stride,
                           ov.n_dst, task, src, P, IT, lane);
      grid.sync();
    }
    stamp(3);
    bool grew = false;
    for (unsigned i0 = tid; i0 < commit; i0 += kUnroll * nthreads) {
      V old[kUnroll], add[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = i0 + u * nthreads;
        if (i < commit) {
          old[u] = R[i];
          add[u] = P[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = i0 + u * nthreads;
        if (i < commit) {
          const V nxt = vor(old[u], add[u]);
          if (vne(nxt, old[u])) {
            R[i] = nxt;
            grew = true;
            if (COUNT) fresh += popc_new(nxt, old[u]);
          }
        }
      }
    }
    if (__any_sync(kFull, grew) && lane == 0) atomicMax(ctl + 2, it + 1);
    grid.sync();
    stamp(4);
    if (threadIdx.x == 0) s_last = *reinterpret_cast<volatile int32_t*>(ctl + 2);
    __syncthreads();
    changed = s_last >= it + 1;
    __syncthreads();  // s_last is rewritten after the next barrier only
    ++it;
    if (!changed) break;
  }
  if (COUNT) count_block<kThreads>(pop, fresh);  // every thread leaves on the same step
  if (tid == 0) {
    ctl[0] = changed ? 1 : 0;
    ctl[1] = it;
    if (counts) {
      atomicAdd(reinterpret_cast<unsigned long long*>(counts), static_cast<unsigned long long>(it));
      atomicAdd(reinterpret_cast<unsigned long long*>(counts + 1),
                static_cast<unsigned long long>(copies));
    }
  }
}

// Seed scatter: for each (row, query) entry of e1 and e2 whose row lies in
// [0, n_int], set the query's bit in R (and, for e2, in ans_base). The
// reference scatter-adds onto disjoint bits, so OR is exact; padding rows
// (n_int+1) fall outside and are dropped like its mode="drop". COUNT adds
// the bits of R that the atomicOr newly set (from the old value it returns,
// so an entry seeded twice counts once) into *pop, one atomicAdd a block.
template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
seed_kernel(const int32_t* __restrict__ entries, int64_t S1, int64_t S2, int32_t n_int,
            int32_t W, uint32_t* __restrict__ R, uint32_t* __restrict__ ans_base,
            uint32_t* __restrict__ pop) {
  const int64_t n = S1 + S2;
  unsigned fresh = 0;
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
    if (COUNT) {
      fresh += (atomicOr(R + at, bit) & bit) ? 0u : 1u;
    } else {
      atomicOr(R + at, bit);
    }
    if (e2) atomicOr(ans_base + at, bit);
  }
  if (COUNT) count_block<kThreads>(pop, fresh);
}

// K2's answer. Decisions: interior targets read P (the pull of the fixpoint)
// OR ans_base (the host-propagated one-hop term); sink targets OR the
// fixpoint bits of their interior in-neighbours. Bits pack into out[0:W];
// out[W] = iters, out[W+1] = truncated (changed at exit). `out` arrives
// zeroed.
//
// Bound: bytes, counted in sectors — each target reads its id (coalesced)
// and one word of a random P row and of a random ans_base row, each sink
// entry its (row, query) pair and one word of a random R row: from HBM a
// random word costs a 32-byte sector, so at most 32·(2B + SA) + 4·(B + 2SA)
// bytes (fewer where gathers share a sector). Design: a warp a tile of 32
// entries, the tiles walked grid-stride (uniform across the warp), about
// 1.5 waves of warps at config 3 (a warp holding four tiles in flight ran
// slower on the card, PERF.md §6). Tile w < W is the 32 targets of answer
// word w: each lane gathers its target's two words and tests its own bit,
// and __ballot_sync packs the word, written by lane 0 with one atomicOr
// (sinks may OR into the same word), none where it is 0 — W writes, where
// a thread an entry made up to B same-address atomics. A sink tile groups
// its hits by answer word and issues one atomicOr a distinct word
// (or_word_hits, K3's idiom).
__global__ void __launch_bounds__(kThreads)
answer_pack_kernel(const int32_t* __restrict__ entries, int64_t S1, int64_t S2, int64_t SA,
                   int32_t n_active, const uint32_t* __restrict__ P,
                   const uint32_t* __restrict__ ans_base, const uint32_t* __restrict__ R,
                   int32_t W, const int32_t* __restrict__ state, uint32_t* __restrict__ out) {
  const int32_t* a_rows = entries + 2 * S1 + 2 * S2;
  const int32_t* a_q = a_rows + SA;
  const int32_t* targets = a_q + SA;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  if (warp == 0 && lane == 0) {
    out[W] = state ? static_cast<uint32_t>(state[1]) : 0u;
    out[W + 1] = state ? static_cast<uint32_t>(state[0]) : 0u;
  }
  const int64_t tiles = W + ((SA + 31) >> 5);
  for (int64_t tile = warp; tile < tiles; tile += n_warps) {
    if (tile < W) {
      const int32_t t = targets[(tile << 5) + lane];
      const int32_t t_act = t < n_active ? t : n_active;
      const uint32_t word = P[(int64_t)t_act * W + tile] | ans_base[(int64_t)t * W + tile];
      const unsigned hits = __ballot_sync(kFull, (word >> lane) & 1u);
      if (lane == 0 && hits) atomicOr(out + tile, hits);
    } else {
      const int64_t j = ((tile - W) << 5) + lane;
      int32_t q = 0;
      bool hit = false;
      if (j < SA) {
        q = a_q[j];
        hit = (R[(int64_t)a_rows[j] * W + (q >> 5)] >> (q & 31)) & 1u;
      }
      or_word_hits(out, hit, q);
    }
  }
}

int ceil_log2(int64_t x) {
  int s = 0;
  while ((int64_t(1) << s) < x) ++s;
  return s;
}

// A team for rows of IT vectors and `cap` slots: item lanes cover the row up
// to a warp, slot lanes fill the rest of the warp up to the cap, and a row
// past one warp's kUnroll vectors a lane is cut into 1 << cs chunks.
int team_shape(unsigned IT, int cap) {
  const int is = ceil_log2(IT < 32 ? IT : 32);
  int ss = ceil_log2(cap);
  if (ss > 5 - is) ss = 5 - is;
  const int cs = ceil_log2((IT + 32 * kUnroll - 1) / (32 * kUnroll));
  return is | (ss << 8) | (cs << 16);
}

int64_t warps_for(int rows, int& shape) {
  const int per = 32 >> ((shape & 0xff) + ((shape >> 8) & 0xff));
  const int64_t rt = (rows + per - 1) / per;
  const int cs = (shape >> 16) & 0xff;
  if (!cs) return rt;
  const int rs = ceil_log2(rt);  // chunk-major: the run's row tasks padded to 1 << rs
  shape |= rs << 24;
  return (int64_t(1) << rs) << cs;
}

// The table from the host arrays; every run must have cap >= 1 and rows >= 0.
cudaError_t make_runs(const int64_t* nbrs, const int32_t* rows, const int32_t* caps,
                      const int32_t* outs, int32_t n, unsigned IT, PullRuns* t) {
  if (n < 0 || n > kMaxRuns) return cudaErrorInvalidValue;
  t->n = n;
  int64_t w = 0;
  for (int r = 0; r < n; ++r) {  // warp0 stays below 2^31
    if (rows[r] < 0 || caps[r] < 1 || outs[r] < 0) return cudaErrorInvalidValue;
    t->nbrs[r] = reinterpret_cast<const int32_t*>(nbrs[r]);
    t->rows[r] = rows[r];
    t->cap[r] = caps[r];
    t->out[r] = outs[r];
    t->shape[r] = team_shape(IT, caps[r]);
    t->warp0[r] = static_cast<int32_t>(w);
    w += warps_for(rows[r], t->shape[r]);
    if (w >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  }
  t->warp0[n] = static_cast<int32_t>(w);
  return cudaSuccess;
}

bool vec4(int32_t W, const void* a, const void* b, const void* c) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return W % 4 == 0 && addr % 16 == 0;
}

template <typename V>
cudaError_t launch_pull(const PullRuns& t, const uint32_t* R, uint32_t* P, unsigned IT,
                        cudaStream_t s) {
  const int64_t blocks = (static_cast<int64_t>(t.warp0[t.n]) + kWarps - 1) / kWarps;
  if (blocks == 0) return cudaSuccess;
  pull_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      t, reinterpret_cast<const V*>(R), reinterpret_cast<V*>(P), IT);
  return cudaGetLastError();
}

template <typename V, bool COUNT>
cudaError_t launch_run(const PullRuns& t, const Overlay& ov, uint32_t* R, uint32_t* G,
                       int32_t halo_rows, uint32_t* P, int32_t commit_rows, unsigned IT,
                       int32_t it_cap, int32_t block_iters, int32_t* ctl, int64_t* counts,
                       int64_t* stamps, int32_t stamp_steps, uint32_t* pop, cudaStream_t s) {
  V* Rv = reinterpret_cast<V*>(R);
  V* Gv = reinterpret_cast<V*>(G);
  V* Pv = reinterpret_cast<V*>(P);
  unsigned halo = static_cast<unsigned>(halo_rows) * IT;
  unsigned commit = static_cast<unsigned>(commit_rows) * IT;
  long long* cnt = reinterpret_cast<long long*>(counts);
  long long* stm = reinterpret_cast<long long*>(stamps);
  int64_t work = 32 * static_cast<int64_t>(t.warp0[t.n] > ov.warps ? t.warp0[t.n] : ov.warps);
  if (halo > work) work = halo;
  if (commit > work) work = commit;
  int grid = 0;
  cudaError_t e = coresident_grid(check_run_kernel<V, COUNT>, kThreads, work, &grid);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<PullRuns*>(&t), const_cast<Overlay*>(&ov), &Rv, &Gv, &halo, &Pv,
                  &commit, &IT, &it_cap, &block_iters, &ctl, &cnt, &stm, &stamp_steps, &pop};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(check_run_kernel<V, COUNT>), grid,
                                  kThreads, args, 0, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry points (ctypes). Each launches on `stream` and returns the
// launch's error code, or cudaGetLastError(), so a refused launch surfaces in
// the Python wrapper. `nbrs`, `rows`, `caps` and `outs` are host arrays of
// `n` bucket runs.

extern "C" int keto_seed(const int32_t* entries, int64_t S1, int64_t S2,
                         int32_t n_int, int32_t W, uint32_t* R,
                         uint32_t* ans_base, uint32_t* pop, void* stream) {
  const int blocks = blocks_for(S1 + S2);
  cudaStream_t s = (cudaStream_t)stream;
  if (pop)
    seed_kernel<true><<<blocks, kThreads, 0, s>>>(entries, S1, S2, n_int, W, R, ans_base, pop);
  else
    seed_kernel<false><<<blocks, kThreads, 0, s>>>(entries, S1, S2, n_int, W, R, ans_base, pop);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_pull(const int64_t* nbrs, const int32_t* rows, const int32_t* caps,
                         const int32_t* outs, int32_t n, const uint32_t* R, uint32_t* P,
                         int32_t W, void* stream) {
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = vec4(W, R, P, P);
  const unsigned IT = v4 ? W / 4 : W;
  PullRuns t;
  cudaError_t e = make_runs(nbrs, rows, caps, outs, n, IT, &t);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = (cudaStream_t)stream;
  e = v4 ? launch_pull<uint4>(t, R, P, IT, s) : launch_pull<uint32_t>(t, R, P, IT, s);
  return static_cast<int>(e);
}

extern "C" int keto_check_run(const int64_t* nbrs, const int32_t* rows, const int32_t* caps,
                              const int32_t* outs, int32_t n, const int32_t* ov_nbrs,
                              const int32_t* ov_dst, int32_t ov_rows, int32_t ov_cap,
                              int32_t ov_per, int32_t ov_stride, int32_t n_dst, uint32_t* R,
                              uint32_t* G, int32_t halo_rows, uint32_t* P, int32_t commit_rows,
                              int32_t W, int32_t it_cap, int32_t block_iters, int32_t* ctl,
                              int64_t* counts, int64_t* stamps, int32_t stamp_steps,
                              uint32_t* pop, void* stream) {
  if (W < 1 || block_iters < 1 || halo_rows < 0 || commit_rows < 0 || (halo_rows && !G) ||
      stamp_steps < 0 ||
      (ov_rows > 0 && (ov_cap < 1 || ov_per < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = vec4(W, R, P, halo_rows ? G : R);
  const unsigned IT = v4 ? W / 4 : W;
  PullRuns t;
  cudaError_t e = make_runs(nbrs, rows, caps, outs, n, IT, &t);
  if (e != cudaSuccess) return static_cast<int>(e);
  Overlay ov{ov_nbrs, ov_dst, ov_rows > 0 ? ov_rows : 0, ov_cap, ov_per, ov_stride, n_dst, 0, 0};
  if (ov.rows) {
    ov.shape = team_shape(IT, ov_cap);
    const int64_t w = warps_for(ov.rows, ov.shape);
    if (w >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
    ov.warps = static_cast<int32_t>(w);
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (v4)
    e = pop ? launch_run<uint4, true>(t, ov, R, G, halo_rows, P, commit_rows, IT, it_cap,
                                      block_iters, ctl, counts, stamps, stamp_steps, pop, s)
            : launch_run<uint4, false>(t, ov, R, G, halo_rows, P, commit_rows, IT, it_cap,
                                       block_iters, ctl, counts, stamps, stamp_steps, pop, s);
  else
    e = pop ? launch_run<uint32_t, true>(t, ov, R, G, halo_rows, P, commit_rows, IT, it_cap,
                                         block_iters, ctl, counts, stamps, stamp_steps, pop, s)
            : launch_run<uint32_t, false>(t, ov, R, G, halo_rows, P, commit_rows, IT, it_cap,
                                          block_iters, ctl, counts, stamps, stamp_steps, pop, s);
  return static_cast<int>(e);
}

extern "C" int keto_answer_pack(const int32_t* entries, int64_t S1, int64_t S2,
                                int64_t SA, int64_t B, int32_t n_active,
                                const uint32_t* P, const uint32_t* ans_base,
                                const uint32_t* R, int32_t W,
                                const int32_t* state, uint32_t* out,
                                void* stream) {
  if (W < 1 || B != 32 * static_cast<int64_t>(W) || SA < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  answer_pack_kernel<<<blocks_for(32 * (W + (SA + 31) / 32)), kThreads, 0,
                       (cudaStream_t)stream>>>(
      entries, S1, S2, SA, n_active, P, ans_base, R, W, state, out);
  return static_cast<int>(cudaGetLastError());
}
