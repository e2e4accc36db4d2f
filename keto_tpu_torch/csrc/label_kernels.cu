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
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kIntMax = 0x7fffffff;

// K3 and K4: the label route's pair compare. Per pair (a, b), which entries
// of OUT(a) equal some entry of IN(b)? K3 reduces the answer to one bit per
// pair and ORs it into the pair's query bit; K4 to the smallest matching
// entry. Both run one compare core (pair_compare) under one tiling:
//
// - A team of t lanes a pair, t a power of two <= 32, chosen on the host
//   from Wo (kernels.label_team): each lane holds up to K <= 4 OUT entries
//   in registers, t·K >= Wo up to 128 entries, chunks of t·K beyond. A warp
//   compares 32/t pairs at once, so at narrow widths every lane works (the
//   first design gave each pair a whole warp, one entry a lane).
// - A warp takes a tile of 32 pairs: lane l reads pair l's (a, b, q), one
//   coalesced 128-byte load per array. The teams take the tile's pairs in t
//   rounds of 32/t, (a, b) handed over by shuffle, R = 2 rounds at a time
//   where t >= 2 and the call has more than one round of pairs: the loads
//   of both rounds are issued before either's compares. A round with no
//   pair (a short tile) is skipped. After the rounds lane l holds pair l's
//   answer. Lane and team indices are shifts and masks, never divisions by
//   t (with them, and 64-bit row tests, K3 took a fifth longer at config 4,
//   PERF.md).
// - OUT entries: one 16-byte load a lane where Wo % 4 == 0 and the rows are
//   16-byte aligned (K = 4, lane `sub` holds entries 4·sub .. 4·sub+3 of the
//   chunk), else K scalar loads strided by t (coalesced across the team). A
//   slot past the row holds the chunk's first entry again, a real entry of
//   the row, so it changes neither the team's "any" nor its minimum.
// - IN entries: every lane of the team reads the whole IN row (one
//   broadcast load a team) in batches of loads issued together before any
//   compare — 16-byte vectors where Wi % 4 == 0 and the rows are aligned,
//   else scalars, 16 entries a pair a batch at R = 1 and 8 at R = 2; a load
//   past the row repeats the batch's first one, which changes no answer.
//   So a narrow row is one round trip to the cache, not a chain of loads
//   each waiting on the last, and no branch stands between a chunk's loads
//   and its compares. Where one chunk and one batch cover both rows (every
//   OUT width up to 128 with IN widths up to 8 or 16), the kernel is a
//   version with no loop at all.
// - Brute force: no order of the entries is assumed; OUT_PAD (-1) and
//   IN_PAD (-2) never compare equal; pad pairs name the all-pad row; a pair
//   naming a row outside [0, rows) matches nothing.
//
// Bound: bytes at the label route's widths — each pair's (a, b, q) once,
// each distinct label row the pairs name once, the answer once — against
// operations (the Wo·Wi int32 compares of a pair's valid entries) at wide
// rows. At config 4 the label arrays (a few MB) stay in the 50 MB L2, so
// the row gathers are L2 traffic and the entries the device-memory bytes;
// the kernel's time goes to the instructions it issues (a compare for
// every slot pair, pads included, and the bookkeeping around them) more
// than to either bound.
template <int K, bool MIN>
__device__ __forceinline__ void compare_in(const int32_t (&x)[K], int32_t y, bool (&m)[MIN ? K : 1]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (MIN) m[s] |= x[s] == y;
    else m[0] |= x[s] == y;
  }
}

// Lane `sub`'s OUT entries of the chunk at c0 into x. A slot past the row
// loads the chunk's first entry instead: a real entry of the same row, which
// lane 0 of the team also holds, so the team's "any" and minimum stay the
// same, and no load waits on a branch.
template <int K, bool VO>
__device__ __forceinline__ void load_out(const int32_t* __restrict__ orow, int32_t Wo, int c0,
                                         int t, int sub, int32_t (&x)[K]) {
  if (VO) {
    const int i = c0 + 4 * sub < Wo ? c0 + 4 * sub : c0;
    const int4 v = __ldg(reinterpret_cast<const int4*>(orow + i));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int i = c0 + s * t + sub;
      x[s] = __ldg(orow + (i < Wo ? i : c0));
    }
  }
}

// The compare core for one lane of a team of t (`sub` its index in the
// team), on R pairs at once. found[r]: whether any of the lane's OUT entries
// of pair r matched an IN entry; with MIN, best[r] is lowered to the
// smallest matching entry. A pair with ok[r] false (a row outside the
// arrays) reads row 0 and is masked out after. VO and VI: the 16-byte loads
// (VO needs K == 4). Every load of a chunk is issued before its compares,
// with no branch between them; without MIN the lane stops after the first
// chunk in which all its pairs matched.
template <int K, bool VO, bool VI, bool MIN, int R, bool ONE>
__device__ __forceinline__ void pair_compare(const int32_t* const (&orow)[R],
                                             const int32_t* const (&irow)[R],
                                             const bool (&ok)[R], int32_t Wo, int32_t Wi,
                                             int t, int sub, bool (&found)[R],
                                             int32_t (&best)[R]) {
  static_assert(!VO || K == 4, "a 16-byte OUT load holds four entries");
  constexpr int kVecs = 4 / R;      // 16-byte IN loads a pair a batch
  constexpr int kScalars = 16 / R;  // scalar IN loads a pair a batch
  const int c_end = ONE ? 1 : Wo, j_end = ONE ? 1 : Wi;  // ONE: one chunk, one batch
  for (int c0 = 0; c0 < c_end; c0 += K * t) {
    if (!MIN) {
      bool open = false;
#pragma unroll
      for (int r = 0; r < R; ++r) open |= !found[r];
      if (!open) break;
    }
    int32_t x[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r) load_out<K, VO>(orow[r], Wo, c0, t, sub, x[r]);
    bool m[R][MIN ? K : 1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < (MIN ? K : 1); ++s) m[r][s] = false;
    if (VI) {
      for (int j0 = 0; j0 < j_end; j0 += 4 * kVecs) {
        int4 y[R][kVecs];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int u = 0; u < kVecs; ++u) {
            const int j = j0 + 4 * u < Wi ? j0 + 4 * u : j0;
            y[r][u] = __ldg(reinterpret_cast<const int4*>(irow[r] + j));
          }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int u = 0; u < kVecs; ++u) {
            compare_in<K, MIN>(x[r], y[r][u].x, m[r]);
            compare_in<K, MIN>(x[r], y[r][u].y, m[r]);
            compare_in<K, MIN>(x[r], y[r][u].z, m[r]);
            compare_in<K, MIN>(x[r], y[r][u].w, m[r]);
          }
      }
    } else {
      for (int j0 = 0; j0 < j_end; j0 += kScalars) {
        int32_t y[R][kScalars];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int u = 0; u < kScalars; ++u) y[r][u] = __ldg(irow[r] + (j0 + u < Wi ? j0 + u : j0));
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int u = 0; u < kScalars; ++u) compare_in<K, MIN>(x[r], y[r][u], m[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (MIN) {
#pragma unroll
        for (int s = 0; s < K; ++s)
          if (m[r][s] && ok[r]) {
            found[r] = true;
            best[r] = x[r][s] < best[r] ? x[r][s] : best[r];
          }
      } else {
        found[r] |= m[r][0] && ok[r];
      }
    }
  }
}

// Whether team g's lanes (bits [g·t, g·t + t) of a ballot) voted.
__device__ __forceinline__ bool team_voted(unsigned ballot, int g, int t) {
  const unsigned low = t == 32 ? kFull : (1u << t) - 1u;
  return ((ballot >> (g * t)) & low) != 0u;
}

// One tile's rounds for lane `lane` of a warp whose lanes hold the tile's
// pairs (a, b): R rounds at a time, each team on pair (round·32/t + team).
// `rows` is the arrays' row count, at most 2^31 (an int32 row id below it,
// read unsigned, is inside the arrays).
// Calls fold(round, r, found, best) after each R rounds' compare with the
// lane's own answers; every lane of the warp reaches every call.
template <int K, bool VO, bool VI, bool MIN, int R, bool ONE, typename Fold>
__device__ __forceinline__ void tile_rounds(const int32_t* __restrict__ out_lab, int32_t Wo,
                                            const int32_t* __restrict__ in_lab, int32_t Wi,
                                            uint32_t rows, int32_t a, int32_t b, int t,
                                            Fold fold) {
  const int lane = threadIdx.x & 31;
  const int lt = __ffs(t) - 1;  // t is a power of two: shifts, not divisions
  const int per = 32 >> lt;
  const int team = lane >> lt, sub = lane & (t - 1);
  for (int r0 = 0; r0 < t; r0 += R) {
    const int32_t* orow[R];
    const int32_t* irow[R];
    bool ok[R], found[R];
    int32_t best[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t ra = __shfl_sync(kFull, a, (r0 + r) * per + team);
      const int32_t rb = __shfl_sync(kFull, b, (r0 + r) * per + team);
      ok[r] = static_cast<uint32_t>(ra) < rows && static_cast<uint32_t>(rb) < rows;
      orow[r] = out_lab + (int64_t)(ok[r] ? ra : 0) * Wo;
      irow[r] = in_lab + (int64_t)(ok[r] ? rb : 0) * Wi;
      found[r] = false;
      best[r] = kIntMax;
    }
    bool any = false;
#pragma unroll
    for (int r = 0; r < R; ++r) any |= ok[r];
    if (__any_sync(kFull, any))  // rounds past a short tile's pairs are skipped
      pair_compare<K, VO, VI, MIN, R, ONE>(orow, irow, ok, Wo, Wi, t, sub, found, best);
#pragma unroll
    for (int r = 0; r < R; ++r) fold(r0 + r, found[r], best[r]);
  }
}

// K3. A hit sets the owning query's bit in `out` (zeroed by the caller): the
// reference's `at[pq].max` followed by its bit pack. After its tile's rounds
// the warp groups its hitting lanes by answer word (q >> 5) with
// __match_any_sync, ORs each group's bits with __reduce_or_sync, and one lane
// of each group issues one atomicOr: one atomic per distinct word per warp,
// correct in any order of pq and one atomic a warp in the engine's order
// (pairs sorted by query, pads with pq = 0 after them, never hitting).
template <int K, bool VO, bool VI, int R, bool ONE>
__global__ void __launch_bounds__(kThreads)
label_step_kernel(const int32_t* __restrict__ out_lab, int32_t Wo,
                  const int32_t* __restrict__ in_lab, int32_t Wi, int64_t rows,
                  const int32_t* __restrict__ entries, int64_t P, int32_t t,
                  uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int lt = __ffs(t) - 1;
  const int per = 32 >> lt;  // pairs a round
  const int mine = lane & (per - 1), my_round = lane >> (5 - lt);  // where lane l's pair is
  const uint32_t nrows = rows < (1ll << 31) ? static_cast<uint32_t>(rows) : 1u << 31;
  const int64_t tiles = (P + 31) >> 5;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t tile = warp; tile < tiles; tile += n_warps) {  // uniform across the warp
    const int64_t p = (tile << 5) + lane;
    int32_t a = -1, b = -1, q = 0;
    if (p < P) {
      a = entries[p];
      b = entries[P + p];
      q = entries[2 * P + p];
    }
    bool hit = false;
    auto fold = [&](int round, bool found, int32_t) {
      const unsigned voted = __ballot_sync(kFull, found);
      if (my_round == round) hit = team_voted(voted, mine, t);
    };
    tile_rounds<K, VO, VI, false, R, ONE>(out_lab, Wo, in_lab, Wi, nrows, a, b, t, fold);
    const unsigned hits = __ballot_sync(kFull, hit);
    if (hit) {
      const unsigned group = __match_any_sync(hits, q >> 5);
      const unsigned bits = __reduce_or_sync(group, 1u << (q & 31));
      if (lane == __ffs(group) - 1) atomicOr(out + (q >> 5), bits);
    }
  }
}

// K4. The smallest matching OUT(a) entry, or -1 when none matches (the
// reference's argmin over the same compare K3 reduces to one bit): each lane
// of the team takes the minimum of its matching entries (INT_MAX when none),
// the team takes its minimum by xor shuffles within the team and a ballot
// for "found", and lane l of the tile writes pair l's answer (one coalesced
// store a tile). Every output word is written; a pair naming a row outside
// [0, rows) writes -1. The explain path launches it with one pair: one warp.
// (__reduce_min_sync over each team's lane mask, 16 masks in one warp at
// t = 2, took the one-pair launch from 2.2 to 3.9 µs on the H100, PERF.md.)
template <int K, bool VO, bool VI, int R, bool ONE>
__global__ void __launch_bounds__(kThreads)
label_witness_kernel(const int32_t* __restrict__ out_lab, int32_t Wo,
                     const int32_t* __restrict__ in_lab, int32_t Wi, int64_t rows,
                     const int32_t* __restrict__ pa, const int32_t* __restrict__ pb, int64_t P,
                     int32_t t, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int lt = __ffs(t) - 1;
  const int per = 32 >> lt;  // pairs a round
  const int mine = lane & (per - 1), my_round = lane >> (5 - lt);  // where lane l's pair is
  const uint32_t nrows = rows < (1ll << 31) ? static_cast<uint32_t>(rows) : 1u << 31;
  const int64_t tiles = (P + 31) >> 5;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t tile = warp; tile < tiles; tile += n_warps) {  // uniform across the warp
    const int64_t p = (tile << 5) + lane;
    int32_t a = -1, b = -1;
    if (p < P) {
      a = pa[p];
      b = pb[p];
    }
    int32_t res = -1;
    auto fold = [&](int round, bool found, int32_t best) {
      for (int off = t >> 1; off; off >>= 1) {  // the team's minimum
        const int32_t other = __shfl_xor_sync(kFull, best, off);
        best = other < best ? other : best;
      }
      const unsigned voted = __ballot_sync(kFull, found);
      const int32_t v = __shfl_sync(kFull, best, mine << lt);
      if (my_round == round) res = team_voted(voted, mine, t) ? v : -1;
    };
    tile_rounds<K, VO, VI, true, R, ONE>(out_lab, Wo, in_lab, Wi, nrows, a, b, t, fold);
    if (p < P) out[p] = res;
  }
}

// The launch of a pair kernel: a warp a tile of 32 pairs, blocks of up to 8
// warps (one warp for one tile: the explain path's single pair), the tiles
// walked grid-stride past kPairBlocks.
constexpr int64_t kPairBlocks = 132 * 64;

inline void pair_grid(int64_t P, int* blocks, int* threads) {
  const int64_t tiles = (P + 31) / 32;
  const int64_t per = tiles < kThreads / 32 ? (tiles < 1 ? 1 : tiles) : kThreads / 32;
  int64_t b = (tiles + per - 1) / per;
  if (b < 1) b = 1;
  if (b > kPairBlocks) b = kPairBlocks;
  *blocks = static_cast<int>(b);
  *threads = static_cast<int>(32 * per);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The shape a launch takes: K registers of OUT entries a lane, which sides
// read 16 bytes at a time, the rounds compared at once (two where the team
// is narrower than the warp, holds three or four entries a lane — always
// so at t >= 2 — and the pairs fill more than one round; one for the
// explain path's single pair), and whether one chunk and one IN batch
// cover the rows (the code for it has no loop). Returns false for a team
// or K the kernels do not take.
struct PairShape {
  int K, R;
  bool vo, vi, one;
};

inline bool pair_shape(const int32_t* out_lab, int32_t Wo, const int32_t* in_lab, int32_t Wi,
                       int64_t P, int32_t t, int32_t k, PairShape* sh) {
  if (t < 1 || t > 32 || (t & (t - 1)) || k < 1 || Wo < 0 || Wi < 0) return false;
  sh->vo = Wo % 4 == 0 && k >= 4 && aligned16(out_lab);
  sh->vi = Wi % 4 == 0 && aligned16(in_lab);
  sh->K = k < 4 ? k : 4;
  sh->R = t >= 2 && sh->K >= 3 && P > 32 / t ? 2 : 1;
  // one chunk of OUT entries and one batch of IN loads: no loop at all
  sh->one = Wo >= 1 && Wi >= 1 && Wo <= (sh->vo ? 4 : sh->K) * t && Wi <= 16 / sh->R;
  return true;
}

using StepKernel = void (*)(const int32_t*, int32_t, const int32_t*, int32_t, int64_t,
                            const int32_t*, int64_t, int32_t, uint32_t*);
using WitnessKernel = void (*)(const int32_t*, int32_t, const int32_t*, int32_t, int64_t,
                               const int32_t*, const int32_t*, int64_t, int32_t, int32_t*);

template <int K, bool VO, int R>
StepKernel step_kernel(const PairShape& sh) {
  if (sh.vi)
    return sh.one ? &label_step_kernel<K, VO, true, R, true>
                  : &label_step_kernel<K, VO, true, R, false>;
  return sh.one ? &label_step_kernel<K, VO, false, R, true>
                : &label_step_kernel<K, VO, false, R, false>;
}

template <int K, bool VO, int R>
WitnessKernel witness_kernel(const PairShape& sh) {
  if (sh.vi)
    return sh.one ? &label_witness_kernel<K, VO, true, R, true>
                  : &label_witness_kernel<K, VO, true, R, false>;
  return sh.one ? &label_witness_kernel<K, VO, false, R, true>
                : &label_witness_kernel<K, VO, false, R, false>;
}

StepKernel pick_step(const PairShape& sh) {
  if (sh.R == 2) {
    if (sh.vo) return step_kernel<4, true, 2>(sh);
    return sh.K == 3 ? step_kernel<3, false, 2>(sh) : step_kernel<4, false, 2>(sh);
  }
  if (sh.vo) return step_kernel<4, true, 1>(sh);
  switch (sh.K) {
    case 1: return step_kernel<1, false, 1>(sh);
    case 2: return step_kernel<2, false, 1>(sh);
    case 3: return step_kernel<3, false, 1>(sh);
    default: return step_kernel<4, false, 1>(sh);
  }
}

WitnessKernel pick_witness(const PairShape& sh) {
  if (sh.R == 2) {
    if (sh.vo) return witness_kernel<4, true, 2>(sh);
    return sh.K == 3 ? witness_kernel<3, false, 2>(sh) : witness_kernel<4, false, 2>(sh);
  }
  if (sh.vo) return witness_kernel<4, true, 1>(sh);
  switch (sh.K) {
    case 1: return witness_kernel<1, false, 1>(sh);
    case 2: return witness_kernel<2, false, 1>(sh);
    case 3: return witness_kernel<3, false, 1>(sh);
    default: return witness_kernel<4, false, 1>(sh);
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
                               int32_t team, int32_t k, uint32_t* out, void* stream) {
  PairShape sh;
  if (!pair_shape(out_lab, Wo, in_lab, Wi, P, team, k, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows < 1) return static_cast<int>(cudaSuccess);  // no pair names a row: no hit
  int blocks = 0, threads = 0;
  pair_grid(P, &blocks, &threads);
  const StepKernel kernel = pick_step(sh);
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out_lab, Wo, in_lab, Wi, rows, entries, P,
                                                       team, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_label_witness(const int32_t* out_lab, int32_t Wo, const int32_t* in_lab,
                                  int32_t Wi, int64_t rows, const int32_t* pa, const int32_t* pb,
                                  int64_t P, int32_t team, int32_t k, int32_t* out,
                                  void* stream) {
  PairShape sh;
  if (!pair_shape(out_lab, Wo, in_lab, Wi, P, team, k, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows < 1)  // no pair names a row: every answer is -1
    return static_cast<int>(cudaMemsetAsync(out, 0xff, 4 * P, (cudaStream_t)stream));
  int blocks = 0, threads = 0;
  pair_grid(P, &blocks, &threads);
  const WitnessKernel kernel = pick_witness(sh);
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out_lab, Wo, in_lab, Wi, rows, pa, pb, P,
                                                       team, out);
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
