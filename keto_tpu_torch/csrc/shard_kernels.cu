// Sharded-serving kernels for Hopper (sm_90a): the shard-local pieces of the
// row-range sharded Check, label step and label build.
//
// Replaces the shard-local work of the shard_map programs of
// keto_tpu/parallel/sharded.py (K10):
//   K10a `sharded_check_step`       (:327) -> keto_shard_answer, ONE launch over
//        every shard, after K2's keto_seed per shard and keto_check_run over
//        every shard at once (csrc/check_kernels.cu): its halo phase copies
//        the slabs each hop, and the seeds and the run count the frontier
//        bits they set
//   K10b `sharded_label_step`       (:473) -> keto_pair_gather per side, then
//        K3's keto_label_step on the exchanged pair rows
//   K10c `sharded_label_sweep_step` (:559) -> K6's keto_sweep_run over every
//        shard at once (csrc/label_kernels.cu): its n_dst drops the
//        sentinel and its halo phase copies the slabs between waves
// The halo all-gather, the counterpart of lax.all_gather, is thus a phase of
// a persistent kernel: a device copy of every shard slab between two grid
// barriers (the shards share one card). The reductions across shards (psum
// of the changed flag, the visit count and the popcount, the OR of the
// answers) are kernels of all shards accumulating into one word or buffer
// on the device; the popcount is added where its bits are set (by the
// seeds and the run's commits), never by a read of R.
//
// Shard s owns global rows [s*rps, (s+1)*rps). A local row at rps or beyond
// is the "not owned / padding" sentinel: scatters drop it and gathers read
// it as zero, never clamped into a row. Torch holds every array as int32;
// bitmaps are read as uint32.

#include <cstdint>
#include <cuda_runtime.h>

#include "answer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr unsigned kFull = 0xffffffffu;

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

// K10a's answer, every shard in one launch. Shard s's entries are row s of
// `entries` ([g, L]); its rows of P, ans_base and R are [s·rps, (s+1)·rps)
// of the [g·rps, W] bitmaps. Targets read the owning shard's last pull P OR
// its one-hop term ans_base; sink answer gathers read its fixpoint R. Only
// rows a shard owns (local row in [0, rps)) contribute, OR-combined across
// the shards into out[0:W]; out[W], out[W+1] take iters and the changed
// flag from the shared state. out[W+2], the psum of the frontier bits,
// holds what the seeds and the run counted where they set the bits: this
// kernel does not touch it. `out` arrives zeroed before the seeds.
//
// Bound: bytes, counted in sectors — each target reads its id on every
// shard (coalesced) and one word of a random P and ans_base row on its
// owner, each sink entry its pair (coalesced) and, where its shard owns
// the row, one word of a random R row: 4·g·B + 64·(owned targets) +
// 8·g·SA + 32·(owned sink entries) bytes, fewer where gathers share a
// sector. Design: K2's answer over every shard, a warp a tile of 32
// entries. Tile w < W is answer word w: each lane loops over the g shards'
// ids of its query (loading eight ids at once measured no faster, PERF.md
// §6), gathers on each shard that owns the row, tests its bit, and one
// ballot and one atomicOr by lane 0 write the word. The g·ceil(SA/32) sink
// tiles follow, shard-major; a tile groups its hits by answer word, one
// atomicOr a distinct word (or_word_hits).
__global__ void __launch_bounds__(kThreads)
shard_answer_kernel(const int32_t* __restrict__ entries, int64_t L, int32_t g, int64_t S1,
                    int64_t S2, int64_t SA, int32_t rps, const uint32_t* __restrict__ P,
                    const uint32_t* __restrict__ ans_base, const uint32_t* __restrict__ R,
                    int32_t W, const int32_t* __restrict__ state, uint32_t* __restrict__ out) {
  const int64_t a0 = 2 * S1 + 2 * S2, t0 = a0 + 2 * SA;  // a_rows and targets in a row
  const int lane = threadIdx.x & 31;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  if (warp == 0 && lane == 0) {
    out[W] = static_cast<uint32_t>(state[1]);
    out[W + 1] = static_cast<uint32_t>(state[0]);
  }
  const int64_t per = (SA + 31) >> 5;  // sink tiles a shard
  const int64_t tiles = W + g * per;
  for (int64_t tile = warp; tile < tiles; tile += n_warps) {
    if (tile < W) {
      const int64_t q = (tile << 5) + lane;
      uint32_t word = 0;
      for (int32_t s = 0; s < g; ++s) {
        const int32_t t = entries[s * L + t0 + q];
        if (t >= 0 && t < rps) {
          const int64_t at = ((int64_t)s * rps + t) * W + tile;
          word |= P[at] | ans_base[at];
        }
      }
      const unsigned hits = __ballot_sync(kFull, (word >> lane) & 1u);
      if (lane == 0 && hits) atomicOr(out + tile, hits);
    } else {
      const int64_t s = (tile - W) / per;
      const int64_t j = ((tile - W - s * per) << 5) + lane;
      int32_t q = 0;
      bool hit = false;
      if (j < SA) {
        const int32_t r = entries[s * L + a0 + j];
        q = entries[s * L + a0 + SA + j];
        if (r >= 0 && r < rps) hit = (R[(s * rps + r) * W + (q >> 5)] >> (q & 31)) & 1u;
      }
      or_word_hits(out, hit, q);
    }
  }
}

// K10b, the pair-row exchange of one side, as one owner gather:
// out[p] = lab[s][rows[p] - s*rl] where shard s = rows[p] / rl owns the row
// (0 <= rows[p] < g*rl), and out[p] = 0 for a row no shard owns (negative,
// or at or past g*rl): the reference's psum over shards of "the owned row,
// else 0" (sharded.py:500-514), since exactly one shard owns each row of
// [0, g*rl). Pads inside a stripe (OUT -1, IN -2) come through as they are.
// It replaces one launch per shard and side that added each owned row into
// a zeroed buffer.
//
// Bound: bytes — 4*P for `rows`, each stripe row the pairs name read once
// (4*w a distinct row, at most the stripes' 4*g*rl*w), and 4*P*w written.
// Design: one thread per (pair, chunk), the chunk fastest, so a warp reads
// and writes contiguous runs of rows; each thread reads rows[p] once, finds
// the owner and the local row, reads that stripe's row and writes every
// output word exactly once (no zeroed buffer, no read of `out`). A chunk is
// an int4 (V = int4) where w % 4 == 0 and both arrays are 16-byte aligned,
// else one word. The index arithmetic is 32-bit (I = uint32_t) wherever
// every index fits: at 2 chunks a row, two 64-bit divisions a chunk cost
// about as much as its bytes. The stripes arrive as one [g, rl, w] array
// (stripe s at lab + s*rl*w); a multi-card mesh will hand the kernel
// per-stripe pointers instead.
template <typename V, typename I>
__global__ void pair_gather_kernel(const V* __restrict__ lab, I rl, I g, I wv,
                                   const int32_t* __restrict__ rows, I P, V* __restrict__ out) {
  const I n = P * wv;
  for (I idx = blockIdx.x * (I)blockDim.x + threadIdx.x; idx < n;
       idx += (I)gridDim.x * blockDim.x) {
    const I p = idx / wv;
    const I j = idx - p * wv;
    const int32_t r = __ldg(rows + p);
    V v{};
    if (r >= 0 && (I)r < g * rl) {
      const I s = (I)r / rl;
      const V* stripe = lab + s * rl * wv;
      v = stripe[((I)r - s * rl) * wv + j];
    }
    out[idx] = v;
  }
}

template <typename V>
void launch_pair_gather(const V* lab, int64_t rl, int32_t g, int32_t wv,
                        const int32_t* rows, int64_t P, V* out, cudaStream_t s) {
  const int64_t n = P * wv;
  const int64_t small = int64_t(1) << 31;
  if (n < small && (int64_t)g * rl * wv < small) {
    pair_gather_kernel<V, uint32_t><<<blocks_for(n), kThreads, 0, s>>>(
        lab, (uint32_t)rl, (uint32_t)g, (uint32_t)wv, rows, (uint32_t)P, out);
  } else {
    pair_gather_kernel<V, int64_t><<<blocks_for(n), kThreads, 0, s>>>(
        lab, rl, (int64_t)g, (int64_t)wv, rows, P, out);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry points (ctypes). Each launches on `stream` and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.

extern "C" int keto_shard_answer(const int32_t* entries, int64_t L, int32_t g, int64_t S1,
                                 int64_t S2, int64_t SA, int64_t B, int32_t rps, const uint32_t* P,
                                 const uint32_t* ans_base, const uint32_t* R, int32_t W,
                                 const int32_t* state, uint32_t* out, void* stream) {
  if (W < 1 || g < 1 || rps < 1 || B != 32 * static_cast<int64_t>(W) || SA < 0 ||
      L != 2 * (S1 + S2 + SA) + B)
    return static_cast<int>(cudaErrorInvalidValue);
  shard_answer_kernel<<<blocks_for(32 * (W + g * ((SA + 31) / 32))), kThreads, 0,
                        (cudaStream_t)stream>>>(
      entries, L, g, S1, S2, SA, rps, P, ans_base, R, W, state, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int keto_pair_gather(const int32_t* lab, int64_t rl, int32_t g, int32_t w,
                                const int32_t* rows, int64_t P, int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(lab) | reinterpret_cast<uintptr_t>(out);
  if (w % 4 == 0 && addr % 16 == 0) {
    launch_pair_gather(reinterpret_cast<const int4*>(lab), rl, g, w / 4, rows, P,
                       reinterpret_cast<int4*>(out), s);
  } else {
    launch_pair_gather(lab, rl, g, w, rows, P, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
