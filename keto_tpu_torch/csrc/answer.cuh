// Warp-level pieces of the check step's answer kernels (keto_answer_pack in
// check_kernels.cu, keto_shard_answer in shard_kernels.cu) and of the
// frontier-bit counters of the seeds and the run.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// The hits of one warp's 32 entries into the answer words: the hitting lanes
// grouped by answer word q >> 5 (__match_any_sync), each group's bits ORed
// (__reduce_or_sync), one atomicOr a distinct word, by the group's first lane.
__device__ __forceinline__ void or_word_hits(uint32_t* out, bool hit, int32_t q) {
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if (hit) {
    const unsigned group = __match_any_sync(hits, q >> 5);
    const unsigned bits = __reduce_or_sync(group, 1u << (q & 31));
    if (static_cast<int>(threadIdx.x & 31) == __ffs(group) - 1) atomicOr(out + (q >> 5), bits);
  }
}

// One block's counts into *pop (uint32, wrapping): a warp reduction, the
// warps' sums added in shared memory, one atomicAdd a block — a launch's
// same-address atomics on the one counter serialise in L2, so they are few.
// Every thread of the block (of kBlock threads) must call it.
template <int kBlock>
__device__ __forceinline__ void count_block(uint32_t* pop, unsigned n) {
  __shared__ unsigned s_n[kBlock / 32];
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0) s_n[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned v = threadIdx.x < kBlock / 32 ? s_n[threadIdx.x] : 0u;
    v = __reduce_add_sync(0xffffffffu, v);
    if (threadIdx.x == 0 && v) atomicAdd(pop, v);
  }
}
