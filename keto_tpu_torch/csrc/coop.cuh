// Grid sizing for the port's persistent kernels, which run a whole fixpoint
// in one cooperative launch (cudaLaunchCooperativeKernel) and separate its
// phases with cooperative_groups grid barriers: every block must be resident
// at once, so the grid is at most the occupancy API's blocks per SM times
// the SMs, and no more blocks than `work` threads need.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <typename Kernel>
inline cudaError_t coresident_grid(Kernel kernel, int threads, int64_t work, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || sms < 1) return cudaErrorCooperativeLaunchTooLarge;
  int64_t want = (work + threads - 1) / threads;
  if (want < 1) want = 1;
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  *grid = static_cast<int>(want < most ? want : most);
  return cudaSuccess;
}
