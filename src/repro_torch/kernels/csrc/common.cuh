// Shared helpers for the FractalSort kernels (plain C interface, loaded
// with ctypes).  Every exported entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FS_EXPORT extern "C" __attribute__((visibility("default")))

namespace fs {

constexpr unsigned kFullMask = 0xffffffffu;

// Blocks for a grid-stride loop over `work` items at `per_block` items a
// block, at least one and at most `cap`.
inline int grid_for(long long work, long long per_block, int cap) {
  long long g = (work + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > cap) g = cap;
  return static_cast<int>(g);
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

}  // namespace fs
