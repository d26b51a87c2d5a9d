// K4: Algorithm-5 reconstruct (FractalSortCPUA).
//   out[j] = #{b : cdf[b] <= j} << t_bits | trailing[j]
// where cdf is the inclusive cumulative sum of the MSD bin counts.  The
// prefix bits of every sorted key come from its output position; they are
// never read from memory.  Shifts and ors are on uint32, so p = 32 keys
// with the top bit set give the same bits as the reference's int32 wrap.
//
// Replaces `_reconstruct_kernel` / `fractal_reconstruct` of
// src/repro/kernels/fractal_reconstruct.py (the pallas_call at line 53),
// which compares a (block, n_bins) tile of slots against the VMEM-resident
// CDF and row-sums it.
//
// Bound on the H100: bytes.  One read of the 4-byte trailing entries and
// one write of the 4-byte keys against 3.35 TB/s; the CDF is n_bins ints.
//
// Design: the block x n_bins compare-and-reduce becomes one thread per
// slot (grid-stride) with a binary search (upper bound) of the CDF, held
// in shared memory when it fits (n_bins <= kSharedBins) and read through
// L2 from global memory for wider digits (2^16 bins).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 1 << 13;  // 32 KiB of CDF a block

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
reconstruct_kernel(const int32_t* __restrict__ cdf, int n_bins,
                   const int32_t* __restrict__ trailing,
                   int32_t* __restrict__ out, int n, int t_bits) {
  extern __shared__ int32_t smem[];
  const int32_t* ends = cdf;
  if (kShared) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) smem[b] = cdf[b];
    __syncthreads();
    ends = smem;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    int lo = 0, hi = n_bins;  // bins whose inclusive end is <= j
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long long)ends[mid] <= j) lo = mid + 1; else hi = mid;
    }
    out[j] = (int32_t)(((uint32_t)lo << t_bits) | (uint32_t)trailing[j]);
  }
}

}  // namespace

// cdf: (n_bins,) inclusive ends; trailing, out: (n,) int32; 0 <= t_bits < 32.
FS_EXPORT int fs_reconstruct(const void* cdf, int n_bins, const void* trailing,
                             void* out, long long n, int t_bits, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = fs::grid_for(n, (long long)kThreads * 8,
                                  16 * fs::sm_count());
  if (n_bins <= kSharedBins) {
    reconstruct_kernel<true><<<blocks, kThreads,
                               (size_t)n_bins * sizeof(int32_t), s>>>(
        (const int32_t*)cdf, n_bins, (const int32_t*)trailing, (int32_t*)out,
        (int)n, t_bits);
  } else {
    reconstruct_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)cdf, n_bins, (const int32_t*)trailing, (int32_t*)out,
        (int)n, t_bits);
  }
  return (int)cudaGetLastError();
}
