// K1: digit histogram (bincount over [0, n_bins) added onto carried counts).
//
// Replaces the TPU kernel `_histogram_kernel` / `fractal_histogram` of
// src/repro/kernels/fractal_histogram.py (the pallas_call at line 88).
// There, a sequential grid streams key tiles into a one-hot matrix and
// row-sums it into an accumulator pinned in VMEM, seeded from `init`.
//
// Bound on the H100: bytes.  One read of the 4-byte key stream plus an
// n_bins-sized read and write, against 3.35 TB/s; the arithmetic is one
// compare and one add a key.
//
// Design: blocks run in no order here, so the pinned accumulator becomes
//   1. an output buffer the wrapper copies from `init` before the launch;
//   2. a per-block histogram in shared memory, filled by a grid-stride
//      loop that masks the ragged tail itself (no padding copy) and drops
//      keys outside [0, n_bins) (the -1 and n_bins pads of the callers);
//      lanes of a warp holding the same key are merged with
//      __match_any_sync, so one shared atomic serves each distinct key;
//   3. one global atomicAdd per non-zero bin of each block into the output.
// Above kSharedBins (2^14 bins = 64 KiB of counters) the per-block copy
// would take most of an SM's shared memory and its flush would cost as
// much as the keys, so wide digits (up to 2^16 bins) count straight into
// the output with global atomics, still one per distinct key of a warp.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSharedBins = 1 << 14;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int32_t* __restrict__ keys, int n,
                 int32_t* __restrict__ out, int n_bins) {
  extern __shared__ int32_t smem[];
  int32_t* hist = kShared ? smem : out;
  if (kShared) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) smem[b] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // `base` is the first index of this warp's 32 keys: warp-uniform, so
  // every lane runs the same iterations and __match_any_sync sees the
  // full warp; lanes past the end carry the out-of-range key -1.
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    const int key = i < n ? keys[i] : -1;
    const unsigned peers = __match_any_sync(fs::kFullMask, key);
    if ((unsigned)key < (unsigned)n_bins && lane == __ffs(peers) - 1)
      atomicAdd(&hist[key], __popc(peers));
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
      const int c = smem[b];
      if (c) atomicAdd(&out[b], c);
    }
  }
}

}  // namespace

// out[b] += #{i < n : keys[i] == b} for b in [0, n_bins).
FS_EXPORT int fs_histogram(const void* keys, long long n, void* out,
                           int n_bins, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int cap = 4 * fs::sm_count();
  // enough keys a block that the per-block flush stays small next to them
  const int blocks = fs::grid_for(n, (long long)kThreads * 16, cap);
  if (n_bins <= kSharedBins) {
    const size_t bytes = (size_t)n_bins * sizeof(int32_t);
    if (bytes > 48 * 1024)
      cudaFuncSetAttribute(histogram_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
    histogram_kernel<true><<<blocks, kThreads, bytes, s>>>(
        (const int32_t*)keys, (int)n, (int32_t*)out, n_bins);
  } else {
    histogram_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)keys, (int)n, (int32_t*)out, n_bins);
  }
  return (int)cudaGetLastError();
}
