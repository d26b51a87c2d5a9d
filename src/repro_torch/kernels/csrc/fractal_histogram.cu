// K1: digit histogram (bincount over [0, n_bins) added onto carried counts),
// and the same for every digit of a sort plan in one read of the keys.
//
// Replaces the TPU kernel `_histogram_kernel` / `fractal_histogram` of
// src/repro/kernels/fractal_histogram.py (the pallas_call at line 88) and
// its multi-digit driver `digit_histograms` (line 103).  There, a
// sequential grid streams key tiles into a one-hot matrix and row-sums it
// into an accumulator pinned in VMEM, seeded from `init`; the driver runs
// it once per digit.
//
// Bound on the H100: bytes.  One read of the 4-byte key stream (4n bytes,
// 0.160 ms at n = 2^27 against 3.35 TB/s) plus an n_bins-sized read and
// write; the arithmetic is a few instructions a key.
//
// Blocks run in no order here, so the pinned accumulator becomes an output
// buffer the wrapper seeds from `init`, per-block counts, and one global
// atomicAdd per non-zero bin of each block.  What the design does for the
// bytes bound:
//   - loads: 16-byte vector loads, two in flight a thread, over the
//     16-byte-aligned body of the stream; the scalar head before the first
//     boundary (a sliced tensor) and the ragged tail are counted by the
//     first threads of the grid.  The grid is what the occupancy allows
//     (32-64 KiB of loads in flight an SM), capped so that every block
//     counts enough keys to pay for its flush;
//   - counting, by width (no __match_any_sync anywhere):
//       * up to 16 bins: per-thread 8-bit counters packed four to a
//         register (as K2's look-back rank does), widened into 32-bit
//         register counters every kFlushSteps loop steps, summed across
//         the warp by shuffles and across the block in shared memory;
//       * up to 2^14 bins: sub-histograms in shared memory, one per warp
//         while they fit in kSubBudget bytes (else one per group of
//         warps), plain shared atomicAdd, summed at the block's end;
//       * above 2^14 bins (up to 2^16): one block's copy of 2^16 counters
//         would pass its shared memory, so the bins are cut into 2^15-bin
//         slices (128 KiB of shared memory), one a block, and a
//         thread-block cluster of one block a slice (one block up to
//         2^15 bins, two above) holds one histogram.  Every block of a
//         cluster reads the cluster's share of the stream and counts the
//         keys of its own slice with plain shared atomics; the cluster
//         launch runs its blocks at once, so the second read of a vector
//         comes from L2.  Equal keys in a row of one thread's stream add
//         as one run, so a skewed digit's hot bin costs one shared atomic
//         a run, not a key.  1024 threads a block, one block an SM, one
//         wave of clusters: the only device atomics are each block's
//         non-zero counts.  (Adding each key into its owner's slice over
//         distributed shared memory, `red.shared::cluster`, was tried
//         first: on an H100 the rate of remote adds, not the key stream,
//         set its pace, and it ran slower the more blocks a cluster had.)
//   - every digit in one sweep (`fs_histogram_digits`): a digit's
//     histogram does not change when the keys are permuted, so every
//     pass's counts of a sort come from one read of the key stream before
//     the pass loop (the up-front histogram of Onesweep and CUB's radix
//     sort).  Adjacent digits are counted jointly: a group of digits
//     spanning at most 12 bits (chosen by the wrapper) is one shared
//     atomic a key into a 2^span-bin joint histogram, and each digit's
//     counts are its marginals, summed in shared memory at the block's
//     end.  The 8 x 4-bit plan of a 32-bit sort is 3 atomics a key
//     (12 + 12 + 8 bits) instead of 8.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRegBins = 16;           // per-thread register counters
constexpr int kSharedBins = 1 << 14;   // shared sub-histograms up to here
constexpr int kClusterThreads = 1024;  // a block of the cluster path
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr int kSubBudget = 32 * 1024;  // bytes of sub-histograms a block
constexpr int kKeysPerThread = 16;     // least keys a thread before the cap
// loop steps (8 keys each) between widenings of the 8-bit counters:
// 31 x 8 + 6 head and tail keys < 256
constexpr int kFlushSteps = 31;
constexpr int kMaxDigits = 32;  // passes of one sweep
constexpr int kMaxGroups = 8;   // joint groups of one sweep

// Visits every key of keys[0, n) once across the grid: f(key, valid) for
// the 16-byte-aligned body two vectors a thread at a time (f.step() after
// each pair), then the scalar head and tail.
template <class F>
__device__ __forceinline__ void for_each_key(const int32_t* __restrict__ keys,
                                             long long n, F& f) {
  const long long head =
      min(n, (long long)(((16 - ((uintptr_t)keys & 15)) & 15) >> 2));
  const long long nvec = (n - head) >> 2;
  const long long tail = head + 4 * nvec;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int4* vec = reinterpret_cast<const int4*>(keys + head);
  for (long long v = tid; v < nvec; v += 2 * stride) {
    const bool second = v + stride < nvec;
    const int4 a = __ldg(vec + v);
    const int4 b = second ? __ldg(vec + v + stride) : make_int4(0, 0, 0, 0);
    f(a.x, true); f(a.y, true); f(a.z, true); f(a.w, true);
    f(b.x, second); f(b.y, second); f(b.z, second); f(b.w, second);
    f.step();
  }
  if (tid < head) f(keys[tid], true);
  if (tid < n - tail) f(keys[tail + tid], true);
}

// for_each_key over the grid's clusters of `cluster` blocks: every block of
// cluster u visits the keys that block u of a grid of gridDim.x / cluster
// blocks would.  A copy, not a shared body: with one body the compiler
// gave the register kernel other code (46 registers, not 55), a tenth
// slower on an H100.
template <class F>
__device__ __forceinline__ void for_each_cluster_key(
    const int32_t* __restrict__ keys, long long n, F& f, int cluster) {
  const long long head =
      min(n, (long long)(((16 - ((uintptr_t)keys & 15)) & 15) >> 2));
  const long long nvec = (n - head) >> 2;
  const long long tail = head + 4 * nvec;
  const long long tid =
      (long long)(blockIdx.x / cluster) * blockDim.x + threadIdx.x;
  const long long stride = (long long)(gridDim.x / cluster) * blockDim.x;
  const int4* vec = reinterpret_cast<const int4*>(keys + head);
  for (long long v = tid; v < nvec; v += 2 * stride) {
    const bool second = v + stride < nvec;
    const int4 a = __ldg(vec + v);
    const int4 b = second ? __ldg(vec + v + stride) : make_int4(0, 0, 0, 0);
    f(a.x, true); f(a.y, true); f(a.z, true); f(a.w, true);
    f(b.x, second); f(b.y, second); f(b.z, second); f(b.w, second);
    f.step();
  }
  if (tid < head) f(keys[tid], true);
  if (tid < n - tail) f(keys[tail + tid], true);
}

// Up to 16 bins: counts of bins 4q .. 4q + 3 in c[q], 8 bits each.
struct RegisterCounts {
  int n_bins;
  uint32_t c[4] = {0, 0, 0, 0};
  uint32_t acc[kRegBins];
  int steps = 0;
  __device__ explicit RegisterCounts(int bins) : n_bins(bins) {
#pragma unroll
    for (int b = 0; b < kRegBins; ++b) acc[b] = 0;
  }
  __device__ __forceinline__ void operator()(int key, bool valid) {
    const uint32_t inc =
        valid && (unsigned)key < (unsigned)n_bins ? 1u << (8 * (key & 3)) : 0u;
    const int q = (key >> 2) & 3;
#pragma unroll
    for (int w = 0; w < 4; ++w) c[w] += q == w ? inc : 0u;
  }
  __device__ __forceinline__ void widen() {
#pragma unroll
    for (int b = 0; b < kRegBins; ++b)
      acc[b] += (c[b >> 2] >> (8 * (b & 3))) & 0xffu;
#pragma unroll
    for (int w = 0; w < 4; ++w) c[w] = 0;
  }
  __device__ __forceinline__ void step() {
    if (++steps == kFlushSteps) {
      widen();
      steps = 0;
    }
  }
};

// Sub-histograms in shared memory by atomicAdd.
struct AtomicCounts {
  int32_t* hist;
  int n_bins;
  __device__ __forceinline__ void operator()(int key, bool valid) {
    if (valid && (unsigned)key < (unsigned)n_bins) atomicAdd(&hist[key], 1);
  }
  __device__ __forceinline__ void step() {}
};

__global__ void __launch_bounds__(kThreads)
histogram_register_kernel(const int32_t* __restrict__ keys, long long n,
                          int32_t* __restrict__ out, int n_bins) {
  __shared__ uint32_t s_tot[kRegBins];
  if (threadIdx.x < kRegBins) s_tot[threadIdx.x] = 0;
  __syncthreads();
  RegisterCounts f(n_bins);
  for_each_key(keys, n, f);
  f.widen();
#pragma unroll
  for (int b = 0; b < kRegBins; ++b) {
    uint32_t v = f.acc[b];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_xor_sync(fs::kFullMask, v, o);
    f.acc[b] = v;
  }
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int b = 0; b < kRegBins; ++b)
      if (f.acc[b]) atomicAdd(&s_tot[b], f.acc[b]);
  __syncthreads();
  if (threadIdx.x < n_bins && s_tot[threadIdx.x])
    atomicAdd(&out[threadIdx.x], (int32_t)s_tot[threadIdx.x]);
}

// `copies` sub-histograms of n_bins counters; warp w counts into copy
// w % copies (copies is a power of two).
__global__ void __launch_bounds__(kThreads)
histogram_shared_kernel(const int32_t* __restrict__ keys, long long n,
                        int32_t* __restrict__ out, int n_bins, int copies) {
  extern __shared__ int32_t smem[];
  const int words = copies * n_bins;
  for (int e = threadIdx.x; e < words; e += blockDim.x) smem[e] = 0;
  __syncthreads();
  AtomicCounts f{smem + ((threadIdx.x >> 5) & (copies - 1)) * n_bins, n_bins};
  for_each_key(keys, n, f);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    int c = 0;
    for (int k = 0; k < copies; ++k) c += smem[k * n_bins + b];
    if (c) atomicAdd(&out[b], c);
  }
}

// The keys of one thread's stream that fall in this block's slice; equal
// keys in a row (other keys between them aside) add as one shared atomic.
struct SliceCounts {
  int32_t* slice;
  int n_bins, slice_bits, rank;
  int run_key = -1;
  int run = 0;
  __device__ __forceinline__ void flush() {
    if (run) atomicAdd(&slice[run_key & ((1 << slice_bits) - 1)], run);
  }
  __device__ __forceinline__ void operator()(int key, bool valid) {
    if (!valid || (unsigned)key >= (unsigned)n_bins ||
        (key >> slice_bits) != rank)
      return;
    if (key == run_key) {
      ++run;
      return;
    }
    flush();
    run_key = key;
    run = 1;
  }
  __device__ __forceinline__ void step() {}
};

// 2^14 < n_bins <= 2^16: block r of each cluster of `cluster` blocks holds
// bins [r << slice_bits, (r + 1) << slice_bits) in shared memory; every
// block of a cluster reads the cluster's share of the stream and counts
// the keys of its own slice.
__global__ void __launch_bounds__(kClusterThreads)
histogram_cluster_kernel(const int32_t* __restrict__ keys, long long n,
                         int32_t* __restrict__ out, int n_bins,
                         int slice_bits, int cluster) {
  extern __shared__ int32_t smem[];
  const int slice = 1 << slice_bits;
  const int rank = (int)(blockIdx.x % cluster);
  for (int e = threadIdx.x; e < slice; e += blockDim.x) smem[e] = 0;
  __syncthreads();
  SliceCounts f{smem, n_bins, slice_bits, rank};
  for_each_cluster_key(keys, n, f, cluster);
  f.flush();
  __syncthreads();
  const int lo = rank << slice_bits;
  for (int b = threadIdx.x; b < slice && lo + b < n_bins; b += blockDim.x) {
    const int c = smem[b];
    if (c) atomicAdd(&out[lo + b], c);
  }
}

// The cluster kernel's launch: `clusters` clusters of `cluster` blocks,
// 4 << slice_bits bytes of shared memory a block.
cudaLaunchConfig_t cluster_config(int cluster, int slice_bits, int clusters,
                                  cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = sizeof(int32_t) << slice_bits;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaSuccess when a cluster of `cluster` blocks of 4 << slice_bits bytes
// is a shape the card takes (after allowing the kernel that much dynamic
// shared memory).
cudaError_t cluster_shape_ok(int cluster, int slice_bits) {
  if (cluster < 1 || cluster > kMaxCluster || slice_bits < 0 ||
      slice_bits > 15)
    return cudaErrorInvalidValue;
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t bytes = sizeof(int32_t) << slice_bits;
  if (bytes > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(histogram_cluster_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---- every digit in one sweep ------------------------------------------------

struct SweepPlan {
  int n_groups, n_passes, joint_words, pass_words;
  int group_shift[kMaxGroups], group_bits[kMaxGroups], group_off[kMaxGroups];
  int pass_group[kMaxDigits], pass_rel[kMaxDigits], pass_bits[kMaxDigits];
  int pass_off[kMaxDigits];
};

// One shared atomic a key and group into the group's joint histogram.
template <int kGroups>
struct JointCounts {
  int32_t* joint;
  uint32_t shift[kGroups], mask[kGroups];
  int off[kGroups];
  __device__ __forceinline__ void operator()(int key, bool valid) {
    if (!valid) return;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      atomicAdd(&joint[off[g] + (((uint32_t)key >> shift[g]) & mask[g])], 1);
  }
  __device__ __forceinline__ void step() {}
};

template <int kGroups>
__global__ void __launch_bounds__(kThreads)
histogram_digits_kernel(const int32_t* __restrict__ keys, long long n,
                        int32_t* __restrict__ out, const SweepPlan plan) {
  extern __shared__ int32_t smem[];
  int32_t* joint = smem;
  int32_t* pbins = smem + plan.joint_words;
  for (int e = threadIdx.x; e < plan.joint_words + plan.pass_words;
       e += blockDim.x)
    smem[e] = 0;
  __syncthreads();
  JointCounts<kGroups> f;
  f.joint = joint;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    f.shift[g] = (uint32_t)plan.group_shift[g];
    f.mask[g] = (1u << plan.group_bits[g]) - 1u;
    f.off[g] = plan.group_off[g];
  }
  for_each_key(keys, n, f);
  __syncthreads();
  // marginals: joint bin e of group g adds to every digit of g
  for (int e = threadIdx.x; e < plan.joint_words; e += blockDim.x) {
    const int c = joint[e];
    if (!c) continue;
    int g = 0;
    while (g + 1 < kGroups && e >= plan.group_off[g + 1]) ++g;
    const uint32_t j = (uint32_t)(e - plan.group_off[g]);
    for (int p = 0; p < plan.n_passes; ++p)
      if (plan.pass_group[p] == g)
        atomicAdd(&pbins[plan.pass_off[p] +
                         ((j >> plan.pass_rel[p]) &
                          ((1u << plan.pass_bits[p]) - 1u))],
                  c);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < plan.pass_words; b += blockDim.x) {
    const int c = pbins[b];
    if (c) atomicAdd(&out[b], c);
  }
}

// Blocks for `kernel` over n keys: what fits on the card at once, and no
// more than one per kThreads * kKeysPerThread keys.
template <class K>
int grid_for_keys(K kernel, size_t smem, long long n) {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                    smem) != cudaSuccess ||
      occ < 1)
    occ = 1;
  return fs::grid_for(n, (long long)kThreads * kKeysPerThread,
                      occ * fs::sm_count());
}

template <class K>
void allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
}

template <int kGroups>
int launch_digits(const int32_t* keys, long long n, int32_t* out,
                  const SweepPlan& plan, cudaStream_t s) {
  auto kernel = histogram_digits_kernel<kGroups>;
  const size_t bytes =
      (size_t)(plan.joint_words + plan.pass_words) * sizeof(int32_t);
  allow_smem(kernel, bytes);
  kernel<<<grid_for_keys(kernel, bytes, n), kThreads, bytes, s>>>(keys, n,
                                                                   out, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// out[b] += #{i < n : keys[i] == b} for b in [0, n_bins), n_bins at most
// 2^14 (wider: fs_histogram_cluster).
FS_EXPORT int fs_histogram(const void* keys, long long n, void* out,
                           int n_bins, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* k = (const int32_t*)keys;
  auto* o = (int32_t*)out;
  if (n_bins <= kRegBins) {
    auto kernel = histogram_register_kernel;
    histogram_register_kernel<<<grid_for_keys(kernel, 0, n), kThreads, 0, s>>>(
        k, n, o, n_bins);
  } else if (n_bins <= kSharedBins) {
    int copies = kThreads / 32;
    while (copies > 1 && (size_t)copies * n_bins * sizeof(int32_t) > kSubBudget)
      copies >>= 1;
    const size_t bytes = (size_t)copies * n_bins * sizeof(int32_t);
    auto kernel = histogram_shared_kernel;
    allow_smem(kernel, bytes);
    histogram_shared_kernel<<<grid_for_keys(kernel, bytes, n), kThreads, bytes,
                              s>>>(k, n, o, n_bins, copies);
  } else {
    return (int)cudaErrorInvalidValue;  // fs_histogram_cluster's widths
  }
  return (int)cudaGetLastError();
}

// The most clusters of `cluster` blocks, 4 << slice_bits bytes of shared
// memory each, that the card runs at once, into *clusters.
FS_EXPORT int fs_histogram_cluster_capacity(int cluster, int slice_bits,
                                            int* clusters) {
  *clusters = 0;
  cudaError_t e = cluster_shape_ok(cluster, slice_bits);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, slice_bits, 1, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                             histogram_cluster_kernel, &cfg);
}

// out[b] += #{i < n : keys[i] == b} for b in [0, n_bins), n_bins at most
// cluster << slice_bits: `clusters` clusters of `cluster` blocks, each
// block a slice of 1 << slice_bits counters.
FS_EXPORT int fs_histogram_cluster(const void* keys, long long n, void* out,
                                   int n_bins, int cluster, int slice_bits,
                                   int clusters, void* stream) {
  if (n_bins < 1 || clusters < 1 ||
      ((long long)cluster << std::max(slice_bits, 0)) < n_bins)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cluster_shape_ok(cluster, slice_bits);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaGetLastError();
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      cluster, slice_bits, clusters, (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, histogram_cluster_kernel,
                         (const int32_t*)keys, n, (int32_t*)out, n_bins,
                         slice_bits, cluster);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Every digit of a plan in one read of the uint32 key stream.  Digit p is
// bits [shifts[p], shifts[p] + bits[p]); its 2^bits[p] counts are added
// onto out at the sum of the earlier digits' bin counts.  groups[p] is
// the joint group of digit p: 0, 1, ... in plan order, non-decreasing;
// a group's span of bits (its digits' lowest to highest bit) is at most
// 16 bits, and the groups' 2^span bins and the digits' bins together fit
// in one block's shared memory.
FS_EXPORT int fs_histogram_digits(const void* keys, long long n, void* out,
                                  int n_passes, const int* shifts,
                                  const int* bits, const int* groups,
                                  void* stream) {
  if (n_passes < 1 || n_passes > kMaxDigits) return (int)cudaErrorInvalidValue;
  SweepPlan plan = {};
  int lo[kMaxGroups], hi[kMaxGroups];
  for (int p = 0; p < n_passes; ++p) {
    const int g = groups[p];
    const bool fresh = p == 0 ? g == 0 : g == groups[p - 1] + 1;
    if (!(fresh || (p > 0 && g == groups[p - 1])) || g >= kMaxGroups ||
        bits[p] < 0 || bits[p] > 16 || shifts[p] < 0 ||
        shifts[p] + bits[p] > 32)
      return (int)cudaErrorInvalidValue;
    if (fresh) {
      lo[g] = shifts[p];
      hi[g] = shifts[p] + bits[p];
    } else {
      lo[g] = std::min(lo[g], shifts[p]);
      hi[g] = std::max(hi[g], shifts[p] + bits[p]);
    }
    plan.n_groups = g + 1;
    plan.pass_group[p] = g;
    plan.pass_bits[p] = bits[p];
    plan.pass_off[p] = plan.pass_words;
    plan.pass_words += 1 << bits[p];
  }
  plan.n_passes = n_passes;
  for (int g = 0; g < plan.n_groups; ++g) {
    if (hi[g] - lo[g] > 16) return (int)cudaErrorInvalidValue;
    plan.group_shift[g] = lo[g];
    plan.group_bits[g] = hi[g] - lo[g];
    plan.group_off[g] = plan.joint_words;
    plan.joint_words += 1 << (hi[g] - lo[g]);
  }
  for (int p = 0; p < n_passes; ++p)
    plan.pass_rel[p] = shifts[p] - lo[plan.pass_group[p]];
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if ((size_t)(plan.joint_words + plan.pass_words) * sizeof(int32_t) >
      (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const auto* k = (const int32_t*)keys;
  auto* o = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (plan.n_groups) {
    case 1: return launch_digits<1>(k, n, o, plan, s);
    case 2: return launch_digits<2>(k, n, o, plan, s);
    case 3: return launch_digits<3>(k, n, o, plan, s);
    case 4: return launch_digits<4>(k, n, o, plan, s);
    case 5: return launch_digits<5>(k, n, o, plan, s);
    case 6: return launch_digits<6>(k, n, o, plan, s);
    case 7: return launch_digits<7>(k, n, o, plan, s);
    default: return launch_digits<8>(k, n, o, plan, s);
  }
}
