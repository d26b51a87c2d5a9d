// The payload carry of a sort pass:
//   out_k[rank[i]] = a_k[i]   for every array k of the call and row i,
// where the first array's 4-byte rows are and-ed with `mask0` on the way
// (the MSD pass keeps only its entries' trailing bits).
//
// Replaces no TPU kernel: the reference's carry (`JnpBackend.scatter` in
// src/repro/core/executor.py, `jnp.zeros_like(a).at[rank].set(a)`) is array
// code that XLA lowers, with no pallas_call.  Before this kernel the port ran
// it as torch operators: the rank widened to an int64 index, a zero fill of
// every output, the index write, and the MSD pass's mask as one more
// elementwise pass.
//
// Bound on the H100: bytes.  Each rank is read once and each row of each
// array read once and written once,
//   n * (4 + sum of row bytes read + sum of row bytes written),
// against 3.35 TB/s: 12n for a pass's keys alone, 20n with an int32 payload.
//
// Design.  Every array of a call goes in one launch, so the ranks are read
// once, and they are used as the int32 they are.  No output is filled: the
// callers' ranks are a permutation of [0, n), so every slot is written.  The
// mask is applied as the rows leave.  What stands between a plain scattered
// store and the bound is the number of memory requests, not the bytes: in a
// pass of 4-bit digits a warp's 32 neighbouring rows go to about 16 runs of
// slots, one request each, and such a kernel read about a fifth of the
// bound on the H100 (torch's index write about the same).  So the 4-byte rows of up to
// four arrays (the sort's keys, int32 payloads; ranks and sources 16-byte
// aligned) take `scatter_words_kernel`, which groups each tile of 8192 rows
// in shared memory by destination line before it stores them: a warp's
// stores then fill one or two 128-byte lines wherever a run of slots is 32
// rows or longer (82 % of the bound at 2^29 keys on the H100).  Anything
// else (1-, 2- and 8-byte rows, a 2-D payload's wide rows, unaligned
// sources, more arrays) takes `scatter_rows_kernel`: one row a thread,
// copied in the widest unit of 16, 8, 4, 2 or 1 bytes that divides the row
// and both addresses, with no grouping.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxArrays = 8;  // arrays a launch; the wrapper splits more
constexpr int kMaxWords = 4;   // arrays the words kernel's shared memory holds
constexpr int kItems = 32;                // rows a thread a tile
constexpr int kTile = kThreads * kItems;  // 8192 rows
constexpr int kBuckets = 1024;  // destination lines a tile is grouped by
constexpr int kLineShift = 5;   // 32 rows of 4 bytes: a 128-byte line

struct Arrays {
  const char* src[kMaxArrays];
  char* dst[kMaxArrays];
  long long row_bytes[kMaxArrays];
  int unit[kMaxArrays];  // bytes a copy in the rows path
  int count;
  int mask0;  // and-ed into array 0's 4-byte rows (-1 keeps every bit)
};

// One row i of array k to slot r, in the array's unit.
__device__ __forceinline__ void copy_row(const Arrays& a, int k, long long i,
                                         long long r) {
  const long long w = a.row_bytes[k];
  const char* s = a.src[k] + i * w;
  char* d = a.dst[k] + r * w;
  switch (a.unit[k]) {
    case 16:
      for (long long o = 0; o < w; o += 16)
        *reinterpret_cast<int4*>(d + o) =
            __ldcs(reinterpret_cast<const int4*>(s + o));
      break;
    case 8:
      for (long long o = 0; o < w; o += 8)
        *reinterpret_cast<long long*>(d + o) =
            __ldcs(reinterpret_cast<const long long*>(s + o));
      break;
    case 4:
      if (k == 0 && w == 4) {
        *reinterpret_cast<int*>(d) =
            __ldcs(reinterpret_cast<const int*>(s)) & a.mask0;
      } else {
        for (long long o = 0; o < w; o += 4)
          *reinterpret_cast<int*>(d + o) =
              __ldcs(reinterpret_cast<const int*>(s + o));
      }
      break;
    case 2:
      for (long long o = 0; o < w; o += 2)
        *reinterpret_cast<short*>(d + o) =
            *reinterpret_cast<const short*>(s + o);
      break;
    default:
      for (long long o = 0; o < w; ++o) d[o] = s[o];
  }
}

// Rows [lo, n) of kCount arrays of 4-byte rows, one a thread over the grid
// (the words kernel's last partial tile).
template <int kCount>
__device__ __forceinline__ void scatter_words_rows(
    const int32_t* __restrict__ rank, long long lo, long long n,
    const Arrays& a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int r = rank[i];
#pragma unroll
    for (int k = 0; k < kCount; ++k) {
      const int v = reinterpret_cast<const int*>(a.src[k])[i];
      reinterpret_cast<int*>(a.dst[k])[r] = k == 0 ? v & a.mask0 : v;
    }
  }
}

// In-place exclusive scan of the kBuckets counts by the whole block; ends
// with a barrier.
__device__ __forceinline__ void scan_buckets(int* start, int* warp_sums) {
  constexpr int kPer = (kBuckets + kThreads - 1) / kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int c[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = tid * kPer + j;
    c[j] = b < kBuckets ? start[b] : 0;
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(fs::kFullMask, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int up = __shfl_up_sync(fs::kFullMask, wi, d);
      if (lane >= d) wi += up;
    }
    if (lane < kWarps) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = tid * kPer + j;
    if (b < kBuckets) start[b] = run;
    run += c[j];
  }
  __syncthreads();
}

// kCount arrays of 4-byte rows; ranks and sources 16-byte aligned.  A block
// takes tiles of kTile rows (grid-stride over the card's resident blocks)
// and stages each in shared memory in arrival order with 16-byte cp.async,
// neighbouring threads on neighbouring addresses (ranks, then each array's
// rows; no row passes through registers).  It counts the tile's rows by
// destination line modulo kBuckets with shared atomics, scans the counts,
// and takes each row's place in the grouped tile from a second atomic on the
// scanned starts (`perm`: place -> arrival; the order inside a bucket does
// not matter, as each row carries its slot).  Thread t then stores places
// t, t + kThreads, ...  With 1024 buckets for the ~16 lines a 4-bit run of
// a tile covers (~512 lines for 256 runs), a bucket rarely mixes lines.
template <int kCount>
__global__ void __launch_bounds__(kThreads)
scatter_words_kernel(const int32_t* __restrict__ rank, long long n,
                     Arrays a) {
  extern __shared__ __align__(16) int smem[];
  int* start = smem;                 // kBuckets
  int* warp_sums = start + kBuckets; // kWarps, padded to 16 ints
  int* in = warp_sums + 16;          // (1 + kCount) x kTile, arrival order
  int* perm = in + (1 + kCount) * kTile;  // kTile
  const int tid = threadIdx.x;
  const long long tiles = n / kTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long q0 = tile * (kTile / 4);
#pragma unroll
    for (int k = 0; k <= kCount; ++k) {
      const int4* src = reinterpret_cast<const int4*>(
          k == 0 ? (const char*)rank : a.src[k - 1]) + q0;
#pragma unroll 4
      for (int q = tid; q < kTile / 4; q += kThreads)
        fs::cp_async16(&in[k * kTile + 4 * q], src + q, 16);
    }
    fs::cp_async_commit();
    for (int b = tid; b < kBuckets; b += kThreads) start[b] = 0;
    fs::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < kItems; ++i)
      atomicAdd(&start[(in[i * kThreads + tid] >> kLineShift) & (kBuckets - 1)],
                1);
    __syncthreads();
    scan_buckets(start, warp_sums);
#pragma unroll 8
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + tid;
      perm[atomicAdd(&start[(in[j] >> kLineShift) & (kBuckets - 1)], 1)] = j;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < kItems; ++i) {
      const int j = perm[i * kThreads + tid];
      const int d = in[j];
#pragma unroll
      for (int k = 0; k < kCount; ++k) {
        const int v = in[(1 + k) * kTile + j];
        reinterpret_cast<int*>(a.dst[k])[d] = k == 0 ? v & a.mask0 : v;
      }
    }
    __syncthreads();  // the next tile's copies overwrite `in` and `perm`
  }
  scatter_words_rows<kCount>(rank, tiles * kTile, n, a);
}

// Any row widths and alignments: one row a thread.
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const int32_t* __restrict__ rank, long long n, Arrays a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = __ldcs(rank + i);
#pragma unroll
    for (int k = 0; k < kMaxArrays; ++k)  // static indices into `a`
      if (k < a.count) copy_row(a, k, i, r);
  }
}

template <typename Kernel>
int resident_grid(Kernel kernel, long long blocks, size_t smem) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  return fs::grid_for(blocks, 1, per_sm * fs::sm_count());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int kCount>
void launch_words(const int32_t* rank, long long n, const Arrays& a,
                  cudaStream_t s) {
  const size_t smem =
      sizeof(int) * (kBuckets + 16 + (size_t)kTile * (2 + kCount));
  auto kernel = scatter_words_kernel<kCount>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<resident_grid(kernel, n / kTile + 1, smem), kThreads, smem, s>>>(
      rank, n, a);
}

}  // namespace

// rank: (n,) int32, a permutation of [0, n); src[k], dst[k]: n rows of
// row_bytes[k] bytes each (row_bytes[k] > 0), 1 <= count <= 8; mask0 is
// and-ed into array 0's rows, which are then 4 bytes (-1: no mask).
FS_EXPORT int fs_scatter(const void* rank, long long n, int count,
                         const void* const* src, void* const* dst,
                         const long long* row_bytes, int mask0,
                         void* stream) {
  if (n <= 0 || count <= 0) return (int)cudaGetLastError();
  if (count > kMaxArrays) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* r = (const int32_t*)rank;
  Arrays a = {};
  a.count = count;
  a.mask0 = mask0;
  bool words = count <= kMaxWords && aligned(rank, 16);
  for (int k = 0; k < count; ++k) {
    a.src[k] = (const char*)src[k];
    a.dst[k] = (char*)dst[k];
    a.row_bytes[k] = row_bytes[k];
    int unit = 16;
    while (unit > 1 && (row_bytes[k] % unit || !aligned(src[k], unit) ||
                        !aligned(dst[k], unit)))
      unit >>= 1;
    a.unit[k] = unit;
    words = words && row_bytes[k] == 4 && aligned(src[k], 16) &&
            aligned(dst[k], 4);
  }
  if (words && count == 1)
    launch_words<1>(r, n, a, s);
  else if (words && count == 2)
    launch_words<2>(r, n, a, s);
  else if (words && count == 3)
    launch_words<3>(r, n, a, s);
  else if (words)
    launch_words<4>(r, n, a, s);
  else
    scatter_rows_kernel<<<resident_grid(scatter_rows_kernel, n / kThreads + 1,
                                        0),
                          kThreads, 0, s>>>(r, n, a);
  return (int)cudaGetLastError();
}
