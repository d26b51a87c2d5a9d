// K2 and K3: stable rank (scatter slot) of every key of a digit stream,
//   rank[i] = bin_start[k] + #{j < i : keys[j] == k},   k = keys[i],
// keys outside [0, n_bins) get rank 0 and are counted nowhere.
//
// K2 replaces `_rank_kernel` / `fractal_rank_kernel` (one-hot engine) and
// K3 replaces `_rank_scatter_kernel` / `fractal_rank_scatter_kernel`
// (sorted-composite engine) of src/repro/kernels/fractal_rank.py (the
// pallas_calls at lines 81 and 150).  Both TPU kernels carry the running
// per-bin count of all earlier tiles in VMEM scratch across a sequential
// grid.  Blocks here run in no order, so that carry becomes an explicit
// scan, shared by K2 and K3:
//   1. the count walk (`tile_walk_kernel<false>`) writes a bin-major
//      (n_bins, tiles) table of per-tile digit counts;
//   2. the wrapper turns it into per-tile starting slots: one exclusive
//      cumulative sum over the flattened table (bin-major order is the
//      stable counting-sort order) re-based on bin_start.  That is a
//      torch.cumsum between the two launches: it is the grid's sequential
//      carry, not arithmetic of the kernel body.  Bin-major keeps it a
//      1-D scan: torch scans a tile-major table down its few long columns
//      with one serial thread a column;
//   3. a rank kernel ranks every tile independently from its column.
//
// Bound on the H100: bytes.  One read of the 4-byte digits, one write of
// the 4-byte ranks, plus the table, against 3.35 TB/s.  The table is
// kept at or below the key count: K2 sizes its tile from n_bins (tile >=
// n_bins), K3's tile is its sort block and the wrapper refuses tables
// above a stated cap.
//
// K2 (`tile_walk_kernel<true>`): one warp per tile walks the tile 32 keys at a
// time.  __match_any_sync groups the lanes holding equal keys; a lane's
// rank is its group's running count plus the popcount of the lower lanes
// of its group, and the group's lowest lane advances the count.  The
// running counts are the tile's column of the table: in shared memory
// while they fit (n_bins <= kSharedRowBins), else read and written in
// place in global memory (the warp owns its column).  Warps never wait on
// each other, so no block-wide prefix is needed.
//
// K3 (`rank_scatter_kernel`): one block of `block` threads per tile packs
// composites digit << log2(block) | position, sorts them with a stable
// LSD block radix sort in shared memory (4 bits a pass; a 17th bucket
// keeps out-of-range keys last), finds each digit's first sorted slot by
// binary search of the sorted composites (the TPU kernel's searchsorted),
// and scatters `start[digit] + sorted slot - first slot` back to the
// arrival position.  Its work per key does not grow with the digit width.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;             // warps a block in the tile kernels
constexpr int kSharedRowBins = 1024;  // 8 warps x 1024 x 4 B = 32 KiB
constexpr int kRadixBits = 4;
constexpr int kBuckets = (1 << kRadixBits) + 1;  // + the out-of-range bucket

// Per-warp running counts over one tile; table[b * num_tiles + t] is bin
// b of tile t.  kRank=false: count the tile into its column (zeroed by
// the caller in global mode).  kRank=true: the column holds the tile's
// starting slots; emit ranks.
template <bool kRank, bool kShared>
__global__ void __launch_bounds__(kWarps * 32)
tile_walk_kernel(const int32_t* __restrict__ keys, int n, int32_t* table,
                 int32_t* __restrict__ rank, int n_bins, int tile,
                 int num_tiles) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + warp;
  if (t >= num_tiles) return;  // warp-uniform
  int32_t* col = table + t;  // bin b at col[b * num_tiles]
  // running counter of bin b: cnt[b * step]
  int32_t* cnt = kShared ? smem + warp * n_bins : col;
  const long long step = kShared ? 1 : num_tiles;
  if (kShared)
    for (int b = lane; b < n_bins; b += 32)
      cnt[b] = kRank ? col[(long long)b * num_tiles] : 0;
  __syncwarp();
  const long long lo = t * tile;
  const long long hi = min(lo + tile, (long long)n);
  for (long long base = lo; base < hi; base += 32) {
    const long long i = base + lane;
    const int key = i < hi ? keys[i] : -1;
    const bool valid = (unsigned)key < (unsigned)n_bins;
    const unsigned peers = __match_any_sync(fs::kFullMask, key);
    const int before = valid ? cnt[key * step] : 0;
    __syncwarp();  // every peer has read the count before it moves
    if (valid && lane == __ffs(peers) - 1)
      cnt[key * step] = before + __popc(peers);
    if (kRank && i < hi)
      rank[i] = valid ? before + __popc(peers & fs::lanemask_lt(lane)) : 0;
    __syncwarp();  // the new count is visible to the next round
  }
  if (kShared && !kRank)
    for (int b = lane; b < n_bins; b += 32)
      col[(long long)b * num_tiles] = cnt[b];
}

__global__ void __launch_bounds__(1024)
rank_scatter_kernel(const int32_t* __restrict__ keys, int n,
                    const int32_t* __restrict__ table,
                    int32_t* __restrict__ rank, int n_bins, int blog,
                    int radix_passes) {
  extern __shared__ uint32_t sorted[];           // [block] composites
  __shared__ int offs[kBuckets * 32];            // [bucket][warp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int block = blockDim.x, warps = block >> 5;
  const long long start = (long long)blockIdx.x * block;
  const long long i = start + tid;
  const int key = i < n ? keys[i] : -1;
  const uint32_t pad = (uint32_t)n_bins;         // sorts after every digit
  uint32_t c = (((unsigned)key < (unsigned)n_bins ? (uint32_t)key : pad) << blog)
               | (uint32_t)tid;

  for (int pass = 0; pass < radix_passes; ++pass) {
    const uint32_t d = c >> blog;
    const int bucket = d >= pad ? kBuckets - 1
                                : (int)((d >> (pass * kRadixBits)) & ((1 << kRadixBits) - 1));
    for (int e = tid; e < kBuckets * warps; e += block) offs[e] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(fs::kFullMask, bucket);
    const int lower = __popc(peers & fs::lanemask_lt(lane));
    if (lane == __ffs(peers) - 1) offs[bucket * warps + warp] = __popc(peers);
    __syncthreads();
    if (warp == 0) {  // exclusive scan, bucket-major then warp: stable
      const int total = kBuckets * warps;
      const int per = (total + 31) / 32;
      const int lo = lane * per, hi = min(lo + per, total);
      int sum = 0;
      for (int e = lo; e < hi; ++e) sum += offs[e];
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(fs::kFullMask, incl, o);
        if (lane >= o) incl += v;
      }
      int run = incl - sum;
      for (int e = lo; e < hi; ++e) {
        const int v = offs[e];
        offs[e] = run;
        run += v;
      }
    }
    __syncthreads();
    sorted[offs[bucket * warps + warp] + lower] = c;
    __syncthreads();
    c = sorted[tid];
    __syncthreads();  // before the next pass rewrites `sorted`
  }
  // `sorted` now holds the tile's composites in order (radix_passes >= 1)

  const uint32_t d = c >> blog;
  const int orig = (int)(c & ((1u << blog) - 1u));
  const long long dst = start + orig;
  if (dst >= n) return;
  if (d >= pad) {
    rank[dst] = 0;
    return;
  }
  // first sorted slot of this digit: lower bound of d << blog
  const uint32_t probe = d << blog;
  int lo = 0, hi = tid;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < probe) lo = mid + 1; else hi = mid;
  }
  rank[dst] = table[(long long)d * gridDim.x + blockIdx.x] + tid - lo;
}

template <bool kRank>
int launch_walk(const void* keys, long long n, void* table, void* rank,
                int n_bins, int tile, cudaStream_t s) {
  if (n <= 0) return (int)cudaGetLastError();
  const int num_tiles = (int)((n + tile - 1) / tile);
  const int blocks = (num_tiles + kWarps - 1) / kWarps;
  if (n_bins <= kSharedRowBins) {
    const size_t bytes = (size_t)kWarps * n_bins * sizeof(int32_t);
    tile_walk_kernel<kRank, true><<<blocks, kWarps * 32, bytes, s>>>(
        (const int32_t*)keys, (int)n, (int32_t*)table, (int32_t*)rank,
        n_bins, tile, num_tiles);
  } else {
    if (!kRank)  // global counters start from zero
      cudaMemsetAsync(table, 0, (size_t)num_tiles * n_bins * sizeof(int32_t), s);
    tile_walk_kernel<kRank, false><<<blocks, kWarps * 32, 0, s>>>(
        (const int32_t*)keys, (int)n, (int32_t*)table, (int32_t*)rank,
        n_bins, tile, num_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table[b][t] = #{i in tile t : keys[i] == b}; tiles of `tile` keys,
// table (n_bins, ceil(n / tile)).
FS_EXPORT int fs_rank_tile_counts(const void* keys, long long n, void* table,
                                  int n_bins, int tile, void* stream) {
  return launch_walk<false>(keys, n, table, nullptr, n_bins, tile,
                            (cudaStream_t)stream);
}

// K2: ranks from per-tile starting slots (table columns, consumed in place).
FS_EXPORT int fs_rank_onehot(const void* keys, long long n, void* table,
                             void* rank, int n_bins, int tile, void* stream) {
  return launch_walk<true>(keys, n, table, rank, n_bins, tile,
                           (cudaStream_t)stream);
}

// K3: ranks from per-block starting slots; `block` is a power of two in
// [32, 1024] and the tile of the table; n_bins << log2(block) < 2^32.
FS_EXPORT int fs_rank_scatter(const void* keys, long long n, const void* table,
                              void* rank, int n_bins, int block, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int blog = 0;
  while ((1 << blog) < block) ++blog;
  int digit_bits = 0;
  while ((1LL << digit_bits) < n_bins) ++digit_bits;
  int passes = (digit_bits + kRadixBits - 1) / kRadixBits;
  if (passes < 1) passes = 1;  // out-of-range keys still go last
  const int blocks = (int)((n + block - 1) / block);
  rank_scatter_kernel<<<blocks, block, (size_t)block * sizeof(uint32_t),
                        (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int)n, (const int32_t*)table, (int32_t*)rank,
      n_bins, blog, passes);
  return (int)cudaGetLastError();
}
