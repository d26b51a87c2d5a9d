// K2 and K3: stable rank (scatter slot) of every key of a digit stream,
//   rank[i] = bin_start[k] + #{j < i : keys[j] == k},   k = keys[i],
// keys outside [0, n_bins) get rank 0 and are counted nowhere.
//
// K2 replaces `_rank_kernel` / `fractal_rank_kernel` (one-hot engine) and
// K3 replaces `_rank_scatter_kernel` / `fractal_rank_scatter_kernel`
// (sorted-composite engine) of src/repro/kernels/fractal_rank.py (the
// pallas_calls at lines 81 and 150).  Both TPU kernels carry the running
// per-bin count of all earlier tiles in VMEM scratch across a sequential
// grid.  Blocks here run in no order, so that carry is rebuilt in one of
// two ways.
//
// Bound on the H100: bytes.  One read of the 4-byte digits and one write
// of the 4-byte ranks, 8n bytes against 3.35 TB/s.
//
// K2 up to 256 bins (`lookback_rank_kernel`): one sweep with decoupled
// look-back (Adinets and Merrill, "Onesweep", 2022).  A block takes the
// next 8192-key tile from an atomic counter, so every tile before it has
// already started (the forward-progress rule of the look-back), stages it
// in shared memory with 16-byte cp.async, and ranks it in arrival order
// (see the kernel: per-thread counters in registers up to 16 bins,
// ballot-matched warp counts above).  One thread per bin publishes the
// tile's count of its bin to a 64-bit status word flagged "aggregate";
// the block then looks back over its predecessors' words, many at once
// (adding aggregates until it meets a "prefix"), and publishes the
// inclusive prefix.  rank = bin_start + this bin's keys in earlier tiles
// + rank within the tile.  One launch replaces count walk, scan and rank
// walk, and the digits are read once.  What bounds it in practice is the
// in-tile ranking (instructions a key) and blocks waiting on the
// look-back, not the bytes: a copy of the same 8n bytes is faster.
//
// Above 256 bins the carry is an explicit scan, shared by K2 and K3:
//   1. the count walk (`tile_walk_kernel<false>`) writes a bin-major
//      (n_bins, tiles) table of per-tile digit counts;
//   2. the wrapper turns it into per-tile starting slots: one exclusive
//      cumulative sum over the flattened table (bin-major order is the
//      stable counting-sort order) re-based on bin_start.  That is a
//      torch.cumsum between the two launches;
//   3. a rank kernel ranks every tile independently from its column.
// The table is kept at or below the key count: K2 sizes its tile from
// n_bins (tile >= n_bins), K3's tile is its sort block and the wrapper
// refuses tables above a stated cap.
//
// K2's rank walk (`tile_walk_kernel<true>`): one warp per tile walks the
// tile 32 keys at a time; __match_any_sync groups the lanes holding equal
// keys, a lane's rank is its group's running count plus the popcount of
// the lower lanes of its group, and the group's lowest lane advances the
// count.
// The running counts are the tile's column of the table: in shared memory
// while they fit (n_bins <= kSharedRowBins), else read and written in
// place in global memory (the warp owns its column).
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

// ---- K2, one sweep with decoupled look-back (n_bins <= kLbMaxBins) ------------

constexpr int kLbWarps = 8;
constexpr int kLbThreads = 32 * kLbWarps;
constexpr int kLbItems = 32;                      // keys a thread
constexpr int kLbWarpKeys = 32 * kLbItems;        // 1024
constexpr int kLbTile = kLbThreads * kLbItems;    // 8192 keys a tile
constexpr int kLbMaxBins = kLbThreads;            // one thread a bin
constexpr int kLbPolls = 4;  // predecessors a thread polls a look-back round
constexpr int kLbBackoffNs = 100;  // pause between polls of an empty word
// status word: flag in the top two bits, count below (0 = not published)
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kCountMask = kAggregate - 1;
constexpr uint32_t kPartPrefix = 1u << 31;  // the same flag in a partial

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(word) = v;
}

// the word once it is published; the pause keeps waiting blocks from
// flooding L2 with polls while other blocks stream their tiles
__device__ __forceinline__ unsigned long long await_word(
    const unsigned long long* word) {
  unsigned long long w;
  while ((w = *reinterpret_cast<const volatile unsigned long long*>(word)) ==
         0)
    __nanosleep(kLbBackoffNs);
  return w;
}

// s_keys holds 16-byte chunk c at c ^ (c >> 3 & 7): thread t's blocked
// reads of chunks 8t .. 8t + 7 and the block's reads of consecutive
// chunks are then both free of bank conflicts
static_assert(kLbItems == 32, "the swizzle assumes 8 chunks a thread");
__device__ __forceinline__ int swizzle_chunk(int c) { return c ^ (c >> 3 & 7); }
__device__ __forceinline__ int swizzle(int pos) {
  return swizzle_chunk(pos >> 2) << 2 | (pos & 3);
}

// status[tile * n_bins + b]: bin b of a tile; *tile_counter starts at 0.
// kBits: digit bits (n_bins <= 2^kBits).  vec: keys and rank are 16-byte
// aligned (whole tiles load and store 16 bytes a thread).
//
// Rank within the tile, by digit width:
//   - up to 16 bins (kBits 4): thread t takes keys [32t, 32t + 32) and
//     counts them in registers (four words of 8-bit counters), keeping
//     each key's count before it; the counts, widened to 16 bits, are
//     scanned across the warp by shuffles and across the warps in shared
//     memory, so each thread gets its first slot per bin (fewer
//     instructions a key than the warp match below, which is why it is
//     kept to 16 bins);
//   - up to 256 bins (kBits 8): warp w takes keys [1024w, 1024w + 1024)
//     32 at a time; the lanes of equal keys are found from one ballot per digit
//     bit (CUB's MatchAny: __match_any_sync is a slow instruction), the
//     lowest lane of each group advances the warp's count of that bin in
//     shared memory, and a per-bin prefix over the warps follows.
// Either way each slot of s_keys then holds a valid key's rank among the
// keys of its bin before the thread's (or warp's) first, << 8 | key, or -1.
template <int kBits>
__global__ void __launch_bounds__(kLbThreads)
lookback_rank_kernel(const int32_t* __restrict__ keys, int n,
                     const int32_t* __restrict__ bin_start,
                     int32_t* __restrict__ rank, int n_bins,
                     unsigned long long* status,
                     unsigned long long* tile_counter, int vec) {
  constexpr bool kThreadCounts = kBits <= 4;
  constexpr int kGroupKeys = kThreadCounts ? kLbItems : kLbWarpKeys;
  __shared__ __align__(16) int32_t s_keys[kLbTile];
  // kThreadCounts: each thread's first slot per bin, [kLbThreads][16]
  // uint16; else per-warp counts [kLbWarps][kLbMaxBins], then each warp's
  // exclusive prefix per bin
  __shared__ __align__(16) int32_t s_count[kLbWarps * kLbMaxBins];
  __shared__ uint32_t s_base[kLbMaxBins];  // bin_start + earlier tiles
  // look-back partials: a count (below kPartPrefix) | kPartPrefix
  __shared__ uint32_t s_win[kLbThreads];
  __shared__ uint32_t s_warp[kLbWarps][8];  // kThreadCounts: warp totals
  __shared__ bool s_open[kLbMaxBins];  // bin still looking back
  __shared__ int s_tile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) s_tile = (int)atomicAdd(tile_counter, 1ull);
  if (!kThreadCounts)
    for (int e = tid; e < kLbWarps * kLbMaxBins; e += kLbThreads)
      s_count[e] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long lo = (long long)tile * kLbTile;
  const int len = (int)min((long long)kLbTile, (long long)n - lo);
  if (vec && len == kLbTile) {
    for (int c = tid; c < kLbTile / 4; c += kLbThreads)
      fs::cp_async16(&s_keys[4 * swizzle_chunk(c)], keys + lo + 4 * c, 16);
    fs::cp_async_commit();
    fs::cp_async_wait<0>();
  } else {
    for (int e = tid; e < len; e += kLbThreads)
      s_keys[swizzle(e)] = keys[lo + e];
  }
  __syncthreads();

  unsigned long long total = 0;  // tid < n_bins: the tile's count of bin tid
  if constexpr (kThreadCounts) {
    // counts of bins 4q .. 4q + 3 in c[q], 8 bits each (at most 16)
    uint32_t c[4] = {0, 0, 0, 0};
    int4* chunks = reinterpret_cast<int4*>(s_keys);
#pragma unroll
    for (int j = 0; j < kLbItems / 4; ++j) {
      int4& mine = chunks[swizzle_chunk(kLbItems / 4 * tid + j)];
      const int4 v4 = mine;
      int kv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = kv[u];
        const bool valid = (unsigned)key < (unsigned)n_bins &&
                           kLbItems * tid + 4 * j + u < len;
        const int q = key >> 2, sh = 8 * (key & 3);
        const uint32_t cur = q == 0 ? c[0] : q == 1 ? c[1] : q == 2 ? c[2] : c[3];
        const uint32_t inc = valid ? 1u << sh : 0u;
#pragma unroll
        for (int w = 0; w < 4; ++w) c[w] += q == w ? inc : 0u;
        kv[u] = valid ? (int)((cur >> sh) & 0xff) << 8 | key : -1;
      }
      mine = make_int4(kv[0], kv[1], kv[2], kv[3]);  // own slots only
    }
    // widen to 16 bits (bins 2h, 2h + 1 in x[h]); inclusive warp scan
    uint32_t x[8];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      x[2 * w] = (c[w] & 0xff) | (c[w] & 0xff00) << 8;
      x[2 * w + 1] = (c[w] >> 16 & 0xff) | (c[w] >> 24) << 16;
    }
    uint32_t incl[8];
#pragma unroll
    for (int h = 0; h < 8; ++h) incl[h] = x[h];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const uint32_t y = __shfl_up_sync(fs::kFullMask, incl[h], o);
        if (lane >= o) incl[h] += y;
      }
    if (lane == 31)
#pragma unroll
      for (int h = 0; h < 8; ++h) s_warp[warp][h] = incl[h];
    __syncthreads();
    // first slot per bin = earlier warps + earlier lanes (16-bit fields
    // never carry: a tile holds 8192 keys)
    uint32_t* first = reinterpret_cast<uint32_t*>(s_count) + 8 * tid;
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      uint32_t before = incl[h] - x[h];
      for (int w = 0; w < warp; ++w) before += s_warp[w][h];
      first[h] = before;
    }
    if (tid < n_bins) {
      const int h = tid >> 1, sh = 16 * (tid & 1);
      for (int w = 0; w < kLbWarps; ++w) total += s_warp[w][h] >> sh & 0xffff;
    }
  } else {
    // rank within the warp, in arrival order, 32 keys a step
    int32_t* cnt = s_count + warp * kLbMaxBins;
#pragma unroll 4
    for (int i = 0; i < kLbItems; ++i) {
      const int pos = warp * kLbWarpKeys + 32 * i + lane;
      const int key = pos < len ? s_keys[swizzle(pos)] : -1;
      const bool valid = (unsigned)key < (unsigned)n_bins;
      unsigned peers = __ballot_sync(fs::kFullMask, valid);
#pragma unroll
      for (int bit = 0; bit < kBits; ++bit) {
        const bool set = (key >> bit) & 1;
        const unsigned votes = __ballot_sync(fs::kFullMask, set);
        peers &= set ? votes : ~votes;
      }
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (valid && lane == leader) {
        before = cnt[key];
        cnt[key] = before + __popc(peers);
      }
      before = __shfl_sync(fs::kFullMask, before, leader & 31);
      __syncwarp();  // the new count is visible to the next step
      if (pos < len)
        s_keys[swizzle(pos)] =
            valid ? (before + __popc(peers & fs::lanemask_lt(lane))) << 8 | key
                  : -1;
    }
    __syncthreads();
    if (tid < n_bins) {
#pragma unroll
      for (int w = 0; w < kLbWarps; ++w) {
        const int c = s_count[w * kLbMaxBins + tid];
        s_count[w * kLbMaxBins + tid] = (int)total;
        total += c;
      }
    }
  }

  if (tid < n_bins) {
    publish(status + (long long)tile * n_bins + tid,
            (tile == 0 ? kPrefix : kAggregate) | total);
    s_open[tid] = tile > 0;
  }
  __syncthreads();

  // Look back over windows of span * kLbPolls predecessors, all bins at
  // once.  Thread (c, b) sums bin b over its kLbPolls predecessors, nearest
  // first, up to and including the first prefix (an empty prefix before
  // tile 0); bin b's thread then adds the partials in order, up to the
  // first that holds a prefix.
  const int span = kLbThreads / n_bins;
  unsigned long long carry = 0;  // bin tid's keys in all earlier tiles
  for (long long base = tile - 1; tile > 0; base -= span * kLbPolls) {
    if (tid < span * n_bins) {
      const int b = tid % n_bins;
      uint32_t part = 0;  // at most kLbPolls tiles of keys
      if (s_open[b]) {
        const long long first = base - (long long)(tid / n_bins) * kLbPolls;
#pragma unroll
        for (int u = 0; u < kLbPolls; ++u) {
          const long long p = first - u;
          const unsigned long long w =
              p >= 0 ? await_word(status + p * n_bins + b) : kPrefix;
          part += (uint32_t)(w & kCountMask);
          if (w & kPrefix) {
            part |= kPartPrefix;
            break;
          }
        }
      }
      s_win[tid] = part;
    }
    __syncthreads();
    bool open = false;
    if (tid < n_bins && s_open[tid]) {
      open = true;
      for (int c = 0; c < span && open; ++c) {
        const uint32_t w = s_win[c * n_bins + tid];
        carry += w & ~kPartPrefix;
        open = !(w & kPartPrefix);
      }
      s_open[tid] = open;
    }
    if (!__syncthreads_or(open)) break;
  }
  if (tid < n_bins) {
    if (tile > 0)
      publish(status + (long long)tile * n_bins + tid, kPrefix | (carry + total));
    s_base[tid] = (uint32_t)bin_start[tid] + (uint32_t)carry;
  }
  __syncthreads();

  // rank = bin_start + earlier tiles + the group's first slot + rank in
  // the group; 16-byte stores
  const uint16_t* first16 = reinterpret_cast<const uint16_t*>(s_count);
  for (int c = tid; 4 * c < len; c += kLbThreads) {
    const int4 e4 = reinterpret_cast<const int4*>(s_keys)[swizzle_chunk(c)];
    const int e[4] = {e4.x, e4.y, e4.z, e4.w};
    const int group = 4 * c / kGroupKeys;
    int r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = e[u] < 0 ? 0 : e[u] & 0xff;
      const uint32_t slot = kThreadCounts ? first16[16 * group + key]
                                          : (uint32_t)s_count[group * kLbMaxBins + key];
      r[u] = e[u] < 0 ? 0
                      : (int32_t)(s_base[key] + slot + (uint32_t)(e[u] >> 8));
    }
    if (vec && 4 * c + 3 < len) {
      *reinterpret_cast<int4*>(rank + lo + 4 * c) =
          make_int4(r[0], r[1], r[2], r[3]);
    } else {
      for (int u = 0; u < 4 && 4 * c + u < len; ++u) rank[lo + 4 * c + u] = r[u];
    }
  }
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

// Keys a tile of fs_rank_lookback, which sizes its status buffer.
FS_EXPORT int fs_rank_lookback_tile() { return kLbTile; }

// K2 up to 256 bins: ranks in one launch.  `status` holds
// ceil(n / fs_rank_lookback_tile()) * n_bins + 1 zeroed 64-bit words (the
// per-tile status words, then the tile counter).
FS_EXPORT int fs_rank_lookback(const void* keys, long long n,
                               const void* bin_start, void* rank, int n_bins,
                               void* status, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n_bins < 1 || n_bins > kLbMaxBins || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  auto* words = (unsigned long long*)status;
  auto kernel = n_bins <= 16 ? lookback_rank_kernel<4> : lookback_rank_kernel<8>;
  kernel<<<(unsigned)tiles, kLbThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int)n, (const int32_t*)bin_start,
      (int32_t*)rank, n_bins, words, words + tiles * n_bins,
      (uintptr_t)keys % 16 == 0 && (uintptr_t)rank % 16 == 0);
  return (int)cudaGetLastError();
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
