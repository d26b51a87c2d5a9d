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
// + rank within the tile: one launch, and the digits are read once.  A
// sort's pass hands it the key stream and the pass's (shift, mask) instead
// of a digit stream: each key's digit is taken in registers after its tile
// is staged, so no elementwise pass writes a digit stream first.  What
// bounds it in practice is the in-tile ranking (instructions a key) and
// blocks waiting on the look-back, not the bytes: a copy of the same 8n
// bytes is faster.
//
// K2 from 257 to 2^16 bins (`fs_rank_wide`): two levels of the same
// look-back sweep, each over at most 256 bins, and no table of n_bins
// entries a tile.  A valid digit d splits into hi = d >> 8 (n_hi =
// ceil(n_bins / 256) bins) and lo = d & 255:
//   0. `wide_prep_kernel` (one launch): the hi bins' dense starts (an
//      exclusive scan of the hi rows of `counts`, the digit's histogram),
//      base[d] = bin_start[d] - C[hi][lo] with C[hi][lo] the keys of digit
//      lo in earlier hi rows (an exclusive scan down each lo column), and
//      the look-back status words of both levels zeroed;
//   1. level 1 (`lookback_rank_kernel<kBits, kLbHi>`) ranks hi with the
//      look-back from the hi starts, which puts every valid key at a slot
//      of the stable hi-major stream of the valid keys.  Each tile is
//      staged in shared memory in hi order (Onesweep's local sort), so
//      each hi bin's digits leave the tile as one run of stream slots; the
//      tile's hi order itself goes to the tile's span of the output, and
//      each run's stream slot to a small table;
//   2. level 2 (`lookback_rank_kernel<8, kLbLo>`) ranks lo over that
//      stream from zero starts: the earlier stream slots with the same lo.
//      Those are the earlier hi rows' keys of that lo, C[hi][lo], and the
//      earlier keys of the same digit in its own hi run (level 1 is
//      stable), so base[d] + that count is the key's rank, which level 2
//      writes at the stream slot (base reads stay within one or two hi
//      rows a tile);
//   3. `wide_unstage_kernel` undoes each tile's local sort: entry q of the
//      tile's hi order reads its rank from its run's stream slot + q
//      (consecutive reads along a run) and the tile leaves in arrival
//      order; a key outside [0, n_bins) gets 0.
// The digit's counts are the caller's: the sort's and the distributed
// pass's histogram, or one K1 launch of the wrapper for a bare call.
// Level 1 invalidates a key on its whole digit (a key in [n_bins, 256 n_hi)
// has a hi but no bin), so only the valid keys enter the stream; level 2
// runs over all n slots, and the slots past the valid keys (never read)
// only rank among themselves.  Reading a key's rank back in arrival order
// straight from its stream slot costs a random 32-byte sector a key (and
// one more for base); on the H100 such a gather was the slowest of the
// four launches, bound by L2 requests, so the tile-local unstaging reads
// runs instead.  The path moves about 32n bytes against the 8n of the
// bound; what holds it back most is the two levels' in-tile ranking and
// look-back, each about K2's time at 256 bins.
// Scratch (`wide_layout`): both levels' status words (tiles x (n_hi + 256)
// 64-bit words), the stream and level 2's ranks (4 bytes a key each), the
// runs (tiles x (n_hi + 1)), base, the hi starts and 256 zero starts.
//
// K3 (`scatter_rank_kernel`), the sorted-composite engine: a block of 512
// threads takes an 8192-key tile, staged with 16-byte cp.async, and sorts
// the composites digit << 13 | position stably in shared memory: LSD
// radix passes of up to 8 digit bits (one pass up to 256 bins, two up to
// 2^16), out-of-range keys in a last bucket of their own.  A pass is a
// per-warp multi-split: each warp ranks its 512 keys in slot order by
// ballot matching on the bucket bits (CUB's MatchAny), the warps' bucket
// counts go through one exclusive scan over the whole block (bucket-major,
// then warp: stable; odd-strided so a warp's buckets sit in different
// banks), and each key is written to its sorted slot.  The first sorted
// slot of every digit comes from the run boundaries of the sorted tile,
// and rank = start + sorted slot - first slot.  Its work per key grows
// with the digit's width in bits, not with its bins.  The carry:
//   - up to 256 bins (one pass): decoupled look-back in the same launch,
//     with K2's status words and look-back code (`publish_aggregate`,
//     `lookback_carry`).  The tile's count of each digit is its bucket's
//     total in the scan, published before the scatter so that the next
//     tiles' look-back meets it sooner; the run boundaries write each
//     digit's first slot to a shared array of n_bins entries.  Each thread
//     still holds the sorted slots of the keys it took in arrival order,
//     so the ranks leave from registers in arrival order, 128 bytes a
//     warp store.  No table, and the digits are read once;
//   - above 256 bins (up to 2^16): the explicit scan, over a tile-major
//     (tiles, n_bins) table of per-tile counts whose tile is the CTA's
//     8192 keys.  A counting launch of the same kernel sorts each tile and
//     writes each run's length into the CTA's own row (ascending digits, so
//     a warp's stores go to ascending addresses of one row), the wrapper
//     takes an exclusive cumulative sum down the tiles plus bin_start, and
//     the rank launch reads its row.  An n_bins array of first slots would
//     not fit in shared memory at 2^16 bins, so there each slot's first
//     slot is a max-scan of the run boundaries over the block; the ranks
//     are written to shared memory at the keys' arrival positions and
//     leave with 16-byte stores.
// What bounds K3 on the card is not the bytes: ballot matching (9 ballots
// a key at 8 bits) and the shared-memory traffic of the multi-split.
#include "common.cuh"

namespace {

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

// Decoupled look-back over per-(tile, bin) status words, all bins at once.
// Thread b < n_bins first publishes the tile's count of bin b (`total`)
// flagged "aggregate" ("prefix" for tile 0) with publish_aggregate, as
// early as the block knows it; then every thread of the kThreads-thread
// block (n_bins <= kThreads) calls lookback_carry, which returns bin b's
// keys in all earlier tiles to thread b and publishes the inclusive
// prefix.  The look-back runs over windows of
// span * kLbPolls predecessors: thread (c, b) sums bin b over its kLbPolls
// predecessors, nearest first, up to and including the first prefix (an
// empty prefix before tile 0); bin b's thread then adds the partials in
// order, up to the first that holds a prefix.  s_win holds kThreads
// partials, s_open n_bins flags.
__device__ __forceinline__ void publish_aggregate(unsigned long long* status,
                                                  int tile, int n_bins,
                                                  unsigned long long total) {
  if ((int)threadIdx.x < n_bins)
    publish(status + (long long)tile * n_bins + threadIdx.x,
            (tile == 0 ? kPrefix : kAggregate) | total);
}

template <int kThreads>
__device__ __forceinline__ unsigned long long lookback_carry(
    unsigned long long* status, int tile, int n_bins,
    unsigned long long total, uint32_t* s_win, bool* s_open) {
  const int tid = threadIdx.x;
  if (tid < n_bins) s_open[tid] = tile > 0;
  __syncthreads();
  const int span = kThreads / n_bins;
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
  if (tid < n_bins && tile > 0)
    publish(status + (long long)tile * n_bins + tid, kPrefix | (carry + total));
  return carry;
}

// s_keys holds 16-byte chunk c at c ^ (c >> 3 & 7): thread t's blocked
// reads of chunks 8t .. 8t + 7 and the block's reads of consecutive
// chunks are then both free of bank conflicts
static_assert(kLbItems == 32, "the swizzle assumes 8 chunks a thread");
__device__ __forceinline__ int swizzle_chunk(int c) { return c ^ (c >> 3 & 7); }
__device__ __forceinline__ int swizzle(int pos) {
  return swizzle_chunk(pos >> 2) << 2 | (pos & 3);
}

// Exclusive prefix sum of x over the block's kThreads threads in thread
// order; *sum gets the block's total.  Every thread calls it.  s_part
// holds kThreads / 32 words.
template <int kThreads>
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t x,
                                                        uint32_t* s_part,
                                                        uint32_t* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(fs::kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  uint32_t before = incl - x, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const uint32_t p = s_part[w];
    before += w < warp ? p : 0u;
    all += p;
  }
  *sum = all;
  return before;
}

// What a launch of the look-back kernel ranks (see below).
enum LbMode { kLbPlain, kLbHi, kLbLo };

// The two-level path's extra operands: n_digits (the digit's bins), and
// for kLbHi the hi-major digit stream and the tiles' runs it writes, for
// kLbLo the digits' bases it adds.
struct WideArgs {
  int n_digits;
  int32_t* stream;
  int32_t* runs;
  const int32_t* base;
};

// kLbHi keeps, beside the static arrays, the tile's first slot of each hi
// bin, the scan's partials and, in hi order, the keys' positions in the
// tile in dynamic shared memory.
constexpr int kHiSmem =
    (kLbMaxBins + kLbWarps) * sizeof(uint32_t) + kLbTile * sizeof(uint16_t);

// status[tile * n_bins + b]: bin b of a tile; *tile_counter starts at 0.
// kBits: digit bits (n_bins <= 2^kBits).  vec: keys and rank are 16-byte
// aligned (whole tiles load and store 16 bytes a thread).
//
// kLbPlain ranks each key's digit ((uint32_t)key >> shift) & mask, taken
// as the staged tile is read (a digit stream: shift 0, mask ~0).
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
// keys of its bin before the thread's (or warp's) first, << kShift | its
// digit, or -1.
//
// The two-level path's levels keep the whole 16-bit digit in a slot
// (kShift 16) and take a key as valid below wide.n_digits:
//   - kLbHi (level 1): the bins are the digits' hi bytes (n_bins = n_hi)
//     and bin_start holds their dense starts.  The tile's keys are staged
//     in hi order; each hi bin's digits go to one run of the stream
//     (wide.stream), the tile's hi-order positions (hi << 13 | position in
//     the tile) to its own span of rank, and each run's stream slot less
//     its first position in the tile, then the tile's valid keys, to
//     wide.runs[tile * (n_hi + 1) ...].  Launched with kHiSmem bytes of
//     dynamic shared memory.
//   - kLbLo (level 2, over the stream): the bins are the digits' lo
//     bytes, bin_start is zero, and a slot's rank is wide.base[digit] +
//     its lo byte's earlier slots.
template <int kBits, int kMode>
__global__ void __launch_bounds__(kLbThreads)
lookback_rank_kernel(const int32_t* __restrict__ keys, int n,
                     const int32_t* __restrict__ bin_start,
                     int32_t* __restrict__ rank, int n_bins,
                     unsigned long long* status,
                     unsigned long long* tile_counter, int vec,
                     WideArgs wide, int shift, uint32_t mask) {
  constexpr bool kThreadCounts = kBits <= 4;
  constexpr int kGroupKeys = kThreadCounts ? kLbItems : kLbWarpKeys;
  constexpr int kShift = kMode == kLbPlain ? 8 : 16;
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

  // the digit of a staged key: (key >> shift) & mask on its uint32 bits
  // (kLbPlain; a digit stream passes shift 0 and mask ~0, the key itself)
  auto digit_of = [&](int key) -> int {
    if constexpr (kMode == kLbPlain)
      return (int)(((uint32_t)key >> shift) & mask);
    else
      return key;
  };
  // a digit's bin, -1 for a digit that has none
  auto bin_of = [&](int key) -> int {
    if constexpr (kMode == kLbPlain)
      return key;
    else if ((unsigned)key >= (unsigned)wide.n_digits)
      return -1;
    else
      return kMode == kLbHi ? key >> 8 : key & 0xff;
  };
  // the bin of a ranked slot (>= 0)
  auto slot_bin = [](int e) -> int {
    return kMode == kLbHi ? (e & 0xffff) >> 8 : e & 0xff;
  };

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
        const int key = digit_of(kv[u]), bin = bin_of(key);
        const bool valid = (unsigned)bin < (unsigned)n_bins &&
                           kLbItems * tid + 4 * j + u < len;
        const int q = bin >> 2, sh = 8 * (bin & 3);
        const uint32_t cur = q == 0 ? c[0] : q == 1 ? c[1] : q == 2 ? c[2] : c[3];
        const uint32_t inc = valid ? 1u << sh : 0u;
#pragma unroll
        for (int w = 0; w < 4; ++w) c[w] += q == w ? inc : 0u;
        kv[u] = valid ? (int)((cur >> sh) & 0xff) << kShift | key : -1;
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
      const int key = pos < len ? digit_of(s_keys[swizzle(pos)]) : -1;
      const int bin = bin_of(key);
      const bool valid = (unsigned)bin < (unsigned)n_bins;
      unsigned peers = __ballot_sync(fs::kFullMask, valid);
#pragma unroll
      for (int bit = 0; bit < kBits; ++bit) {
        const bool set = (bin >> bit) & 1;
        const unsigned votes = __ballot_sync(fs::kFullMask, set);
        peers &= set ? votes : ~votes;
      }
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (valid && lane == leader) {
        before = cnt[bin];
        cnt[bin] = before + __popc(peers);
      }
      before = __shfl_sync(fs::kFullMask, before, leader & 31);
      __syncwarp();  // the new count is visible to the next step
      if (pos < len)
        s_keys[swizzle(pos)] =
            valid ? (before + __popc(peers & fs::lanemask_lt(lane))) << kShift | key
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

  publish_aggregate(status, tile, n_bins, total);

  // the first slot, in the tile, of bin `bin` among the keys of `group`
  // (a thread's 32 keys or a warp's 1024)
  const uint16_t* first16 = reinterpret_cast<const uint16_t*>(s_count);
  auto first_slot = [&](int group, int bin) -> uint32_t {
    return kThreadCounts ? first16[16 * group + bin]
                         : (uint32_t)s_count[group * kLbMaxBins + bin];
  };

  extern __shared__ __align__(16) uint32_t lb_hi_smem[];
  uint32_t* s_toff = lb_hi_smem;  // kLbHi: the tile's first slot of a hi bin
  uint16_t* s_stage = reinterpret_cast<uint16_t*>(s_toff + kLbMaxBins + kLbWarps);
  uint32_t tile_valid = 0;  // kLbHi: the tile's valid keys
  if constexpr (kMode == kLbHi) {
    // stage the tile in hi order while earlier tiles finish: the key at
    // position pos goes to s_stage[its bin's first slot + its rank]
    const uint32_t toff = block_exclusive_sum<kLbThreads>(
        tid < n_bins ? (uint32_t)total : 0u, s_toff + kLbMaxBins, &tile_valid);
    if (tid < n_bins) s_toff[tid] = toff;
    __syncthreads();
    for (int c = tid; 4 * c < len; c += kLbThreads) {
      const int4 e4 = reinterpret_cast<const int4*>(s_keys)[swizzle_chunk(c)];
      const int e[4] = {e4.x, e4.y, e4.z, e4.w};
      const int group = 4 * c / kGroupKeys;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * c + u < len && e[u] >= 0) {
          const int h = slot_bin(e[u]);
          s_stage[s_toff[h] + first_slot(group, h) + (e[u] >> kShift)] =
              (uint16_t)(4 * c + u);
        }
      }
    }
  }

  const unsigned long long carry = lookback_carry<kLbThreads>(
      status, tile, n_bins, total, s_win, s_open);
  if (tid < n_bins) s_base[tid] = (uint32_t)bin_start[tid] + (uint32_t)carry;
  __syncthreads();

  if constexpr (kMode == kLbHi) {
    // hi bin h's keys take stream slots s_base[h] + [0, its count): one
    // run, in the tile's hi order (a slot past n only with counts that are
    // not the keys')
    for (int q = tid; q < (int)tile_valid; q += kLbThreads) {
      const int pos = s_stage[q];
      const int key = s_keys[swizzle(pos)] & 0xffff, h = key >> 8;
      const uint32_t dst = s_base[h] - s_toff[h] + (uint32_t)q;
      if (dst < (uint32_t)n) wide.stream[dst] = key;
      rank[lo + q] = h << 13 | pos;
    }
    int32_t* runs = wide.runs + (long long)tile * (n_bins + 1);
    if (tid < n_bins) runs[tid] = (int32_t)(s_base[tid] - s_toff[tid]);
    if (tid == 0) runs[n_bins] = (int32_t)tile_valid;
    return;
  } else {
    // rank = bin_start + earlier tiles + the group's first slot + rank in
    // the group (+ the digit's base, kLbLo); 16-byte stores
    for (int c = tid; 4 * c < len; c += kLbThreads) {
      const int4 e4 = reinterpret_cast<const int4*>(s_keys)[swizzle_chunk(c)];
      const int e[4] = {e4.x, e4.y, e4.z, e4.w};
      const int group = 4 * c / kGroupKeys;
      int r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = e[u] < 0 ? 0 : slot_bin(e[u]);
        uint32_t v = s_base[key] + first_slot(group, key) +
                     (uint32_t)(e[u] >> kShift);
        if constexpr (kMode == kLbLo)
          v += e[u] < 0 ? 0u : (uint32_t)wide.base[e[u] & 0xffff];
        r[u] = e[u] < 0 ? 0 : (int32_t)v;
      }
      if (vec && 4 * c + 3 < len) {
        *reinterpret_cast<int4*>(rank + lo + 4 * c) =
            make_int4(r[0], r[1], r[2], r[3]);
      } else {
        for (int u = 0; u < 4 && 4 * c + u < len; ++u) rank[lo + 4 * c + u] = r[u];
      }
    }
  }
}

// ---- K2 from 257 to 2^16 bins: the two-level rank ----------------------------

constexpr int kLoBits = 8;                 // a digit's low bits: level 2
constexpr int kLoBins = 1 << kLoBits;
constexpr int kMaxDigitBins = 1 << 16;
constexpr int kPrepThreads = 1024;
constexpr int kPrepSegs = kPrepThreads / kLoBins;  // row segments a column
constexpr int kUnstageThreads = 256;
static_assert(kLoBins == kLbMaxBins, "level 2 is the 256-bin sweep");
static_assert(kLbTile == 1 << 13, "an entry keeps its position in 13 bits");

// Block 0: hi_start[h] = the valid keys of the hi rows before h (the
// counts' rows summed, then an exclusive scan), base[d] = bin_start[d] -
// C[hi][lo] with C[hi][lo] = sum over h < hi of counts[h * 256 + lo]
// (each column scanned by kPrepSegs threads, one row segment each), and
// zeros[0, 256) = 0.  Blocks 1.. zero words[0, n_words).
__global__ void __launch_bounds__(kPrepThreads)
wide_prep_kernel(const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ bin_start, int n_bins, int n_hi,
                 int32_t* __restrict__ base, int32_t* __restrict__ hi_start,
                 int32_t* __restrict__ zeros,
                 unsigned long long* __restrict__ words, long long n_words) {
  const int tid = threadIdx.x;
  if (blockIdx.x > 0) {
    const long long step = (long long)(gridDim.x - 1) * kPrepThreads;
    for (long long w = (long long)(blockIdx.x - 1) * kPrepThreads + tid;
         w < n_words; w += step)
      words[w] = 0ull;
    return;
  }
  __shared__ uint32_t s_col[kPrepSegs][kLoBins];  // a segment's column sums
  __shared__ uint32_t s_row[kLbMaxBins];           // a hi row's keys
  __shared__ uint32_t s_part[kPrepThreads / 32];
  const int col = tid % kLoBins, seg = tid / kLoBins, lane = tid & 31;
  const int rows = (n_hi + kPrepSegs - 1) / kPrepSegs;
  const int h0 = min(seg * rows, n_hi), h1 = min(h0 + rows, n_hi);
  if (tid < kLbMaxBins) s_row[tid] = 0;
  __syncthreads();
  uint32_t sum = 0;
#pragma unroll 4
  for (int h = h0; h < h1; ++h) {  // warp-uniform bounds
    const int d = h * kLoBins + col;
    const uint32_t c = d < n_bins ? (uint32_t)counts[d] : 0u;
    sum += c;
    uint32_t r = c;  // the warp's 32 columns of row h
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(fs::kFullMask, r, o);
    if (lane == 0) atomicAdd(&s_row[h], r);
  }
  s_col[seg][col] = sum;
  __syncthreads();
  uint32_t run = 0;  // the column's keys in rows before h
  for (int s = 0; s < seg; ++s) run += s_col[s][col];
#pragma unroll 4
  for (int h = h0; h < h1; ++h) {
    const int d = h * kLoBins + col;
    if (d < n_bins) {
      base[d] = (int32_t)((uint32_t)bin_start[d] - run);
      run += (uint32_t)counts[d];
    }
  }
  if (tid < kLoBins) zeros[tid] = 0;
  uint32_t all;
  const uint32_t before = block_exclusive_sum<kPrepThreads>(
      tid < n_hi ? s_row[tid] : 0u, s_part, &all);
  if (tid < n_hi) hi_start[tid] = (int32_t)before;
}

// One tile a block.  The tile's span of rank holds level 1's entries in
// hi order, hi << 13 | position in the tile, and runs its run bases and
// its valid keys; entry q's rank is within[run base of its hi + q],
// written at its position (the reads of one hi run are consecutive).
// Positions no entry names, the keys outside [0, n_bins), get 0.  The
// tile leaves in arrival order, 16 bytes a thread where rank is 16-byte
// aligned (vec).
__global__ void __launch_bounds__(kUnstageThreads)
wide_unstage_kernel(const int32_t* __restrict__ within,
                    const int32_t* __restrict__ runs, int32_t* rank, int n,
                    int n_hi, int vec) {
  __shared__ __align__(16) int32_t s_out[kLbTile];
  __shared__ uint32_t s_run[kLbMaxBins];
  const int tid = threadIdx.x;
  const long long lo = (long long)blockIdx.x * kLbTile;
  const int len = (int)min((long long)kLbTile, (long long)n - lo);
  const int32_t* run = runs + (long long)blockIdx.x * (n_hi + 1);
  if (tid < n_hi) s_run[tid] = (uint32_t)run[tid];
  const int valid = run[n_hi];
  for (int c = tid; c < kLbTile / 4; c += kUnstageThreads)
    reinterpret_cast<int4*>(s_out)[c] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int q = tid; q < valid; q += kUnstageThreads) {
    const int entry = rank[lo + q];
    const uint32_t k = s_run[entry >> 13] + (uint32_t)q;
    s_out[entry & (kLbTile - 1)] = k < (uint32_t)n ? within[k] : 0;
  }
  __syncthreads();
  if (vec && len == kLbTile) {
    for (int c = tid; c < kLbTile / 4; c += kUnstageThreads)
      reinterpret_cast<int4*>(rank + lo)[c] =
          reinterpret_cast<const int4*>(s_out)[c];
  } else {
    for (int e = tid; e < len; e += kUnstageThreads) rank[lo + e] = s_out[e];
  }
}

// Byte offsets of the wide path's scratch, each region 16-byte aligned:
// level 1's status words (tiles x n_hi, then the tile counter), level 2's
// (tiles x 256, then its counter), the stream, within, the tiles' runs
// (tiles x (n_hi + 1)), base, the hi starts and 256 zero starts.  The
// status words [0, stream) start zeroed.
struct WideLayout {
  long long status2, stream, within, runs, base, hi_start, zeros, bytes;
};

inline long long up16(long long b) { return (b + 15) & ~15LL; }

inline WideLayout wide_layout(long long n, int n_bins) {
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  const int n_hi = (n_bins + kLoBins - 1) / kLoBins;
  WideLayout L;
  L.status2 = up16(8 * (tiles * n_hi + 1));
  L.stream = L.status2 + up16(8 * (tiles * kLoBins + 1));
  L.within = L.stream + up16(4 * n);
  L.runs = L.within + up16(4 * n);
  L.base = L.runs + up16(4 * tiles * (n_hi + 1));
  L.hi_start = L.base + up16(4LL * n_bins);
  L.zeros = L.hi_start + up16(4LL * n_hi);
  L.bytes = L.zeros + 4LL * kLoBins;
  return L;
}

// ---- K3, the sorted-composite engine ---------------------------------------------

constexpr int kScWarps = 16;
constexpr int kScThreads = 32 * kScWarps;          // 512
constexpr int kScItems = 16;                       // keys a thread
constexpr int kScWarpKeys = 32 * kScItems;         // sorted slots a warp
constexpr int kScTile = kScThreads * kScItems;     // 8192 keys a tile
constexpr int kScPosBits = 13;                     // log2(kScTile)
constexpr uint32_t kScPosMask = (1u << kScPosBits) - 1u;
constexpr int kScPassBits = 8;                     // digit bits a sort pass
constexpr int kScMaxBits = 16;                     // widest digit
constexpr uint32_t kScPad = 1u << kScMaxBits;      // an out-of-range key's digit
// bucket counts [bucket][warp] at bucket * kScStride + warp: the odd
// stride puts different buckets of one warp in different banks
constexpr int kScStride = kScWarps + 1;
constexpr int kScCountWords = ((1 << kScPassBits) + 1) * kScStride;
constexpr int kScLbMaxBins = 256;  // one look-back thread a bin
constexpr size_t kScSmem = (2 * kScTile + kScCountWords) * sizeof(uint32_t);
static_assert(kScTile == 1 << kScPosBits, "positions fill the low bits");
static_assert(kScMaxBits + 1 + kScPosBits <= 32, "composites fit 32 bits");
static_assert(kScLbMaxBins <= kScThreads, "one look-back thread a bin");

// kScLookback: ranks, carry by look-back (n_bins <= kScLbMaxBins);
// kScCount: per-tile counts into a tile-major table; kScRank: ranks from
// the table's per-tile starting slots
enum ScatterMode { kScLookback, kScCount, kScRank };

// Exclusive prefix sum of a[0, total) in place, over the whole block.
__device__ __forceinline__ void block_exclusive_scan(int* a, int total,
                                                     int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (total + kScThreads - 1) / kScThreads;
  const int lo = min(tid * per, total), hi = min(lo + per, total);
  int sum = 0;
  for (int e = lo; e < hi; ++e) sum += a[e];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(fs::kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += s_warp[w];
  for (int e = lo; e < hi; ++e) {
    const int v = a[e];
    a[e] = run;
    run += v;
  }
  __syncthreads();
}

// One 8192-key tile a block (tile kScLookback: from the tile counter;
// else blockIdx.x).  `start`: bin_start (kScLookback) or the (tiles,
// n_bins) starting slots (kScRank); `out`: the ranks, or the zeroed
// (tiles, n_bins) table (kScCount).  vec: 16-byte aligned keys (and
// ranks), so whole tiles move 16 bytes a thread.
template <int kMode>
__global__ void __launch_bounds__(kScThreads, 2)
scatter_rank_kernel(const int32_t* __restrict__ keys, int n,
                    const int32_t* __restrict__ start,
                    int32_t* __restrict__ out, int n_bins, int digit_bits,
                    unsigned long long* status,
                    unsigned long long* tile_counter, int vec) {
  extern __shared__ __align__(16) uint32_t sc_smem[];
  uint32_t* buf0 = sc_smem;
  uint32_t* buf1 = sc_smem + kScTile;
  int* cnt = reinterpret_cast<int*>(sc_smem + 2 * kScTile);
  __shared__ int s_warp[kScWarps];
  __shared__ int s_tile;
  __shared__ int s_first[kScLbMaxBins];
  __shared__ uint32_t s_off[kScLbMaxBins];  // start + carry - first slot
  __shared__ uint32_t s_win[kScThreads];
  __shared__ bool s_open[kScLbMaxBins];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (kMode == kScLookback) {
    if (tid == 0) s_tile = (int)atomicAdd(tile_counter, 1ull);
    if (tid < n_bins) s_first[tid] = 0;
    __syncthreads();
  }
  const int tile = kMode == kScLookback ? s_tile : (int)blockIdx.x;
  const long long lo = (long long)tile * kScTile;
  const int len = (int)min((long long)kScTile, (long long)n - lo);
  if (vec && len == kScTile) {
    for (int c = tid; c < kScTile / 4; c += kScThreads)
      fs::cp_async16(buf0 + 4 * c, keys + lo + 4 * c, 16);
    fs::cp_async_commit();
    fs::cp_async_wait<0>();
  } else {
    for (int e = tid; e < len; e += kScThreads) buf0[e] = (uint32_t)keys[lo + e];
  }
  __syncthreads();

  // the composite digit << 13 | arrival position in the warp's slot
  // warp * 512 + 32 i + lane: made from the staged keys in pass 0 (slots
  // past the tile's end are out of range), read from the previous pass's
  // sorted tile after it (re-read rather than held: registers)
  const int passes = max(1, (digit_bits + kScPassBits - 1) / kScPassBits);
  uint32_t* sorted = buf0;
  auto composite = [&](int pass, int i) -> uint32_t {
    const int e = warp * kScWarpKeys + 32 * i + lane;
    if (pass > 0) return sorted[e];
    const int key = e < len ? (int)buf0[e] : -1;
    const uint32_t d =
        (unsigned)key < (unsigned)n_bins ? (uint32_t)key : kScPad;
    return d << kScPosBits | (uint32_t)e;
  };

  // stable LSD passes: rank within the warp in slot order, one block-wide
  // scan of the (bucket, warp) counts, write to the sorted slot; r[i]
  // ends as the sorted slot of the pass's key i
  int r[kScItems];
  unsigned long long total = 0;  // kScLookback, tid < n_bins: bin tid's keys
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kScPassBits;
    const int bits = max(1, min(kScPassBits, digit_bits - shift));
    const int pad_bucket = 1 << bits;
    const uint32_t mask = (uint32_t)pad_bucket - 1u;
    const int words = (pad_bucket + 1) * kScStride;
    for (int e = tid; e < words; e += kScThreads) cnt[e] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScItems; ++i) {
      const uint32_t d = composite(pass, i) >> kScPosBits;
      const bool pad = d >= kScPad;
      const int bucket = pad ? pad_bucket : (int)((d >> shift) & mask);
      const unsigned pads = __ballot_sync(fs::kFullMask, pad);
      unsigned peers = pad ? pads : ~pads;
#pragma unroll
      for (int bit = 0; bit < kScPassBits; ++bit) {
        if (bit < bits) {
          const bool set = (bucket >> bit) & 1;
          const unsigned votes = __ballot_sync(fs::kFullMask, set);
          peers &= set ? votes : ~votes;
        }
      }
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader) {
        int* slot = &cnt[bucket * kScStride + warp];
        before = *slot;
        *slot = before + __popc(peers);
      }
      r[i] = __shfl_sync(fs::kFullMask, before, leader) +
             __popc(peers & fs::lanemask_lt(lane));
      __syncwarp();  // the new count is visible to the next step
    }
    __syncthreads();
    block_exclusive_scan(cnt, words, s_warp);
    if (kMode == kScLookback) {
      // one pass: bucket b is digit b, and its count across the warps is
      // known now; publishing it before the scatter lets the next tiles'
      // look-back meet it sooner
      total = tid < n_bins ? (unsigned long long)(
                                 cnt[(tid + 1) * kScStride] - cnt[tid * kScStride])
                           : 0;
      publish_aggregate(status, tile, n_bins, total);
    }
    uint32_t* dst = (pass & 1) ? buf0 : buf1;
#pragma unroll
    for (int i = 0; i < kScItems; ++i) {
      const uint32_t c = composite(pass, i), d = c >> kScPosBits;
      const int bucket = d >= kScPad ? pad_bucket : (int)((d >> shift) & mask);
      r[i] += cnt[bucket * kScStride + warp];
      dst[r[i]] = c;
    }
    sorted = dst;
    __syncthreads();
  }
  uint32_t* ranks = sorted == buf0 ? buf1 : buf0;  // by arrival position

  if constexpr (kMode == kScLookback) {
    // run boundaries of the sorted tile: each digit's first slot (the
    // slot before comes from the lower lane, or a read for lane 0)
#pragma unroll 4
    for (int i = 0; i < kScItems; ++i) {
      const int s = warp * kScWarpKeys + 32 * i + lane;
      const uint32_t d = sorted[s] >> kScPosBits;
      uint32_t prev = __shfl_up_sync(fs::kFullMask, d, 1);
      if (lane == 0) prev = s ? sorted[s - 1] >> kScPosBits : ~0u;
      if (d < kScPad && d != prev) s_first[d] = s;
    }
    __syncthreads();
    const unsigned long long carry = lookback_carry<kScThreads>(
        status, tile, n_bins, total, s_win, s_open);
    if (tid < n_bins)
      s_off[tid] = (uint32_t)start[tid] + (uint32_t)carry - (uint32_t)s_first[tid];
    __syncthreads();
    // one pass: the arrival-order thread of each key holds its sorted
    // slot, so its rank leaves from registers, 128 bytes a warp store
#pragma unroll
    for (int i = 0; i < kScItems; ++i) {
      const int e = warp * kScWarpKeys + 32 * i + lane;
      if (e < len) {
        const int key = (int)buf0[e];
        out[lo + e] = (unsigned)key < (unsigned)n_bins
                          ? (int32_t)(s_off[key] + (uint32_t)r[i]) : 0;
      }
    }
    return;
  } else {
    // first slot of each slot's run: a max-scan of the run boundaries in
    // slot order (within the warp by shuffles, then over earlier warps)
    int first[kScItems];
    int run = 0;
#pragma unroll
    for (int i = 0; i < kScItems; ++i) {
      const int s = warp * kScWarpKeys + 32 * i + lane;
      const uint32_t d = sorted[s] >> kScPosBits;
      int m = s == 0 || (sorted[s - 1] >> kScPosBits) != d ? s : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(fs::kFullMask, m, o);
        if (lane >= o) m = max(m, y);
      }
      m = max(m, run);
      run = __shfl_sync(fs::kFullMask, m, 31);
      first[i] = m;
    }
    if (lane == 0) s_warp[warp] = run;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before = max(before, s_warp[w]);
    const long long row = (long long)tile * n_bins;
#pragma unroll
    for (int i = 0; i < kScItems; ++i) {
      const int s = warp * kScWarpKeys + 32 * i + lane;
      const uint32_t cs = sorted[s], d = cs >> kScPosBits;
      const int f = max(first[i], before);
      if (kMode == kScCount) {
        if (d < kScPad &&
            (s == kScTile - 1 || (sorted[s + 1] >> kScPosBits) != d))
          out[row + d] = s + 1 - f;
      } else {
        const int o = (int)(cs & kScPosMask);
        if (o < len)
          ranks[o] = d < kScPad ? (uint32_t)(start[row + d] + s - f) : 0u;
      }
    }
  }
  if (kMode == kScCount) return;
  __syncthreads();
  // the tile's ranks leave in arrival order, 16 bytes a thread
  if (vec && len == kScTile) {
    for (int q = tid; q < kScTile / 4; q += kScThreads)
      reinterpret_cast<int4*>(out + lo)[q] =
          reinterpret_cast<const int4*>(ranks)[q];
  } else {
    for (int e = tid; e < len; e += kScThreads) out[lo + e] = (int32_t)ranks[e];
  }
}

template <int kMode>
int launch_scatter(const void* keys, long long n, const void* start,
                   void* out, int n_bins, void* status, cudaStream_t s) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n_bins < 1 || n_bins > (1 << kScMaxBits) || n >= (1LL << 31) ||
      (kMode == kScLookback && n_bins > kScLbMaxBins))
    return (int)cudaErrorInvalidValue;
  int digit_bits = 0;
  while ((1 << digit_bits) < n_bins) ++digit_bits;
  const long long tiles = (n + kScTile - 1) / kScTile;
  auto kernel = scatter_rank_kernel<kMode>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kScSmem);
  auto* words = (unsigned long long*)status;
  const bool vec = (uintptr_t)keys % 16 == 0 &&
                   (kMode == kScCount || (uintptr_t)out % 16 == 0);
  kernel<<<(unsigned)tiles, kScThreads, kScSmem, s>>>(
      (const int32_t*)keys, (int)n, (const int32_t*)start, (int32_t*)out,
      n_bins, digit_bits, words, words ? words + tiles * n_bins : nullptr,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Keys a tile of fs_rank_lookback, which sizes its status buffer.
FS_EXPORT int fs_rank_lookback_tile() { return kLbTile; }

// K2 up to 256 bins: ranks in one launch.  `status` holds
// ceil(n / fs_rank_lookback_tile()) * n_bins + 1 zeroed 64-bit words (the
// per-tile status words, then the tile counter).  A key's digit is
// ((uint32_t)key >> shift) & mask (a digit stream: shift 0, mask ~0).
FS_EXPORT int fs_rank_lookback(const void* keys, long long n,
                               const void* bin_start, void* rank, int n_bins,
                               void* status, int shift, unsigned mask,
                               void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n_bins < 1 || n_bins > kLbMaxBins || n >= (1LL << 31) || shift < 0 ||
      shift > 31)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  auto* words = (unsigned long long*)status;
  auto kernel = n_bins <= 16 ? lookback_rank_kernel<4, kLbPlain>
                             : lookback_rank_kernel<8, kLbPlain>;
  kernel<<<(unsigned)tiles, kLbThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int)n, (const int32_t*)bin_start,
      (int32_t*)rank, n_bins, words, words + tiles * n_bins,
      (uintptr_t)keys % 16 == 0 && (uintptr_t)rank % 16 == 0, WideArgs{},
      shift, (uint32_t)mask);
  return (int)cudaGetLastError();
}

// K2 from 257 to 2^16 bins: the two-level rank, four launches (prep, level
// 1, level 2, unstage).  `counts` is the histogram of keys over [0, n_bins)
// (out-of-range keys not counted); `scratch` is 16-byte aligned and holds
// at least wide_layout(n, n_bins).bytes bytes (the wrapper's
// `wide_rank_scratch_bytes`), of any content; fewer is refused.
FS_EXPORT int fs_rank_wide(const void* keys, long long n, const void* counts,
                           const void* bin_start, void* rank, int n_bins,
                           void* scratch, long long scratch_bytes,
                           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const WideLayout L = wide_layout(n, n_bins);
  if (n_bins <= kLbMaxBins || n_bins > kMaxDigitBins || n >= (1LL << 31) ||
      scratch_bytes < L.bytes || (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  char* mem = (char*)scratch;
  auto* status1 = (unsigned long long*)mem;
  auto* status2 = (unsigned long long*)(mem + L.status2);
  WideArgs wide{n_bins, (int32_t*)(mem + L.stream), (int32_t*)(mem + L.runs),
                (const int32_t*)(mem + L.base)};
  auto* within = (int32_t*)(mem + L.within);
  auto* hi_start = (int32_t*)(mem + L.hi_start);
  auto* zeros = (int32_t*)(mem + L.zeros);
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  const int n_hi = (n_bins + kLoBins - 1) / kLoBins;

  const long long words = L.stream / 8;
  const int zero_blocks = fs::grid_for(words, 4LL * kPrepThreads,
                                       4 * fs::sm_count());
  wide_prep_kernel<<<1 + zero_blocks, kPrepThreads, 0, st>>>(
      (const int32_t*)counts, (const int32_t*)bin_start, n_bins, n_hi,
      (int32_t*)wide.base, hi_start, zeros, status1, words);

  auto level1 = n_hi <= 16 ? lookback_rank_kernel<4, kLbHi>
                           : lookback_rank_kernel<8, kLbHi>;
  cudaFuncSetAttribute(level1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kHiSmem);
  level1<<<(unsigned)tiles, kLbThreads, kHiSmem, st>>>(
      (const int32_t*)keys, (int)n, hi_start, (int32_t*)rank, n_hi, status1,
      status1 + tiles * n_hi, (uintptr_t)keys % 16 == 0, wide, 0, ~0u);

  lookback_rank_kernel<8, kLbLo><<<(unsigned)tiles, kLbThreads, 0, st>>>(
      wide.stream, (int)n, zeros, within, kLoBins, status2,
      status2 + tiles * kLoBins, 1, wide, 0, ~0u);

  wide_unstage_kernel<<<(unsigned)tiles, kUnstageThreads, 0, st>>>(
      within, wide.runs, (int32_t*)rank, (int)n, n_hi,
      (uintptr_t)rank % 16 == 0);
  return (int)cudaGetLastError();
}

// Keys a tile of the K3 launches, which sizes their status buffer and
// table.
FS_EXPORT int fs_rank_scatter_tile() { return kScTile; }

// K3 up to 256 bins: ranks in one launch.  `status` holds
// ceil(n / fs_rank_scatter_tile()) * n_bins + 1 zeroed 64-bit words (the
// per-tile status words, then the tile counter).
FS_EXPORT int fs_rank_scatter_lookback(const void* keys, long long n,
                                       const void* bin_start, void* rank,
                                       int n_bins, void* status,
                                       void* stream) {
  return launch_scatter<kScLookback>(keys, n, bin_start, rank, n_bins, status,
                                     (cudaStream_t)stream);
}

// K3 above 256 bins, step 1: table[t * n_bins + b] = #{i in tile t :
// keys[i] == b} into a zeroed (tiles, n_bins) table.
FS_EXPORT int fs_rank_scatter_counts(const void* keys, long long n,
                                     void* table, int n_bins, void* stream) {
  return launch_scatter<kScCount>(keys, n, nullptr, table, n_bins, nullptr,
                                  (cudaStream_t)stream);
}

// K3 above 256 bins, step 2: ranks from starts[t * n_bins + b], tile t's
// first slot of bin b.
FS_EXPORT int fs_rank_scatter(const void* keys, long long n,
                              const void* starts, void* rank, int n_bins,
                              void* stream) {
  return launch_scatter<kScRank>(keys, n, starts, rank, n_bins, nullptr,
                                 (cudaStream_t)stream);
}
