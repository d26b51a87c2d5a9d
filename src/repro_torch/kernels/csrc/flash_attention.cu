// K5: blockwise (flash) attention with an online softmax, on the tensor
// cores (mma.sync).
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_kernel` of
// src/repro/kernels/flash_attention.py (the pallas_call at line 106).
// There, heads fold into the grid's batch axis, the kv-block axis is the
// innermost, sequential grid axis, and the running max, denominator and
// accumulator stay pinned in VMEM scratch across it.  q, k and v are
// transposed to (B*H, S, hd) and padded to whole blocks in HBM first.
//
// What it computes (the same function): for each (b, h) and query row,
// s = (q . k) * scale with scale = 1/sqrt(hd); keys at k_pos >= Skv, and
// when causal keys at k_pos > q_pos (both counted from 0, no offset), get
// the finite -1e30, never -inf, so edge rows agree with the reference;
// m, l and acc are fp32; the output is acc / max(l, 1e-30) in q's dtype.
// As in the reference, the P.V product sees p rounded to v's dtype (a
// no-op in fp32) while l sums the unrounded p.
//
// Bound on the H100: operations.  QK^T and PV are 4*B*H*hd flops per
// visible (q, k) pair: 34.4 GFLOP at the prefill shape (B 2, S 2048,
// H 32, hd 64, causal), against 989 TFLOP/s of bf16 tensor cores
// (0.035 ms), while q, k, v and out are 4 x 33.5 MB in fp32 (0.04 ms at
// 3.35 TB/s).  The fp32 instance runs each product as three TF32
// products (below) on the 495 TFLOP/s TF32 tensor cores: 3 x 34.4 GFLOP,
// 0.208 ms.
//
// Design (FlashAttention-2's structure on mma.sync):
//   - one block of 4 warps per (b*H + h, q tile).  Each warp owns two
//     16-row m-tiles up to hd 64 (a 128-row q tile; each K and V fragment
//     feeds two products) and one above (a 64-row q tile; registers), keeps
//     their m, l and output accumulator in mma fragments, and loops over
//     64-key tiles (the TPU's sequential grid axis);
//   - K and V tiles are staged in shared memory with 16-byte cp.async,
//     double-buffered: tile j+1 loads while tile j computes.  q, k, v are
//     read in their (B, S, H, hd) layout through strides (no transposes or
//     pads in device memory); rows past S and columns past hd are
//     zero-filled in shared memory (zero V rows matter: masked p is
//     exactly 0, but 0 x garbage can be NaN).  Rows that are not 16-byte
//     aligned, or an hd that is not a multiple of 8, take an element-wise
//     load into the same layout.  Shared-memory rows are padded by 16
//     bytes, so ldmatrix and the fp32 fragment loads are conflict-free;
//   - bf16: mma.m16n8k16 (bf16 x bf16 -> fp32).  Q fragments stay in
//     registers (ldmatrix), K through ldmatrix, V through ldmatrix.trans;
//     S = QK^T accumulates in fp32 fragments, the online softmax runs on
//     them (row max and sum shuffled across the 4 lanes of a row), and p,
//     rounded to bf16, is fed back from the S fragments as the A operand
//     of PV;
//   - the softmax works in base 2 with the scale folded in, as FA2 does:
//     the row max m is taken on the raw scores and
//     p = 2^(s * scale * log2 e - m * scale * log2 e), one FFMA and one
//     ex2 an element.  A masked raw score is -1e30, so its p is exactly 0
//     as before;
//   - fp32: 3xTF32 on mma.m16n8k8.  Each operand x splits into
//     big = tf32_rna(x) and small = tf32_rna(x - big); the products
//     small*big + big*small + big*big accumulate in fp32 (CUTLASS's "fast
//     fp32"), which keeps about fp32's accuracy (plain TF32 keeps about
//     three digits).  Fragments load from shared memory element by element
//     and split on the fly; in PV the keys of an 8-key step are taken in
//     the order the S fragment holds them (2t, 2t+1 as k = t, t+4), so p
//     feeds the A operand without shuffles;
//   - causal: kv tiles past the block's last query row are skipped.  That
//     is exact: every key there is masked for every row, the first tile
//     always holds key 0 (so m is finite), hence p = exp(-1e30 - m) = 0
//     and the correction exp(m - m) = 1; it halves the work.  The mask is
//     applied only on tiles that hold a masked key;
//   - the q tiles run last-first, so the longest causal rows start first.
#include "common.cuh"

#include <cuda_bf16.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;       // keys a kv tile
constexpr int kNT = kBK / 8;  // 8-key n-tiles of S

// 16-row m-tiles a warp: two up to hd 64 (a 128-row block, FA2's shape
// there: each K and V fragment feeds two products), one above (registers)
template <int HD>
__host__ __device__ constexpr int m_tiles() {
  return HD <= 64 ? 2 : 1;
}
template <int HD>
__host__ __device__ constexpr int block_rows() {
  return 16 * kWarps * m_tiles<HD>();
}
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

struct Strides {  // element strides of batch, sequence and head; hd is dense
  long long b, s, h;
};

// shared-memory row stride in elements: HD plus 16 bytes
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 16 / (int)sizeof(T);
}

template <typename T, int HD>
constexpr size_t smem_bytes() {  // Q, then K[2], then V[2]
  return sizeof(T) * (size_t)(block_rows<HD>() + 4 * kBK) * row_stride<T, HD>();
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(fs::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(fs::smem_addr(p)));
}

// d += a * b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k8, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x ~ big + small, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// 3xTF32: d += a * b from the split operands, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- tile loads ----------------------------------------------------------------

// Stage a (rows x hd) tile at `src` (row stride `ld_src` elements) into
// shared memory as (rows x HD, row stride LD), zero past `valid` rows and
// past hd columns.  kVec: 16-byte cp.async (the caller has checked that
// every row start is 16-byte aligned and hd % 8 == 0); else element-wise.
template <typename T, int HD, bool kVec>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long ld_src, int rows,
                                          int valid, int hd) {
  constexpr int LD = row_stride<T, HD>();
  if constexpr (kVec) {
    constexpr int CH = 16 / (int)sizeof(T);  // elements a chunk
    constexpr int CPR = HD / CH;             // chunks a row
    constexpr int RSTEP = kThreads / CPR;    // rows a pass of the block
    static_assert(kThreads % CPR == 0, "a thread keeps its column");
    const int c = (threadIdx.x % CPR) * CH;
    const bool col_in = c < hd;
    for (int r = threadIdx.x / CPR; r < rows; r += RSTEP) {
      const bool in = col_in && r < valid;
      fs::cp_async16(dst + r * LD + c, in ? src + r * ld_src + c : src,
                     in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      dst[r * LD + d] =
          (r < valid && d < hd) ? src[(long long)r * ld_src + d] : zero<T>();
    }
  }
}

// ---- the kernel ------------------------------------------------------------------

// min blocks 1: without it ptxas spills the fp32 hd-128 instance
template <typename T, int HD, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
             int Skv, int hd, Strides sq, Strides sk, Strides sv, int causal,
             float scale) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int LD = row_stride<T, HD>();
  constexpr int MT = m_tiles<HD>();
  constexpr int BQ = block_rows<HD>();
  constexpr int NO = HD / 8;  // 8-column n-tiles of the output
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + BQ * LD;       // [2][kBK][LD]
  T* Vs = Ks + 2 * kBK * LD;  // [2][kBK][LD]

  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in it
  const int wrow = 16 * MT * warp;        // the warp's first row in the tile
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  int nk = (Skv + kBK - 1) / kBK;
  if (causal) nk = min(nk, (min(q0 + BQ, Sq) - 1) / kBK + 1);

  load_tile<T, HD, kVec>(Qs, q + b * sq.b + h * sq.h + (long long)q0 * sq.s,
                         sq.s, BQ, Sq - q0, hd);
  if (nk > 0) {
    load_tile<T, HD, kVec>(Ks, kb, sk.s, kBK, Skv, hd);
    load_tile<T, HD, kVec>(Vs, vb, sv.s, kBK, Skv, hd);
  }
  fs::cp_async_commit();

  // m-tile mt, rows g and g + 8 (r = 0, 1): running max, partial sum (this
  // lane's columns; reduced across the row's 4 lanes at the end), output
  float m[MT][2], l[MT][2], o[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = kNegInf;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  }
  uint32_t qf[kBf16 ? MT : 1][kBf16 ? HD / 16 : 1][4];  // bf16: Q fragments

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    const T* Kt = Ks + (kt & 1) * kBK * LD;
    const T* Vt = Vs + (kt & 1) * kBK * LD;
    if (kt + 1 < nk) {  // prefetch the next tile into the other buffer
      const int k1 = k0 + kBK;
      load_tile<T, HD, kVec>(Ks + ((kt + 1) & 1) * kBK * LD,
                             kb + (long long)k1 * sk.s, sk.s, kBK, Skv - k1,
                             hd);
      load_tile<T, HD, kVec>(Vs + ((kt + 1) & 1) * kBK * LD,
                             vb + (long long)k1 * sv.s, sv.s, kBK, Skv - k1,
                             hd);
      fs::cp_async_commit();
      fs::cp_async_wait<1>();  // all but the newest group: Q and tile kt
    } else {
      fs::cp_async_wait<0>();
    }
    __syncthreads();

    // ---- S = Q K^T (16 x 64 an m-tile, fp32 fragments) ----
    float s[MT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
    if constexpr (kBf16) {
      if (kt == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            ldsm_x4(qf[mt][kk], Qs + (wrow + 16 * mt + (lane & 15)) * LD +
                                    16 * kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          // n-tiles j, j+1 (keys) x k halves: b0b1, b2b3 of each
          uint32_t kf[4];
          const int i = lane >> 3;
          ldsm_x4(kf, Kt + (8 * (j + (i >> 1)) + (lane & 7)) * LD + 16 * kk +
                          (i & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], qf[mt][kk], kf[0], kf[1]);
            mma_bf16(s[mt][j + 1], qf[mt][kk], kf[2], kf[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const T* qr = Qs + (wrow + 16 * mt + g) * LD + 8 * kk + t;
          split_tf32(qr[0], ab[mt][0], as[mt][0]);
          split_tf32(qr[8 * LD], ab[mt][1], as[mt][1]);
          split_tf32(qr[4], ab[mt][2], as[mt][2]);
          split_tf32(qr[8 * LD + 4], ab[mt][3], as[mt][3]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const T* kr = Kt + (8 * j + g) * LD + 8 * kk + t;
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(kr[0], bb0, bs0);
          split_tf32(kr[4], bb1, bs1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(s[mt][j], ab[mt], as[mt], bb0, bb1, bs0, bs1);
        }
      }
    }

    // ---- online softmax on the fragments ----
    // s[mt][j][e]: row 16 mt + g (e < 2) or + 8, key k0 + 8j + 2t + (e & 1)
    const bool masked = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int qr0 = q0 + wrow + 16 * mt + g;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e];
          if (masked) {
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            const int qp = qr0 + 8 * (e >> 1);
            if (kp >= Skv || (causal && kp > qp)) x = kNegInf;
          }
          s[mt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(fs::kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(fs::kFullMask, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r]);
        corr[r] = ex2((m[mt][r] - m_new) * sl2);
        m[mt][r] = m_new;
        ms[r] = m_new * sl2;
        l[mt][r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][j][e], sl2, -ms[e >> 1]));
          l[mt][e >> 1] += p;
          s[mt][j][e] = p;
        }
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][j][e] *= corr[e >> 1];
    }

    // ---- O += P V ----
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // keys 16kk.. are S n-tiles 2kk, 2kk+1; p rounded to bf16
        uint32_t pf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pf[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pf[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pf[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pf[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t vf[4];
          const int i = lane >> 3;
          ldsm_x4_trans(vf, Vt + (16 * kk + (i & 1) * 8 + (lane & 7)) * LD +
                                8 * (j + (i >> 1)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][j], pf[mt], vf[0], vf[1]);
            mma_bf16(o[mt][j + 1], pf[mt], vf[2], vf[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        // keys 8kk + 2t and 8kk + 2t + 1 serve as k = t and k = t + 4
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_tf32(s[mt][kk][0], ab[mt][0], as[mt][0]);
          split_tf32(s[mt][kk][2], ab[mt][1], as[mt][1]);
          split_tf32(s[mt][kk][1], ab[mt][2], as[mt][2]);
          split_tf32(s[mt][kk][3], ab[mt][3], as[mt][3]);
        }
        const T* vr = Vt + (8 * kk + 2 * t) * LD + g;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(vr[8 * j], bb0, bs0);
          split_tf32(vr[LD + 8 * j], bb1, bs1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(o[mt][j], ab[mt], as[mt], bb0, bb1, bs0, bs1);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  fs::cp_async_wait<0>();  // nk == 0: the Q group

  // ---- out (dense B, Sq, H, hd) = o / max(l, 1e-30) ----
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float den = l[mt][r];
      den += __shfl_xor_sync(fs::kFullMask, den, 1);
      den += __shfl_xor_sync(fs::kFullMask, den, 2);
      den = fmaxf(den, 1e-30f);
      const int qp = q0 + wrow + 16 * mt + g + 8 * r;
      if (qp >= Sq) continue;
      T* row = out + (((long long)b * Sq + qp) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          if (col < hd) row[col] = from_f32<T>(o[mt][j][2 * r + e] / den);
        }
    }
}

template <typename T, int HD, bool kVec>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Sq, int Skv, int hd, Strides sq, Strides sk, Strides sv,
           int causal, float scale, cudaStream_t s) {
  const size_t bytes = smem_bytes<T, HD>();
  cudaFuncSetAttribute(flash_kernel<T, HD, kVec>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  constexpr int BQ = block_rows<HD>();
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_kernel<T, HD, kVec><<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Sq, Skv, hd, sq, sk,
      sv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Sq, int Skv, int hd, Strides sq, Strides sk,
             Strides sv, int causal, float scale, cudaStream_t s) {
  // 16-byte cp.async needs every row start 16-byte aligned
  const long long es = sizeof(T);
  bool vec = hd % 8 == 0;
  for (const void* p : {q, k, v}) vec = vec && (uintptr_t)p % 16 == 0;
  for (const Strides* st : {&sq, &sk, &sv})
    vec = vec && (st->b * es) % 16 == 0 && (st->s * es) % 16 == 0 &&
          (st->h * es) % 16 == 0;
#define FS_FLASH_LAUNCH(HD_, VEC_)                                          \
  return launch<T, HD_, VEC_>(q, k, v, out, B, H, Sq, Skv, hd, sq, sk, sv, \
                              causal, scale, s)
  if (hd <= 64) {
    if (vec) FS_FLASH_LAUNCH(64, true);
    FS_FLASH_LAUNCH(64, false);
  }
  if (vec) FS_FLASH_LAUNCH(128, true);
  FS_FLASH_LAUNCH(128, false);
#undef FS_FLASH_LAUNCH
}

}  // namespace

// out (dense B, Sq, H, hd) = softmax(q k^T * scale, masked) v for q of
// (B, Sq, H, hd) and k, v of (B, Skv, H, hd), each with element strides
// (batch, seq, head) and a dense last dim.  dtype 0 = float32, 1 = bf16.
FS_EXPORT int fs_flash_attention(const void* q, const void* k, const void* v,
                                 void* out, int B, int H, int Sq, int Skv,
                                 int hd, long long qsb, long long qss,
                                 long long qsh, long long ksb, long long kss,
                                 long long ksh, long long vsb, long long vss,
                                 long long vsh, int causal, float scale,
                                 int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv < 0 || hd <= 0 || hd > 128 ||
      (Sq + 63) / 64 > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, H, Sq, Skv, hd, sq, sk, sv,
                           causal, scale, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, out, B, H, Sq, Skv, hd, sq, sk, sv, causal,
                          scale, s);
  return (int)cudaErrorInvalidValue;
}
