// K5: blockwise (flash) attention with an online softmax in fp32.
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
// Bound on the H100: operations.  At the prefill shape (B 2, S 2048, H 32,
// hd 64, causal) the QK^T and PV products are 4*B*H*hd flops per causal
// (q, k) pair, 34.4 GFLOP, against 67 TFLOP/s of fp32 FMA outside the
// tensor cores (0.51 ms), while q, k, v and out are 4 x 33.5 MB (0.04 ms
// at 3.35 TB/s).  In bf16 the bound is still the fp32 pipes this kernel
// uses: it does not use the tensor cores (wgmma / mma.sync are later work).
//
// Design, against that bound:
//   - one block of 256 threads per (b*H + h, 64-row q tile); a loop over
//     64-key tiles staged in shared memory takes the place of the TPU's
//     sequential grid axis, and each thread keeps its 4 rows' m, l and
//     acc in registers;
//   - q, k, v are read in their (B, S, H, hd) layout through strides and
//     converted to fp32 on load (bf16 by the intrinsic): no transposes or
//     pads in device memory; ragged tiles are zero-filled in shared memory
//     and masked;
//   - register tiles of 4 rows x 4 keys (QK^T) and 4 rows x 4 columns per
//     64-column group (PV) with float4 shared-memory reads, so each
//     shared-memory wavefront feeds several FMAs;
//   - causal: kv tiles past the block's last query row are skipped.  That
//     is exact: every key there is masked for every row, the first tile
//     always holds key 0 (so m is finite), hence p = exp(-1e30 - m) = 0
//     and the correction exp(m - m) = 1; it halves the work;
//   - the q tiles run last-first, so the longest causal rows start first.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows a block
constexpr int kBK = 64;  // keys a kv tile
constexpr int kLDP = kBK + 4;
constexpr float kNegInf = -1e30f;

struct Strides {  // element strides of batch, sequence and head; hd is dense
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the reference's P.V product sees it: cast to v's dtype
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

__device__ __forceinline__ float reduce16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(fs::kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(fs::kFullMask, x, off);
  return x;
}

__device__ __forceinline__ float f4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (HD + 4) + kBQ * kLDP);
}

// Copy a (rows x hd) tile at `src` (row stride `ld_src`) into shared
// memory as fp32 (rows x HD, row stride LD), zero past `valid` rows and
// past hd columns.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld_src, int rows,
                                          int valid, int hd) {
  constexpr int LD = HD + 4;
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    dst[r * LD + d] =
        (r < valid && d < hd) ? to_f32(src[(long long)r * ld_src + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
             int Skv, int hd, Strides sq, Strides sk, Strides sv, int causal,
             float scale) {
  constexpr int LD = HD + 4;  // float4-aligned rows, 4 banks apart
  constexpr int NG = HD / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tx = threadIdx.x & 15;  // keys tx + 16j; columns 64g + 4tx + e
  const int ty = threadIdx.x >> 4;  // rows 4ty + i
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile<T, HD>(Qs, q + b * sq.b + h * sq.h + (long long)q0 * sq.s, sq.s,
                   kBQ, Sq - q0, hd);

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  int nk = (Skv + kBK - 1) / kBK;
  if (causal) nk = min(nk, (min(q0 + kBQ, Sq) - 1) / kBK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, HD>(Ks, kb + (long long)k0 * sk.s, sk.s, kBK, Skv - k0, hd);
    load_tile<T, HD>(Vs, vb + (long long)k0 * sv.s, sv.s, kBK, Skv - k0, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * ty + i;
      const int q_pos = q0 + row;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (k_pos >= Skv || (causal && k_pos > q_pos)) x = kNegInf;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], reduce16_max(rmax));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[row * kLDP + tx + 16 * j] = round_p<T>(p);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + reduce16_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(4 * ty + i) * kLDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(kk + u) * LD + 64 * g + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = f4(pa[i], u);
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

  // out is a dense (B, Sq, H, hd) tensor
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + 4 * ty + i;
    if (q_pos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = out + (((long long)b * Sq + q_pos) * H + h) * hd;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * g + 4 * tx + e;
        if (col < hd) row[col] = from_f32<T>(acc[i][g][e] / den);
      }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Sq, int Skv, int hd, Strides sq, Strides sk, Strides sv,
           int causal, float scale, cudaStream_t s) {
  const size_t bytes = smem_bytes<HD>();
  cudaFuncSetAttribute(flash_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, HD><<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Sq, Skv, hd, sq, sk,
      sv, causal, scale);
  return (int)cudaGetLastError();
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
  if (B <= 0 || H <= 0 || Sq <= 0 || hd <= 0 || hd > 128 ||
      (Sq + kBQ - 1) / kBQ > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  if (dtype == 0)
    return hd <= 64 ? launch<float, 64>(q, k, v, out, B, H, Sq, Skv, hd, sq,
                                        sk, sv, causal, scale, s)
                    : launch<float, 128>(q, k, v, out, B, H, Sq, Skv, hd, sq,
                                         sk, sv, causal, scale, s);
  if (dtype == 1)
    return hd <= 64
               ? launch<__nv_bfloat16, 64>(q, k, v, out, B, H, Sq, Skv, hd,
                                           sq, sk, sv, causal, scale, s)
               : launch<__nv_bfloat16, 128>(q, k, v, out, B, H, Sq, Skv, hd,
                                            sq, sk, sv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
