// Flash-style attention with the Transformer-XL relative-position bias
// computed in the kernel: the forward, with the per-row log-sum-exp that
// the backward (relpos_attention_bwd.cu) reads.
//
// Replaces: the Pallas TPU kernel
//   speechbrain_tpu/ops/pallas/relpos_attention.py _fwd_kernel / _fwd,
//   reached through relpos_attention.
//
//   s[q,k] = ((q + u) . k_k + (q + vb) . p[clip(T-1-q+k)]) * scale + madd[k]
//   s[q,k] = -1e9 where causal and k > q
//   out[q] = softmax_k(s[q, :]) @ v,  lse[q] = log sum_k exp(s[q, k])  (f32)
//
// with q, k, v (B, H, Tp, dh), p (H, 2T-1, dh) and madd (B, Tp).
//
// ---- attention dropout (rate > 0) ----
//
// As in the TPU kernels, dropout acts on the normalized weights and
// leaves the normalizer and the lse as they are:
//   out[q] = sum_k softmax_k(s[q, :]) keep[q,k] / (1 - rate) v_k.
// keep is the pure function of (seed, b, h, q, k) in relpos_dropout.cuh;
// the TPU's hardware generator has no counterpart here, so its bits are
// not reproduced; its threshold rule and gradient formulas are.  A thread
// generates its row's 64 bits of each key tile (16 Philox calls).  The
// case rate = 0 is a separate instantiation (DROP = false) that runs no
// generator code.
//
// ---- what bounds it, and the design ----
//
// What bounds it on the H100: at the long-utterance shape that routes
// here (B=2..8, H=4, T=512..1024, dh=36) the least traffic is q, k, v, p
// and out once each, a few MB, against 2 x B x H x T^2 x 3 dh FLOPs in
// f32 outside the tensor cores (67 TFLOP/s): operations bound.
//
// What the simple design does about it: one block per (b, h, 64-query
// tile), one thread per query row, with q+u, q+vb and the output
// accumulator in registers.  The block walks 64-key tiles, staging K, V
// and the band of P rows the tile needs (64 + 64 - 1 rows: for query i
// and key j of the tile the row is band[63 - i + j]) in shared memory,
// and keeps an online softmax (running max and sum) in f32.  No (T, T)
// or (T, 2T-1) tensor is formed.  Shared rows are read as float4 with a
// row stride of dh or dh + 4 floats, whichever makes it an odd number of
// 16-byte words, so the eight threads of a float4 load phase hit eight
// different bank groups.  The TPU kernel's log-roll shear is a TPU
// device and has no counterpart here.  No tensor cores: that is for the
// PR that makes this fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "relpos_dropout.cuh"

namespace {

using relpos::Drop;
using relpos::keep_bits;

constexpr int BQ = 64;  // queries per block, one per thread
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int BAND = BQ + BK - 1;  // rows of P (or K) one tile pair needs
constexpr float NEG = -1e9f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int DH>
struct Stride {
  // floats per shared row: an odd number of float4 words
  static constexpr int value = ((DH / 4) % 2 == 1) ? DH : DH + 4;
};

template <int DH>
__device__ __forceinline__ float dot_row(const float (&a)[DH],
                                         const float* __restrict__ row) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    const float4 c = r[d4];
    acc += a[4 * d4] * c.x + a[4 * d4 + 1] * c.y + a[4 * d4 + 2] * c.z +
           a[4 * d4 + 3] * c.w;
  }
  return acc;
}

template <int DH>
__device__ __forceinline__ void axpy_row(float (&acc)[DH], float a,
                                         const float* __restrict__ row) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    const float4 c = r[d4];
    acc[4 * d4] += a * c.x;
    acc[4 * d4 + 1] += a * c.y;
    acc[4 * d4 + 2] += a * c.z;
    acc[4 * d4 + 3] += a * c.w;
  }
}

// Stage rows [r0, r0 + n) of a (rows, DH) tensor into shared rows of
// stride S; rows outside [0, limit) read zero.  `add` (DH floats or null)
// is added to every element.
template <typename E, int DH>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const E* __restrict__ src, int r0,
                                      int n, int limit,
                                      const float* __restrict__ add) {
  constexpr int S = Stride<DH>::value;
  for (int e = threadIdx.x; e < n * DH; e += blockDim.x) {
    const int r = e / DH, d = e % DH;
    const int row = r0 + r;
    float v = 0.f;
    if (row >= 0 && row < limit) {
      v = to_f32(src[(int64_t)row * DH + d]);
      if (add != nullptr) v += add[d];
    }
    dst[r * S + d] = v;
  }
}

// Stage the band of P rows p[clip(band0 + r)], r in [0, BAND).
template <typename E, int DH>
__device__ __forceinline__ void stage_band(float* __restrict__ dst,
                                           const E* __restrict__ ph,
                                           int band0, int T) {
  constexpr int S = Stride<DH>::value;
  for (int e = threadIdx.x; e < BAND * DH; e += blockDim.x) {
    const int r = e / DH, d = e % DH;
    const int lp = min(max(band0 + r, 0), 2 * T - 2);
    dst[r * S + d] = to_f32(ph[(int64_t)lp * DH + d]);
  }
}

// ------------------------------------------------------------- forward

template <int DH>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(2 * BK + BAND) * Stride<DH>::value * sizeof(float) +
         BK * sizeof(float);
}

template <typename E, int DH, bool DROP>
__global__ void __launch_bounds__(BQ)
    relpos_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ p,
                      const float* __restrict__ u,
                      const float* __restrict__ vb,
                      const float* __restrict__ madd, float* __restrict__ out,
                      float* __restrict__ lse, int H, int Tp, int T,
                      float scale, int causal, Drop dr) {
  constexpr int S = Stride<DH>::value;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // (BK, S)
  float* Vs = Ks + BK * S;        // (BK, S)
  float* Ps = Vs + BK * S;        // (BAND, S)
  float* Ms = Ps + BAND * S;      // (BK,)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int i = threadIdx.x;
  const int qrow = q0 + i;
  const int64_t head = ((int64_t)b * H + h) * Tp * DH;
  const E* qh = q + head;
  const E* ph = p + (int64_t)h * (2 * T - 1) * DH;

  float qu[DH], qv[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float x = to_f32(qh[(int64_t)qrow * DH + d]);
    qu[d] = x + u[h * DH + d];
    qv[d] = x + vb[h * DH + d];
    o[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < Tp; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    stage<E, DH>(Ks, k + head, k0, BK, Tp, nullptr);
    stage<E, DH>(Vs, v + head, k0, BK, Tp, nullptr);
    // band row r holds p[clip(T-1 - (q0+BQ-1) + k0 + r)]
    stage_band<E, DH>(Ps, ph, T - 1 - (q0 + BQ - 1) + k0, T);
    for (int e = i; e < BK; e += BQ) Ms[e] = madd[(int64_t)b * Tp + k0 + e];
    uint64_t keep = 0;
    if (DROP) keep = keep_bits(dr, b * H + h, qrow, k0);
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      const float su = dot_row<DH>(qu, Ks + j * S);
      const float sv = dot_row<DH>(qv, Ps + (BQ - 1 - i + j) * S);
      float s = (su + sv) * scale + Ms[j];
      if (causal && k0 + j > qrow) s = NEG;
      if (s > m) {  // rescale the running sums to the new maximum
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int d = 0; d < DH; ++d) o[d] *= corr;
        m = s;
      }
      const float pj = expf(s - m);
      l += pj;  // the normalizer is taken before dropout
      float w = pj;
      if (DROP) w = ((keep >> j) & 1) ? pj * dr.inv : 0.f;
      axpy_row<DH>(o, w, Vs + j * S);
    }
  }
  const float inv = 1.f / l;
  float* oh = out + head + (int64_t)qrow * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) oh[d] = o[d] * inv;
  lse[((int64_t)b * H + h) * Tp + qrow] = m + logf(l);
}

// ------------------------------------------------------------ launchers

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *p;
  const float *u, *vb, *madd;
  int B, H, Tp, T;
  float scale;
  int causal;
  int drop;  // 0: rate = 0, the DROP = false kernels
  Drop dr;
  cudaStream_t s;
};

template <typename E, int DH, bool DROP>
int launch_fwd(const Args& a, float* out, float* lse) {
  const size_t smem = fwd_smem_bytes<DH>();
  auto kern = relpos_fwd_kernel<E, DH, DROP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.Tp / BQ, a.H, a.B);
  kern<<<grid, BQ, smem, a.s>>>((const E*)a.q, (const E*)a.k, (const E*)a.v,
                                (const E*)a.p, a.u, a.vb, a.madd, out, lse,
                                a.H, a.Tp, a.T, a.scale, a.causal, a.dr);
  return (int)cudaGetLastError();
}

// Returns CALL with the compile-time head width DH set to the runtime dh
// and DROP to whether the call has dropout.
#define SB_DISPATCH_DH_1(dh, CALL)                   \
  switch (dh) {                                      \
    case 16: { constexpr int DH = 16; return CALL; } \
    case 32: { constexpr int DH = 32; return CALL; } \
    case 36: { constexpr int DH = 36; return CALL; } \
    case 64: { constexpr int DH = 64; return CALL; } \
    default: return (int)cudaErrorInvalidValue;      \
  }
#define SB_DISPATCH_DH(drop, dh, CALL)                              \
  if (drop) {                                                       \
    constexpr bool DROP = true;                                     \
    SB_DISPATCH_DH_1(dh, CALL)                                      \
  } else {                                                          \
    constexpr bool DROP = false;                                    \
    SB_DISPATCH_DH_1(dh, CALL)                                      \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, p).  u, vb, madd, out and
// lse (B, H, Tp) are float32.  Tp must be a multiple of 64 and dh one of
// 16, 32, 36, 64.  drop = 0 is rate 0 (thresh, inv and the key unread);
// else thresh = min(2^32 - 1, floor(rate 2^32)), inv = 1 / (1 - rate) and
// (key0, key1) = (seed & 0xffffffff, seed >> 32).  Returns
// cudaGetLastError() after the launch.
extern "C" int sb_relpos_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* p,
                                       const void* u, const void* vb,
                                       const void* madd, void* out,
                                       void* lse, int B, int H, int Tp, int T,
                                       int dh, float scale, int causal,
                                       int drop, unsigned thresh, float inv,
                                       unsigned key0, unsigned key1,
                                       int dtype, void* stream) {
  if (B == 0 || H == 0 || Tp == 0) return 0;
  if (Tp % BQ != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, p, (const float*)u, (const float*)vb,
               (const float*)madd, B, H, Tp, T, scale, causal, drop,
               Drop{thresh, key0, key1, inv}, (cudaStream_t)stream};
  if (dtype == 0) {
    SB_DISPATCH_DH(drop, dh, (launch_fwd<float, DH, DROP>(a, (float*)out,
                                                          (float*)lse)))
  }
  if (dtype == 1) {
    SB_DISPATCH_DH(drop, dh,
                   (launch_fwd<__nv_bfloat16, DH, DROP>(a, (float*)out,
                                                        (float*)lse)))
  }
  return (int)cudaErrorInvalidValue;
}
