// Flash-style attention with the Transformer-XL relative-position bias
// computed in the kernel (forward only).
//
// Replaces: the Pallas TPU kernel
//   speechbrain_tpu/ops/pallas/relpos_attention.py (_fwd_kernel / _fwd,
//   reached through relpos_attention).
//
//   s[q,k] = ((q + u) . k_k + (q + vb) . p[clip(T-1-q+k)]) * scale + madd[k]
//   s[q,k] = -1e9 where causal and k > q
//   out[q] = softmax_k(s[q, :]) @ v          (f32)
//
// with q, k, v (B, H, Tp, dh), p (H, 2T-1, dh) and madd (B, Tp).
//
// What bounds it on the H100: at the long-utterance shape that routes
// here (B=2, H=4, T=512..1024, dh=36) the least traffic is q, k, v, p and
// out once each, ~2-4 MB, against 2 x B x H x T^2 x 3 dh FLOPs, ~0.9-3.6
// GFLOP in f32 outside the tensor cores (67 TFLOP/s): operations bound,
// tens of microseconds.
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

namespace {

constexpr int BQ = 64;  // queries per block, one per thread
constexpr int BK = 64;  // keys per shared-memory tile
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
constexpr size_t smem_bytes() {
  return (size_t)(2 * BK + (BQ + BK - 1)) * Stride<DH>::value * sizeof(float) +
         BK * sizeof(float);
}

template <typename E, int DH>
__global__ void __launch_bounds__(BQ)
    relpos_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ p,
                      const float* __restrict__ u,
                      const float* __restrict__ vb,
                      const float* __restrict__ madd, float* __restrict__ out,
                      int H, int Tp, int T, float scale, int causal) {
  constexpr int S = Stride<DH>::value;
  constexpr int D4 = DH / 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // (BK, S)
  float* Vs = Ks + BK * S;               // (BK, S)
  float* Ps = Vs + BK * S;               // (BQ + BK - 1, S)
  float* Ms = Ps + (BQ + BK - 1) * S;    // (BK,)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int i = threadIdx.x;
  const int qrow = q0 + i;
  const int64_t head = ((int64_t)b * H + h) * Tp * DH;
  const E* qh = q + head;
  const E* kh = k + head;
  const E* vh = v + head;
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
    for (int e = i; e < BK * DH; e += BQ) {
      const int r = e / DH, d = e % DH;
      Ks[r * S + d] = to_f32(kh[(int64_t)(k0 + r) * DH + d]);
      Vs[r * S + d] = to_f32(vh[(int64_t)(k0 + r) * DH + d]);
    }
    // band row r holds p[clip(T-1 - (q0+BQ-1) + k0 + r)]
    const int band0 = T - 1 - (q0 + BQ - 1) + k0;
    for (int e = i; e < (BQ + BK - 1) * DH; e += BQ) {
      const int r = e / DH, d = e % DH;
      const int lp = min(max(band0 + r, 0), 2 * T - 2);
      Ps[r * S + d] = to_f32(ph[(int64_t)lp * DH + d]);
    }
    for (int e = i; e < BK; e += BQ) Ms[e] = madd[(int64_t)b * Tp + k0 + e];
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * S);
      const float4* pr =
          reinterpret_cast<const float4*>(Ps + (BQ - 1 - i + j) * S);
      float su = 0.f, sv = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 a = kr[d4];
        su += qu[4 * d4] * a.x + qu[4 * d4 + 1] * a.y +
              qu[4 * d4 + 2] * a.z + qu[4 * d4 + 3] * a.w;
        const float4 c = pr[d4];
        sv += qv[4 * d4] * c.x + qv[4 * d4 + 1] * c.y +
              qv[4 * d4 + 2] * c.z + qv[4 * d4 + 3] * c.w;
      }
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
      l += pj;
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * S);
#pragma unroll
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 c = vr[d4];
        o[4 * d4] += pj * c.x;
        o[4 * d4 + 1] += pj * c.y;
        o[4 * d4 + 2] += pj * c.z;
        o[4 * d4 + 3] += pj * c.w;
      }
    }
  }
  const float inv = 1.f / l;
  float* oh = out + head + (int64_t)qrow * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) oh[d] = o[d] * inv;
}

template <typename E, int DH>
int launch(const void* q, const void* k, const void* v, const void* p,
           const float* u, const float* vb, const float* madd, float* out,
           int B, int H, int Tp, int T, float scale, int causal,
           cudaStream_t s) {
  const size_t smem = smem_bytes<DH>();
  auto kern = relpos_fwd_kernel<E, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tp / BQ, H, B);
  kern<<<grid, BQ, smem, s>>>((const E*)q, (const E*)k, (const E*)v,
                              (const E*)p, u, vb, madd, out, H, Tp, T, scale,
                              causal);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const void* q, const void* k, const void* v, const void* p,
             const float* u, const float* vb, const float* madd, float* out,
             int B, int H, int Tp, int T, int dh, float scale, int causal,
             cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<E, 16>(q, k, v, p, u, vb, madd, out, B, H, Tp, T, scale,
                           causal, s);
    case 32:
      return launch<E, 32>(q, k, v, p, u, vb, madd, out, B, H, Tp, T, scale,
                           causal, s);
    case 36:
      return launch<E, 36>(q, k, v, p, u, vb, madd, out, B, H, Tp, T, scale,
                           causal, s);
    case 64:
      return launch<E, 64>(q, k, v, p, u, vb, madd, out, B, H, Tp, T, scale,
                           causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, p).  u, vb, madd and out are
// float32.  Tp must be a multiple of 64 and dh one of 16, 32, 36, 64.
// Returns cudaGetLastError() after the launch.
extern "C" int sb_relpos_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* p,
                                       const void* u, const void* vb,
                                       const void* madd, void* out, int B,
                                       int H, int Tp, int T, int dh,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || H == 0 || Tp == 0) return 0;
  if (Tp % BQ != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return dispatch<float>(q, k, v, p, (const float*)u, (const float*)vb,
                           (const float*)madd, (float*)out, B, H, Tp, T, dh,
                           scale, causal, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, p, (const float*)u,
                                   (const float*)vb, (const float*)madd,
                                   (float*)out, B, H, Tp, T, dh, scale,
                                   causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
