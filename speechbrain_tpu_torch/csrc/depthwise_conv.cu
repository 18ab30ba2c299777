// Depthwise 1-d convolution, forward, for the conformer convolution module.
//
// Replaces: the Pallas TPU kernel speechbrain_tpu/ops/pallas/depthwise_conv.py
//   (_fwd_kernel / _pallas_forward, reached through depthwise_conv1d).
//
//   out[b,t,c] = sum_k w[k,c] * x[b, t+k-pad_left, c]  (+ bias[c])
//
// with pad_left = (K-1)//2 (centered) or K-1 (causal); taps that fall
// outside [0, T) read zero.
//
// What bounds it on the H100: bytes.  Each output reads K inputs of its
// own channel, but neighbouring outputs share them, so the least traffic
// is x read once and out written once: at the conformer_small shape
// (B=8, T=251, C=144, K=31, f32) 2.3 MB against 18 MFLOP, far below the
// ~20 FLOP/byte where f32 FMA throughput would take over.
//
// What the simple design does about it: one thread per output element,
// channel fastest, so every tap's loads across a warp are consecutive
// addresses (coalesced) and the K overlapping reads of a value hit L1/L2
// instead of device memory.  x is read unpadded (no padded copy is made),
// the accumulator is f32 whatever the storage type, and the bias is
// fused into the single store.  The TPU kernel's lane packing of the
// 144 % 128 remainder channels and its VMEM size guard are TPU devices
// and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void depthwise_conv1d_fwd(const T* __restrict__ x,
                                     const T* __restrict__ w,
                                     const T* __restrict__ bias,
                                     T* __restrict__ out, int B, int T_len,
                                     int C, int K, int pad_left) {
  const int64_t total = (int64_t)B * T_len * C;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const int64_t bt = idx / C;
  const int t = (int)(bt % T_len);
  const int64_t b = bt / T_len;
  const T* xb = x + b * (int64_t)T_len * C;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int ti = t + k - pad_left;
    if (ti >= 0 && ti < T_len) {
      acc += to_f32(xb[(int64_t)ti * C + c]) * to_f32(w[k * C + c]);
    }
  }
  if (bias != nullptr) acc += to_f32(bias[c]);
  out[idx] = from_f32<T>(acc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and out share it).
// bias may be null.  Returns cudaGetLastError() after the launch.
extern "C" int sb_depthwise_conv1d_fwd(const void* x, const void* w,
                                       const void* bias, void* out, int B,
                                       int T, int C, int K, int pad_left,
                                       int dtype, void* stream) {
  const int threads = 256;
  const int64_t total = (int64_t)B * T * C;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (total == 0) return 0;
  if (dtype == 0) {
    depthwise_conv1d_fwd<float><<<blocks, threads, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)bias, (float*)out,
        B, T, C, K, pad_left);
  } else if (dtype == 1) {
    depthwise_conv1d_fwd<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, B, T, C, K,
        pad_left);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
