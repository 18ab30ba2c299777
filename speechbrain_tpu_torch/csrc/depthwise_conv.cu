// Depthwise 1-d convolution for the conformer convolution module: the
// forward (which is also the input gradient) and the taps' gradient.
//
// Replaces: the Pallas TPU kernels speechbrain_tpu/ops/pallas/depthwise_conv.py
//   _fwd_kernel / _pallas_forward (forward, and the dx of the backward)
//   and _dw_kernel / _pallas_dw (the taps' gradient).
//
//   out[b,t,c] = sum_k w[k,c] * x[b, t+k-pad_left, c]  (+ bias[c])
//   dw[k,c]    = sum_{b,t} dy[b,t,c] * x[b, t+k-pad_left, c]
//
// with pad_left = (K-1)//2 (centered) or K-1 (causal); taps that fall
// outside [0, T) read zero.  The input gradient is the forward entry on
// the flipped taps with pad_left' = K-1-pad_left: the TPU kernel's padded
// copy of dy and the slice of its output are folded into that offset.
//
// ---- forward (sb_depthwise_conv1d_fwd) ----
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
//
// ---- taps' gradient (sb_depthwise_conv1d_dw) ----
//
// What bounds it on the H100: bytes.  K*C outputs, each a sum over B*T
// products; the least traffic is x and dy read once (training shape
// B=32, T=251, C=144, K=31, f32: 9.3 MB) against 2*K*B*T*C = 72 MFLOP.
//
// What the simple design does about it: the TPU kernel carries the sum
// across its sequential grid (init at b == 0); blocks on the card run in
// no order, so the sum becomes two passes.  Pass 1: one block per
// (32-channel tile, 64-row time chunk of one utterance) stages the chunk
// of dy and the chunk of x with its K-1 halo rows in shared memory
// (channels fastest: coalesced loads, conflict-free reads) and writes
// one partial dw (K, 32) per chunk, f32.  Pass 2: one thread per (k, c)
// adds the partials of every chunk in chunk order.  No atomics: the
// result is the same bits in every run.

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

constexpr int DW_TC = 64;  // time rows per chunk
constexpr int DW_CT = 32;  // channels per block (one warp wide)
constexpr int DW_KY = 8;   // block rows; each strides over the taps

template <typename T>
__global__ void __launch_bounds__(DW_CT * DW_KY)
    depthwise_conv1d_dw_partial(const T* __restrict__ x,
                                const T* __restrict__ dy,
                                float* __restrict__ partial, int T_len,
                                int C, int K, int pad_left) {
  extern __shared__ float smem[];
  float* xs = smem;                          // (DW_TC + K - 1, DW_CT)
  float* dys = smem + (DW_TC + K - 1) * DW_CT;  // (DW_TC, DW_CT)
  const int n_tchunks = (T_len + DW_TC - 1) / DW_TC;
  const int chunk = blockIdx.y;
  const int b = chunk / n_tchunks;
  const int t0 = (chunk % n_tchunks) * DW_TC;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * DW_CT + tx;
  const int64_t base = (int64_t)b * T_len * C;
  for (int r = ty; r < DW_TC + K - 1; r += DW_KY) {
    const int ti = t0 + r - pad_left;
    float v = 0.f;
    if (c < C && ti >= 0 && ti < T_len) v = to_f32(x[base + (int64_t)ti * C + c]);
    xs[r * DW_CT + tx] = v;
  }
  for (int r = ty; r < DW_TC; r += DW_KY) {
    const int t = t0 + r;
    float v = 0.f;
    if (c < C && t < T_len) v = to_f32(dy[base + (int64_t)t * C + c]);
    dys[r * DW_CT + tx] = v;
  }
  __syncthreads();
  if (c >= C) return;
  for (int k = ty; k < K; k += DW_KY) {
    float acc = 0.f;
    for (int r = 0; r < DW_TC; ++r) {
      acc += dys[r * DW_CT + tx] * xs[(r + k) * DW_CT + tx];
    }
    partial[((int64_t)chunk * K + k) * C + c] = acc;
  }
}

__global__ void depthwise_conv1d_dw_reduce(const float* __restrict__ partial,
                                           float* __restrict__ dw,
                                           int n_chunks, int KC) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= KC) return;
  float acc = 0.f;
  for (int i = 0; i < n_chunks; ++i) acc += partial[(int64_t)i * KC + idx];
  dw[idx] = acc;
}

template <typename T>
int launch_dw(const void* x, const void* dy, float* partial, float* dw,
              int B, int T_len, int C, int K, int pad_left, cudaStream_t s) {
  const int n_chunks = B * ((T_len + DW_TC - 1) / DW_TC);
  if (n_chunks > 0) {
    const size_t smem = (size_t)(2 * DW_TC + K - 1) * DW_CT * sizeof(float);
    auto kern = depthwise_conv1d_dw_partial<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((C + DW_CT - 1) / DW_CT, n_chunks);
    kern<<<grid, dim3(DW_CT, DW_KY), smem, s>>>(
        (const T*)x, (const T*)dy, partial, T_len, C, K, pad_left);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int KC = K * C;
  depthwise_conv1d_dw_reduce<<<(KC + 255) / 256, 256, 0, s>>>(partial, dw,
                                                               n_chunks, KC);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of time chunks of the taps' gradient: its scratch `partial`
// holds n_chunks * K * C floats.
extern "C" int sb_depthwise_conv1d_dw_chunks(int B, int T) {
  return B * ((T + DW_TC - 1) / DW_TC);
}

// dtype: 0 = float32, 1 = bfloat16 (x and dy); partial (scratch) and dw
// (K, C) are float32.  Returns cudaGetLastError() after the launches.
extern "C" int sb_depthwise_conv1d_dw(const void* x, const void* dy,
                                      void* partial, void* dw, int B, int T,
                                      int C, int K, int pad_left, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 0 || C == 0) return 0;
  if (dtype == 0) {
    return launch_dw<float>(x, dy, (float*)partial, (float*)dw, B, T, C, K,
                            pad_left, s);
  }
  if (dtype == 1) {
    return launch_dw<__nv_bfloat16>(x, dy, (float*)partial, (float*)dw, B, T,
                                    C, K, pad_left, s);
  }
  return (int)cudaErrorInvalidValue;
}

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
