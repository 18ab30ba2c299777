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
// ~20 FLOP/byte where f32 FMA throughput would take over.  At these
// sizes (0.7 us of traffic) the launch, the first loads' latency and the
// host's call dominate.
//
// The design: one block per (batch row, 32-step time tile, channel
// group) stages x's rows [t0 - pad_left, t0 + 32 + K - 1 - pad_left) of
// its channels in shared memory, with 16-byte loads where the rows'
// byte widths allow (C = 144: 36 float4 in f32, 18 in bf16) and scalar
// loads otherwise; taps outside [0, T) stage as zero.  Each thread owns
// two neighbouring channels (float2 or __nv_bfloat162 reads) and R = 8
// consecutive outputs: it holds its channels' K taps in registers (for
// the K the kernel is instantiated for; other K read the taps from
// L1) and slides over R + K - 1 shared rows, (R + K - 1) / R reads an
// output where one thread per output made 2K.  Each output sums its
// taps in order k = 0 .. K-1 in f32, then is rounded to x's dtype; a
// bias, rounded to that dtype, is added after and the sum rounded again
// (the JAX package's order; for f32 the roundings are exact).  Index
// arithmetic is 32-bit from block coordinates, with one 64-bit offset
// per batch row.  `flip` reads the taps as w[K-1-k], so the input
// gradient needs no flipped copy of w.  No atomics: the same bits in
// every run.  The TPU kernel's lane packing of the 144 % 128 remainder
// channels and its VMEM size guard are TPU devices and have no
// counterpart here.
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

// Two neighbouring channels of storage type T, and their f32 values.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ float2 f32(V v) { return v; }
  static __device__ __forceinline__ V from(float2 v) { return v; }
};
template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ float2 f32(V v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ V from(float2 v) {
    return __floats2bfloat162_rn(v.x, v.y);
  }
};

constexpr int FR = 8;          // outputs a thread, consecutive in time
constexpr int FTY = 4;         // thread rows a block
constexpr int FTT = FR * FTY;  // time steps a block
constexpr int FMAX_TX = 64;    // channel pairs (threads) across a block

// The f32 taps of channels (c, c + 1) at tap k (w[K-1-k] when flip).
template <typename T>
__device__ __forceinline__ float2 tap(const T* __restrict__ w, int k, int K,
                                      int C, int c, bool two, bool flip) {
  const T* row = w + (flip ? K - 1 - k : k) * C + c;
  return make_float2(to_f32(row[0]), two ? to_f32(row[1]) : 0.f);
}

// Out rows t0 + ty R .. + R - 1 of channels (c, c + 1): f32 sums rounded
// to T, then the bias (rounded to T) added and rounded again.
template <typename T>
__device__ __forceinline__ void store_outputs(
    const float2 (&acc)[FR], const T* __restrict__ bias, T* __restrict__ ob,
    int t, int T_len, int C, int c, bool two, bool pair_store) {
  float2 bv = make_float2(0.f, 0.f);
  if (bias != nullptr) {
    bv = make_float2(to_f32(bias[c]), two ? to_f32(bias[c + 1]) : 0.f);
  }
#pragma unroll
  for (int r = 0; r < FR; ++r) {
    if (t + r >= T_len) break;
    float2 v = Pair<T>::f32(Pair<T>::from(acc[r]));  // round to T
    if (bias != nullptr) v = make_float2(v.x + bv.x, v.y + bv.y);
    const typename Pair<T>::V o = Pair<T>::from(v);
    T* dst = ob + (t + r) * C + c;
    if (pair_store) {
      *reinterpret_cast<typename Pair<T>::V*>(dst) = o;
    } else {
      dst[0] = o.x;
      if (two) dst[1] = o.y;
    }
  }
}

// Grid (channel groups, time tiles, B), block (TX, FTY); shared rows of
// SW elements.  KC is the number of taps when known at compile time (the
// taps then live in registers), 0 for any K.
template <typename T, int KC>
__global__ void __launch_bounds__(FMAX_TX * FTY)
    depthwise_conv1d_fwd(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ out,
                         int T_len, int C, int K, int pad_left, int flip,
                         int cgw, int SW, int vec16) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* xs = reinterpret_cast<T*>(fwd_smem);  // (FTT + K - 1, SW)
  const int cg0 = blockIdx.x * cgw;
  const int gw = min(cgw, C - cg0);  // channels of this group
  const int t0 = blockIdx.y * FTT;
  const int64_t base = (int64_t)blockIdx.z * T_len * C;
  const T* xb = x + base + cg0;
  const int nrows = FTT + K - 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nth = blockDim.x * blockDim.y;
  const int tlo = t0 - pad_left;  // time of shared row 0
  if (vec16 && (gw * (int)sizeof(T)) % 16 == 0) {
    const int cpr = gw * (int)sizeof(T) / 16;  // 16-byte chunks a row
    for (int e = tid; e < nrows * cpr; e += nth) {
      const int r = e / cpr, j = e - r * cpr;
      const int ti = tlo + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ti >= 0 && ti < T_len) {
        v = reinterpret_cast<const uint4*>(xb + ti * C)[j];
      }
      reinterpret_cast<uint4*>(xs + r * SW)[j] = v;
    }
  } else {
    for (int e = tid; e < nrows * gw; e += nth) {
      const int r = e / gw, c = e - r * gw;
      const int ti = tlo + r;
      xs[r * SW + c] = (ti >= 0 && ti < T_len) ? xb[ti * C + c]
                                               : from_f32<T>(0.f);
    }
  }
  __syncthreads();
  const int c = 2 * threadIdx.x;  // the thread's channels c, c + 1
  if (c >= gw) return;
  const bool two = c + 1 < gw;
  const bool fl = flip != 0;
  const T* wc = w + cg0;
  const T* xr = xs + threadIdx.y * FR * SW + c;
  float2 acc[FR];
#pragma unroll
  for (int r = 0; r < FR; ++r) acc[r] = make_float2(0.f, 0.f);
  if constexpr (KC > 0) {
    float2 wr[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) wr[k] = tap(wc, k, KC, C, c, two, fl);
    // shared row j feeds output r through tap j - r: each output's taps
    // are added in order k = 0 .. KC-1
#pragma unroll
    for (int j = 0; j < FR + KC - 1; ++j) {
      const float2 xv =
          Pair<T>::f32(*reinterpret_cast<const typename Pair<T>::V*>(
              xr + j * SW));
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        const int k = j - r;
        if (k >= 0 && k < KC) {
          acc[r].x = fmaf(wr[k].x, xv.x, acc[r].x);
          acc[r].y = fmaf(wr[k].y, xv.y, acc[r].y);
        }
      }
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const float2 wk = tap(wc, k, K, C, c, two, fl);
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        const float2 xv =
            Pair<T>::f32(*reinterpret_cast<const typename Pair<T>::V*>(
                xr + (r + k) * SW));
        acc[r].x = fmaf(wk.x, xv.x, acc[r].x);
        acc[r].y = fmaf(wk.y, xv.y, acc[r].y);
      }
    }
  }
  store_outputs<T>(acc, bias == nullptr ? nullptr : bias + cg0,
                   out + base + cg0, t0 + threadIdx.y * FR, T_len, C, c, two,
                   two && C % 2 == 0);
}

// The forward's launch shape for (T, C, K) in storage type T: channel
// pairs split into balanced groups of at most FMAX_TX, halved while the
// staged rows exceed the shared memory a block may take.
struct FwdPlan {
  int tx, groups, cgw, sw;
  size_t smem;
};

FwdPlan plan_fwd(int C, int K, int es) {
  const int ncv = (C + 1) / 2;  // channel pairs
  const int align = 16 / es;    // elements in 16 bytes
  FwdPlan p;
  int cap = FMAX_TX;
  for (;;) {
    p.groups = (ncv + cap - 1) / cap;
    p.tx = (ncv + p.groups - 1) / p.groups;
    p.cgw = 2 * p.tx;
    p.sw = (p.cgw + align - 1) / align * align;
    p.smem = (size_t)(FTT + K - 1) * p.sw * es;
    if (p.smem <= 200 * 1024 || cap == 1) return p;
    cap = (cap + 1) / 2;
  }
}

template <typename T, int KC>
int launch_fwd(const void* x, const void* w, const void* bias, void* out,
               int B, int T_len, int C, int K, int pad_left, int flip,
               int vec16, cudaStream_t s) {
  const FwdPlan p = plan_fwd(C, K, (int)sizeof(T));
  if (p.smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = depthwise_conv1d_fwd<T, KC>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte loads need every group to start on a 16-byte boundary too
  const int v16 = vec16 && (p.cgw * (int)sizeof(T)) % 16 == 0;
  const dim3 grid(p.groups, (T_len + FTT - 1) / FTT, B);
  kern<<<grid, dim3(p.tx, FTY), p.smem, s>>>(
      (const T*)x, (const T*)w, (const T*)bias, (T*)out, T_len, C, K,
      pad_left, flip, p.cgw, p.sw, v16);
  return (int)cudaGetLastError();
}

// K with its taps in registers; any other K reads them from L1.
template <typename T>
int dispatch_fwd(const void* x, const void* w, const void* bias, void* out,
                 int B, int T_len, int C, int K, int pad_left, int flip,
                 int vec16, cudaStream_t s) {
#define SB_FWD(KC)                                                       \
  return launch_fwd<T, KC>(x, w, bias, out, B, T_len, C, K, pad_left,    \
                           flip, vec16, s)
  switch (K) {
    case 3: SB_FWD(3);
    case 5: SB_FWD(5);
    case 7: SB_FWD(7);
    case 9: SB_FWD(9);
    case 15: SB_FWD(15);
    case 31: SB_FWD(31);
    default: SB_FWD(0);
  }
#undef SB_FWD
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
// bias may be null.  flip != 0 reads the taps as w[K-1-k] (the input
// gradient).  vec16 != 0 allows 16-byte loads of x's rows: x is 16-byte
// aligned and a row, C elements, is a multiple of 16 bytes.  T * C must
// be below 2^31.  Returns cudaGetLastError() after the launch.
extern "C" int sb_depthwise_conv1d_fwd(const void* x, const void* w,
                                       const void* bias, void* out, int B,
                                       int T, int C, int K, int pad_left,
                                       int flip, int vec16, int dtype,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || T == 0 || C == 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return dispatch_fwd<float>(x, w, bias, out, B, T, C, K, pad_left, flip,
                               vec16, s);
  }
  if (dtype == 1) {
    return dispatch_fwd<__nv_bfloat16>(x, w, bias, out, B, T, C, K, pad_left,
                                       flip, vec16, s);
  }
  return (int)cudaErrorInvalidValue;
}
