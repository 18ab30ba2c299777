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
//   dbias[c] = sum_{b,t} dy[b,t,c]   (with dw, from the same pass)
//
// What bounds it on the H100: bytes.  K*C outputs, each a sum over B*T
// products; the least traffic is x and dy read once (training shape
// B=32, T=251, C=144, K=31, f32: 9.3 MB, 2.8 us) against 2*K*B*T*C = 72
// MFLOP.
//
// The design: the TPU kernel carries the sum across its sequential grid
// (init at b == 0); blocks on the card run in no order, so each block
// sums one piece and the pieces are added in the same launch.  One block
// per (16-channel tile, time chunk of one utterance): chunks of up to
// 256 rows, cut shorter only to reach ~2 blocks an SM (B32 T251: one
// chunk an utterance, 288 blocks; B8 T512: 128 rows).  The block stages
// its dy rows and x rows with the K-1 halo in shared memory by cp.async,
// 16 bytes a copy where the rows allow (scalar loads otherwise), taps
// outside [0, T) as zero.  Each thread owns two channels (float2 or
// __nv_bfloat162 reads), a group of taps and a time group of rows: its
// accumulators and a window of the x values its taps need sit in
// registers (the common K, 3 to 31, are template cases; any other K runs
// taps in groups of 8), so each row costs one x and one dy read for 2K
// FMAs, and dbias is one more add.  The time groups' sums meet in shared
// memory and are added in order into the block's partial (K+1 rows of 16
// f32).  Then the last block of a channel tile to finish, picked by an
// integer ticket (atomicAdd on a counter that it sets back to zero),
// adds the tile's partials in chunk order.  No float atomics: the same
// bits on every call.

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

constexpr int DW_CT = 16;     // channels a tile: 8 pairs, one per thread column
constexpr int DW_TY = 16;     // thread rows a block
constexpr int DW_NT = (DW_CT / 2) * DW_TY;
constexpr int DW_TC_MAX = 256;  // time rows a chunk at most
constexpr int DW_BLOCKS = 264;  // blocks to aim for: two a streaming multiprocessor

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// The taps' gradient's launch shape for (B, T, C, K): channel tiles of
// DW_CT; each utterance cut into ntc time chunks of at most TC rows, as
// many as it takes to reach DW_BLOCKS blocks with chunks of 32 rows or
// more; taps in NG groups of KG (KG = K for the common K, whose taps and
// window then sit in registers; 8 for any other K, the taps padded to
// Kp); the block's DW_TY thread rows split into TGn time groups of RP
// rows (RP = 1 mod 4: the groups of a warp read other shared banks).
struct DwPlan {
  int tiles, ntc, TC, KG, NG, Kp, TGn, RP;
  size_t smem;
};

int dw_kg(int K) {
  switch (K) {
    case 3: case 4: case 5: case 7: case 9: case 15: case 31: return K;
    default: return 8;
  }
}

DwPlan plan_dw(int B, int T, int C, int K, int es) {
  DwPlan p;
  p.tiles = (C + DW_CT - 1) / DW_CT;
  const int per_utt = (DW_BLOCKS + B * p.tiles - 1) / (B * p.tiles);
  p.ntc = max((T + DW_TC_MAX - 1) / DW_TC_MAX, min(per_utt, max(1, T / 32)));
  p.TC = (T + p.ntc - 1) / p.ntc;
  p.ntc = (T + p.TC - 1) / p.TC;
  p.KG = dw_kg(K);
  p.NG = (K + p.KG - 1) / p.KG;
  p.Kp = p.NG * p.KG;
  p.TGn = p.NG >= DW_TY ? 1 : DW_TY / p.NG;
  p.RP = (p.TC + p.TGn - 1) / p.TGn;
  p.RP += (5 - p.RP % 4) % 4;
  const size_t stage = ((size_t)(2 * p.TC + p.Kp - 1) * DW_CT * es + 15) & ~(size_t)15;
  p.smem = stage + (size_t)p.TGn * (p.Kp + 1) * DW_CT * sizeof(float);
  return p;
}

// Stage rows [t_lo, t_lo + nrows) of one utterance's tile channels into
// shared rows of DW_CT elements; rows outside [0, T) and channels past C
// read zero.  16-byte cp.async copies when vec16, scalar loads otherwise.
template <typename T>
__device__ __forceinline__ void stage_rows(T* __restrict__ s,
                                           const T* __restrict__ g, int t_lo,
                                           int nrows, int T_len, int C,
                                           int gw, bool vec16) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (vec16) {
    constexpr int cpr = DW_CT * (int)sizeof(T) / 16;  // copies a shared row
    const int valid_c = gw * (int)sizeof(T) / 16;     // of them in range
    for (int e = tid; e < nrows * cpr; e += DW_NT) {
      const int r = e / cpr, j = e - r * cpr;
      const int t = t_lo + r;
      const bool ok = t >= 0 && t < T_len && j < valid_c;
      cp_async16_zfill(reinterpret_cast<uint4*>(s + r * DW_CT) + j,
                       ok ? reinterpret_cast<const uint4*>(g + (int64_t)t * C) + j
                          : reinterpret_cast<const void*>(g),
                       ok);
    }
  } else {
    for (int e = tid; e < nrows * DW_CT; e += DW_NT) {
      const int r = e / DW_CT, c = e - r * DW_CT;
      const int t = t_lo + r;
      s[e] = (t >= 0 && t < T_len && c < gw) ? g[(int64_t)t * C + c]
                                             : from_f32<T>(0.f);
    }
  }
}

// dy (rows r0 .. r0+n-1) against the staged x rows through taps k0 ..
// k0+KG-1 of channels (c, c+1): acc[i] += dy[r] * x[r + k0 + i] over r,
// in row order, with the KG x values a row needs held in a register
// window that moves one row a step (slot (u + i) % KG holds x[r + k0 +
// i] at step u of each KG-step block: compile-time indices); bacc sums
// dy.
template <typename T, int KG>
__device__ __forceinline__ void dw_rows(const T* __restrict__ xs,
                                        const T* __restrict__ dys, int r0,
                                        int n, int k0, int c, float2 (&acc)[KG],
                                        float2& bacc) {
  using V = typename Pair<T>::V;
  auto xv = [&](int row) {
    return Pair<T>::f32(*reinterpret_cast<const V*>(xs + row * DW_CT + c));
  };
  float2 w[KG];
#pragma unroll
  for (int i = 0; i < KG - 1; ++i) w[i] = xv(r0 + k0 + i);
  for (int base = 0; base < n; base += KG) {
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int s = base + u;
      if (s >= n) break;
      w[(u + KG - 1) % KG] = xv(r0 + s + k0 + KG - 1);
      const float2 d = Pair<T>::f32(*reinterpret_cast<const V*>(dys + (r0 + s) * DW_CT + c));
      bacc.x += d.x;
      bacc.y += d.y;
#pragma unroll
      for (int i = 0; i < KG; ++i) {
        const float2 xw = w[(u + i) % KG];
        acc[i].x = fmaf(d.x, xw.x, acc[i].x);
        acc[i].y = fmaf(d.y, xw.y, acc[i].y);
      }
    }
  }
}

// Grid (tiles, B * ntc), block (DW_CT / 2, DW_TY).  partial: (tiles, B *
// ntc, K + 1, DW_CT) f32 scratch; counters: tiles ints, zero on entry
// and left zero; dbias may be null.
template <typename T, int KG>
__global__ void __launch_bounds__(DW_NT)
    depthwise_conv1d_dw_kernel(const T* __restrict__ x,
                               const T* __restrict__ dy,
                               float* __restrict__ partial,
                               unsigned* __restrict__ counters,
                               float* __restrict__ dw,
                               float* __restrict__ dbias, int T_len, int C,
                               int K, int pad_left, int ntc, int TC, int NG,
                               int TGn, int RP, int vec16) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  __shared__ int is_last;
  const int Kp = NG * KG;
  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;  // b * ntc + time chunk
  const int n_chunks = gridDim.y;
  const int b = chunk / ntc;
  const int t0 = (chunk - b * ntc) * TC;
  const int nrows = min(TC, T_len - t0);
  const int c0 = tile * DW_CT;
  const int gw = min(DW_CT, C - c0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int c = 2 * threadIdx.x;
  const int64_t base = (int64_t)b * T_len * C + c0;
  T* xs = reinterpret_cast<T*>(dw_smem);  // (TC + Kp - 1, DW_CT)
  T* dys = xs + (TC + Kp - 1) * DW_CT;     // (TC, DW_CT)
  stage_rows(xs, x + base, t0 - pad_left, nrows + Kp - 1, T_len, C, gw, vec16 != 0);
  stage_rows(dys, dy + base, t0, nrows, T_len, C, gw, vec16 != 0);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // items (tap group g, time group tg), each summed in row order into
  // its reduction rows
  float* red = reinterpret_cast<float*>(
      dw_smem + (((size_t)(2 * TC + Kp - 1) * DW_CT * sizeof(T) + 15) & ~(size_t)15));
  for (int it = threadIdx.y; it < NG * TGn; it += DW_TY) {
    const int g = it % NG, tg = it / NG;
    const int r0 = tg * RP;
    const int n = max(0, min(RP, nrows - r0));
    float2 acc[KG];
#pragma unroll
    for (int i = 0; i < KG; ++i) acc[i] = make_float2(0.f, 0.f);
    float2 bacc = make_float2(0.f, 0.f);
    if (n > 0) dw_rows<T, KG>(xs, dys, r0, n, g * KG, c, acc, bacc);
    float* rr = red + (tg * (Kp + 1) + g * KG) * DW_CT + c;
#pragma unroll
    for (int i = 0; i < KG; ++i) *reinterpret_cast<float2*>(rr + i * DW_CT) = acc[i];
    if (g == 0) *reinterpret_cast<float2*>(red + (tg * (Kp + 1) + Kp) * DW_CT + c) = bacc;
  }
  __syncthreads();

  // the block's partial: time groups added in order; row K is dbias
  const int nout = (K + (dbias != nullptr)) * DW_CT;
  float* part = partial + ((int64_t)tile * n_chunks + chunk) * (K + 1) * DW_CT;
  for (int e = tid; e < nout; e += DW_NT) {
    const int k = e / DW_CT, cc = e - k * DW_CT;
    const int row = k < K ? k : Kp;
    float s = 0.f;
    for (int tg = 0; tg < TGn; ++tg) s += red[(tg * (Kp + 1) + row) * DW_CT + cc];
    part[e] = s;
  }
  // the last block of a tile to finish adds the tile's partials in chunk
  // order (an integer ticket picks it; no float atomics) and sets the
  // tile's counter back to zero for the next call
  // (the block's barrier orders its threads' partial writes before
  // thread 0's device-scope fence and ticket: the release; the last
  // block's fence after its ticket, then the barrier: the acquire)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned ticket = atomicAdd(counters + tile, 1u);
    is_last = ticket == (unsigned)n_chunks - 1;
    if (is_last) {
      counters[tile] = 0u;
      __threadfence();
    }
  }
  __syncthreads();
  if (!is_last) return;
  // a thread per 4 channels of a row: its chunks' loads in flight (8 at
  // a time: deeper was slower on the H100), then added in chunk order
  const float4* tp = reinterpret_cast<const float4*>(
      partial + (int64_t)tile * n_chunks * (K + 1) * DW_CT);
  const int cs = (K + 1) * DW_CT / 4;  // float4 a chunk
  constexpr int U = 8;
  for (int e = tid; e < nout / 4; e += DW_NT) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ch = 0; ch < n_chunks; ch += U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ch + u < n_chunks) v[u] = __ldcg(tp + (int64_t)(ch + u) * cs + e);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ch + u < n_chunks) {
          s.x += v[u].x;
          s.y += v[u].y;
          s.z += v[u].z;
          s.w += v[u].w;
        }
      }
    }
    const int k = 4 * e / DW_CT, cc = 4 * e - k * DW_CT;
    float* o = k < K ? dw + k * C : dbias;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (cc + j < gw) o[c0 + cc + j] = sv[j];
    }
  }
}

template <typename T, int KG>
int launch_dw(const DwPlan& p, const void* x, const void* dy, float* partial,
              unsigned* counters, float* dw, float* dbias, int B, int T_len,
              int C, int K, int pad_left, int vec16, cudaStream_t s) {
  auto kern = depthwise_conv1d_dw_kernel<T, KG>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(p.tiles, B * p.ntc);
  kern<<<grid, dim3(DW_CT / 2, DW_TY), p.smem, s>>>(
      (const T*)x, (const T*)dy, partial, counters, dw, dbias, T_len, C, K,
      pad_left, p.ntc, p.TC, p.NG, p.TGn, p.RP, vec16);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dw(const void* x, const void* dy, float* partial,
                unsigned* counters, float* dw, float* dbias, int B, int T_len,
                int C, int K, int pad_left, int vec16, cudaStream_t s) {
  const DwPlan p = plan_dw(B, T_len, C, K, (int)sizeof(T));
  if (p.smem > 227 * 1024) return (int)cudaErrorInvalidValue;
#define SB_DW(KG)                                                          \
  return launch_dw<T, KG>(p, x, dy, partial, counters, dw, dbias, B,       \
                          T_len, C, K, pad_left, vec16, s)
  switch (p.KG) {
    case 3: SB_DW(3);
    case 4: SB_DW(4);
    case 5: SB_DW(5);
    case 7: SB_DW(7);
    case 9: SB_DW(9);
    case 15: SB_DW(15);
    case 31: SB_DW(31);
    default: SB_DW(8);
  }
#undef SB_DW
}

}  // namespace

// Floats of the taps' gradient's scratch `partial` for (B, T, C, K),
// and its channel tiles (the ints of `counters`).
extern "C" long long sb_depthwise_conv1d_dw_scratch(int B, int T, int C, int K) {
  const DwPlan p = plan_dw(B, T, C, K, 4);
  return (long long)p.tiles * B * p.ntc * (K + 1) * DW_CT;
}
extern "C" int sb_depthwise_conv1d_dw_tiles(int C) {
  return (C + DW_CT - 1) / DW_CT;
}

// dtype: 0 = float32, 1 = bfloat16 (x and dy); partial (scratch), dw
// (K, C) and dbias (C,) are float32; dbias may be null (no bias
// gradient).  counters: sb_depthwise_conv1d_dw_tiles(C) ints, zero, left
// zero; one set a stream (calls on one stream run in order).  vec16 != 0
// allows 16-byte copies: x and dy 16-byte aligned, C elements a
// multiple of 16 bytes.  B, T >= 1.  Returns cudaGetLastError() after
// the launch.
extern "C" int sb_depthwise_conv1d_dw(const void* x, const void* dy,
                                      void* partial, void* counters, void* dw,
                                      void* dbias, int B, int T, int C, int K,
                                      int pad_left, int vec16, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 0 || C == 0) return 0;
  if (B < 1 || T < 1 || K < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return dispatch_dw<float>(x, dy, (float*)partial, (unsigned*)counters,
                              (float*)dw, (float*)dbias, B, T, C, K, pad_left,
                              vec16, s);
  }
  if (dtype == 1) {
    return dispatch_dw<__nv_bfloat16>(x, dy, (float*)partial,
                                      (unsigned*)counters, (float*)dw,
                                      (float*)dbias, B, T, C, K, pad_left,
                                      vec16, s);
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
