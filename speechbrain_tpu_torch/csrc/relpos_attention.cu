// Flash-style attention with the Transformer-XL relative-position bias
// computed in the kernel: forward (with the per-row log-sum-exp) and
// backward.
//
// Replaces: the Pallas TPU kernels
//   speechbrain_tpu/ops/pallas/relpos_attention.py _fwd_kernel / _fwd
//   (forward) and _bwd_kernel / _bwd (backward), reached through
//   relpos_attention.
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
// keep is a pure function of (seed, b, h, q, k): Philox4x32-10 (Salmon
// et al., SC'11) with key (seed & 0xffffffff, seed >> 32) and counter
// (k >> 2, q, b H + h, 0); output word k & 3 belongs to key k, which is
// kept iff that word >= thresh = min(2^32 - 1, floor(rate 2^32)).  The
// TPU's hardware generator has no counterpart here, so its bits are not
// reproduced; its threshold rule and gradient formulas are.  Because the
// mask depends on no tile, block order or Tp, every pass regenerates
// exactly the bits it needs for the (q, k) pairs it visits: a thread of
// K5 or pass A generates its row's 64 bits of each key tile (16 Philox
// calls), passes B and D generate the tile's 64 rows cooperatively into
// shared memory.  The case rate = 0 is a separate instantiation
// (DROP = false) that runs no generator code.  The plain version is
// relpos_dropout_keep in ops/relpos_attention.py.
//
// ---- forward (sb_relpos_attention_fwd) ----
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
//
// ---- backward (sb_relpos_attention_bwd) ----
//
// With P = exp(s - lse), dP = dO . v, D = sum_d dO . O (computed outside),
// ds = P (dP - D) scale:
//   dq = sum_k ds (k_k + p_l),  du = sum_{b,q} sum_k ds k_k,
//   dvb = sum_{b,q} sum_k ds p_l,  dk = sum_q ds (q + u),
//   dv = sum_q P dO,  dp[l] = sum over (b, q, k) with clip(T-1-q+k) = l
//   of ds (q + vb);  madd gets no gradient.
// With dropout, dP = dO . v keep / (1 - rate) and dv = sum_q P keep /
// (1 - rate) dO; D is the dropped output's, so ds keeps its form.
//
// What bounds it on the H100: operations.  The function needs 16 dh
// FLOPs per (b, h, q, k): 16 x 8 x 4 x 512^2 x 36 = 4.8 GFLOP at the
// training shape (B=8, T=512), ~72 us at 67 TFLOP/s in f32, against a
// few MB of traffic.
//
// What the simple design does about it: the TPU kernel accumulates dk,
// dv, dp, du and dvb across its sequential grid; blocks on the card run
// in no order, so each output is owned by the block that computes it and
// the scores are regenerated (from q, k, p, u, vb, madd and lse) in each
// pass instead of being stored:
//   A  one block per (b, h, 64-query tile, key chunk), thread per query
//      row: that chunk's share of dq, and per-block sums of the content
//      and position parts of dq;
//   B  one block per (b, h, 64-key tile, query chunk), thread per key:
//      that chunk's share of dk and dv;
//   D  one block per (b, query chunk, h, 64 rows of p), thread per row l:
//      dp[l] along its diagonal k = q - (T-1) + l over the chunk's rows,
//      plus, only when Tp > T, the pairs whose position index is clipped
//      to l = 0 or l = 2T-2;
//   R  the chunks' partial dq, dk, dv and dp added up in chunk order;
//   E  du and dvb as sums of pass A's per-block parts in block order.
// The chunks (see BwdPlan) exist to give each pass ~1024 blocks: with one
// thread per row a pass has only B x H x Tp / 64 blocks of 64 threads.
// The regeneration makes the kernel do 28 dh FLOPs per (b, h, q, k)
// instead of 16.  Every sum runs in a fixed order and there are no
// atomics: the same inputs give the same bits in every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// Dropout parameters (see the header); unused when DROP is false.
struct Drop {
  unsigned thresh, k0, k1;  // keep threshold, Philox key
  float inv;                // 1 / (1 - rate)
};

// Philox4x32-10: four 32-bit words from a 128-bit counter and a 64-bit key.
__device__ __forceinline__ uint4 philox(uint4 c, unsigned k0, unsigned k1) {
  constexpr unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr unsigned W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const unsigned hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// Keep bits of query row q over the 64 keys kstart .. kstart + 63 of head
// bh = b H + h: bit t is the pair (q, kstart + t).  kstart need not be a
// multiple of 4 (pass D's diagonal bands); bits of keys outside [0, Tp)
// are computed all the same and never read.
__device__ __forceinline__ uint64_t keep_bits(const Drop& d, int bh, int q,
                                              int kstart) {
  const int mis = kstart & 3;
  const int g0 = kstart >> 2;  // floor(kstart / 4), negative kstart too
  uint64_t bits = 0;
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    if (i == 16 && mis == 0) break;
    const uint4 r = philox(
        make_uint4((unsigned)(g0 + i), (unsigned)q, (unsigned)bh, 0u), d.k0,
        d.k1);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = 4 * i + c - mis;
      if (t >= 0 && t < 64 && w[c] >= d.thresh) bits |= 1ull << t;
    }
  }
  return bits;
}

// The keep bit of the single pair (q, k), 0 <= k.
__device__ __forceinline__ bool keep_one(const Drop& d, int bh, int q, int k) {
  const uint4 r = philox(make_uint4((unsigned)(k >> 2), (unsigned)q,
                                    (unsigned)bh, 0u),
                         d.k0, d.k1);
  const int c = k & 3;
  return (c == 0 ? r.x : c == 1 ? r.y : c == 2 ? r.z : r.w) >= d.thresh;
}

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
__device__ __forceinline__ float dot_rows(const float* __restrict__ a,
                                          const float* __restrict__ b) {
  const float4* x = reinterpret_cast<const float4*>(a);
  const float4* y = reinterpret_cast<const float4*>(b);
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    const float4 c = x[d4], e = y[d4];
    acc += c.x * e.x + c.y * e.y + c.z * e.z + c.w * e.w;
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

// ------------------------------------------------ backward, pass A: dq

template <int DH>
constexpr size_t bwd_a_smem_bytes() {
  return fwd_smem_bytes<DH>();
}

template <typename E, int DH, bool DROP>
__global__ void __launch_bounds__(BQ)
    relpos_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ p,
                         const float* __restrict__ u,
                         const float* __restrict__ vb,
                         const float* __restrict__ madd,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         float* __restrict__ dq, float* __restrict__ part,
                         int H, int Tp, int T, float scale, int causal,
                         int ks_n, Drop dr) {
  constexpr int S = Stride<DH>::value;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * S;
  float* Ps = Vs + BK * S;
  float* Ms = Ps + BAND * S;

  // blockIdx.z = b * ks_n + ks: key chunk ks of batch row b
  const int B = gridDim.z / ks_n, nqt = gridDim.x, nkt = Tp / BK;
  const int b = blockIdx.z / ks_n, ks = blockIdx.z % ks_n;
  const int h = blockIdx.y, qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int i = threadIdx.x;
  const int qrow = q0 + i;
  const int64_t head = ((int64_t)b * H + h) * Tp * DH;
  const int64_t row = ((int64_t)b * H + h) * Tp + qrow;
  const E* ph = p + (int64_t)h * (2 * T - 1) * DH;

  float qu[DH], qv[DH], g[DH], dqc[DH], dqp[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float x = to_f32(q[head + (int64_t)qrow * DH + d]);
    qu[d] = x + u[h * DH + d];
    qv[d] = x + vb[h * DH + d];
    g[d] = dout[head + (int64_t)qrow * DH + d];
    dqc[d] = 0.f;
    dqp[d] = 0.f;
  }
  const float L = lse[row], Dr = dsum[row];
  const int k_end = (ks + 1) * nkt / ks_n * BK;

  for (int k0 = ks * nkt / ks_n * BK; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<E, DH>(Ks, k + head, k0, BK, Tp, nullptr);
    stage<E, DH>(Vs, v + head, k0, BK, Tp, nullptr);
    stage_band<E, DH>(Ps, ph, T - 1 - (q0 + BQ - 1) + k0, T);
    for (int e = i; e < BK; e += BQ) Ms[e] = madd[(int64_t)b * Tp + k0 + e];
    uint64_t keep = 0;
    if (DROP) keep = keep_bits(dr, b * H + h, qrow, k0);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const float* prow = Ps + (BQ - 1 - i + j) * S;
      float s = (dot_row<DH>(qu, Ks + j * S) + dot_row<DH>(qv, prow)) * scale +
                Ms[j];
      if (causal && k0 + j > qrow) s = NEG;
      const float pr = expf(s - L);
      float dpw = dot_row<DH>(g, Vs + j * S);
      if (DROP) dpw = ((keep >> j) & 1) ? dpw * dr.inv : 0.f;
      const float ds = pr * (dpw - Dr) * scale;
      axpy_row<DH>(dqc, ds, Ks + j * S);
      axpy_row<DH>(dqp, ds, prow);
    }
  }
  // this key chunk's share of dq: dq itself when ks_n == 1, else slice
  // ks of the (ks_n, B, H, Tp, DH) partials that pass R sums
  float* dqr = dq + (int64_t)ks * B * H * Tp * DH + head + (int64_t)qrow * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) dqr[d] = dqc[d] + dqp[d];

  // per-block sums of the content (-> du) and position (-> dvb) parts,
  // over the block's rows in row order
  __syncthreads();
  float* red = smem;  // (2, BQ, DH)
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    red[i * DH + d] = dqc[d];
    red[(BQ + i) * DH + d] = dqp[d];
  }
  __syncthreads();
  for (int e = i; e < 2 * DH; e += BQ) {
    const int which = e / DH, d = e % DH;
    float acc = 0.f;
    for (int r = 0; r < BQ; ++r) acc += red[(which * BQ + r) * DH + d];
    part[(((((int64_t)which * B + b) * H + h) * nqt + qt) * ks_n + ks) * DH +
         d] = acc;
  }
}

// -------------------------------------------- backward, pass B: dk, dv

template <int DH, bool DROP>
constexpr size_t bwd_b_smem_bytes() {
  return (size_t)(3 * BQ + BAND) * Stride<DH>::value * sizeof(float) +
         (DROP ? BQ * sizeof(uint64_t) : 0) + 2 * BQ * sizeof(float);
}

template <typename E, int DH, bool DROP>
__global__ void __launch_bounds__(BK)
    relpos_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                          const E* __restrict__ v, const E* __restrict__ p,
                          const float* __restrict__ u,
                          const float* __restrict__ vb,
                          const float* __restrict__ madd,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Tp, int T, float scale, int causal,
                          int qs_n, Drop dr) {
  constexpr int S = Stride<DH>::value;
  extern __shared__ __align__(16) float smem[];
  float* QUs = smem;              // (BQ, S) q + u
  float* QVs = QUs + BQ * S;      // (BQ, S) q + vb
  float* Gs = QVs + BQ * S;       // (BQ, S) dO
  float* Ps = Gs + BQ * S;        // (BAND, S)
  // (BQ,) keep bits of the tile's query rows over its keys, when DROP
  uint64_t* Km = reinterpret_cast<uint64_t*>(Ps + BAND * S);
  float* Ls = Ps + BAND * S + (DROP ? 2 * BQ : 0);  // (BQ,) lse
  float* Ds = Ls + BQ;            // (BQ,) dsum

  // blockIdx.z = b * qs_n + qs: query chunk qs of batch row b
  const int B = gridDim.z / qs_n, nqt = Tp / BQ;
  const int b = blockIdx.z / qs_n, qs = blockIdx.z % qs_n, h = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int j = threadIdx.x;
  const int kcol = k0 + j;
  const int64_t head = ((int64_t)b * H + h) * Tp * DH;
  const int64_t rows = ((int64_t)b * H + h) * Tp;
  const E* ph = p + (int64_t)h * (2 * T - 1) * DH;

  float kk[DH], vv[DH], dka[DH], dva[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    kk[d] = to_f32(k[head + (int64_t)kcol * DH + d]);
    vv[d] = to_f32(v[head + (int64_t)kcol * DH + d]);
    dka[d] = 0.f;
    dva[d] = 0.f;
  }
  const float mj = madd[(int64_t)b * Tp + kcol];
  const int q_end = (qs + 1) * nqt / qs_n * BQ;

  for (int q0 = qs * nqt / qs_n * BQ; q0 < q_end; q0 += BQ) {
    __syncthreads();
    stage<E, DH>(QUs, q + head, q0, BQ, Tp, u + h * DH);
    stage<E, DH>(QVs, q + head, q0, BQ, Tp, vb + h * DH);
    stage<float, DH>(Gs, dout + head, q0, BQ, Tp, nullptr);
    stage_band<E, DH>(Ps, ph, T - 1 - (q0 + BQ - 1) + k0, T);
    for (int e = j; e < BQ; e += BK) {
      Ls[e] = lse[rows + q0 + e];
      Ds[e] = dsum[rows + q0 + e];
    }
    // thread j generates row q0 + j of the tile's mask (BK == BQ)
    if (DROP) Km[j] = keep_bits(dr, b * H + h, q0 + j, k0);
    __syncthreads();
    for (int il = 0; il < BQ; ++il) {
      const float* qur = QUs + il * S;
      const float* gr = Gs + il * S;
      float s = (dot_row<DH>(kk, qur) +
                 dot_rows<DH>(QVs + il * S, Ps + (BQ - 1 - il + j) * S)) *
                    scale +
                mj;
      if (causal && kcol > q0 + il) s = NEG;
      const float pr = expf(s - Ls[il]);
      float dpw = dot_row<DH>(vv, gr), pw = pr;
      if (DROP) {
        const bool kept = (Km[il] >> j) & 1;
        dpw = kept ? dpw * dr.inv : 0.f;
        pw = kept ? pr * dr.inv : 0.f;
      }
      const float ds = pr * (dpw - Ds[il]) * scale;
      axpy_row<DH>(dka, ds, qur);
      axpy_row<DH>(dva, pw, gr);
    }
  }
  // dk, dv themselves when qs_n == 1, else slice qs of the partials
  const int64_t at = (int64_t)qs * B * H * Tp * DH + head + (int64_t)kcol * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk[at + d] = dka[d];
    dv[at + d] = dva[d];
  }
}

// ------------------------------------------------- backward, pass D: dp

template <int DH, bool DROP>
constexpr size_t bwd_d_smem_bytes() {
  return (size_t)(3 * BQ + 2 * BAND) * Stride<DH>::value * sizeof(float) +
         (DROP ? BQ * sizeof(uint64_t) : 0) + (2 * BQ + BAND) * sizeof(float);
}

// ds and (q + vb) of one (b, q, k) pair from global memory: the clipped
// pairs of pass D (only when Tp > T).
template <typename E, int DH, bool DROP>
__device__ float pair_ds(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const float* __restrict__ u,
                         const float* __restrict__ vb,
                         const float* __restrict__ madd,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         const float (&pl)[DH], float (&qv)[DH], int b, int h,
                         int H, int Tp, int qi, int kj, float scale,
                         int causal, const Drop& dr) {
  const int64_t head = ((int64_t)b * H + h) * Tp * DH;
  const int64_t row = ((int64_t)b * H + h) * Tp + qi;
  float su = 0.f, sv = 0.f, dpv = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float x = to_f32(q[head + (int64_t)qi * DH + d]);
    qv[d] = x + vb[h * DH + d];
    su += (x + u[h * DH + d]) * to_f32(k[head + (int64_t)kj * DH + d]);
    sv += qv[d] * pl[d];
    dpv += dout[head + (int64_t)qi * DH + d] *
           to_f32(v[head + (int64_t)kj * DH + d]);
  }
  float s = (su + sv) * scale + madd[(int64_t)b * Tp + kj];
  if (causal && kj > qi) s = NEG;
  if (DROP) dpv = keep_one(dr, b * H + h, qi, kj) ? dpv * dr.inv : 0.f;
  return expf(s - lse[row]) * (dpv - dsum[row]) * scale;
}

template <typename E, int DH, bool DROP>
__global__ void __launch_bounds__(BQ)
    relpos_bwd_dp_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ p,
                         const float* __restrict__ u,
                         const float* __restrict__ vb,
                         const float* __restrict__ madd,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         float* __restrict__ dp, int H, int Tp, int T,
                         float scale, int causal, int ds_n, Drop dr) {
  constexpr int S = Stride<DH>::value;
  extern __shared__ __align__(16) float smem[];
  float* QUs = smem;              // (BQ, S)
  float* QVs = QUs + BQ * S;      // (BQ, S)
  float* Gs = QVs + BQ * S;       // (BQ, S)
  float* Kb = Gs + BQ * S;        // (BAND, S) keys of the band
  float* Vb = Kb + BAND * S;      // (BAND, S)
  // (BQ,) keep bits when DROP: row il over the keys jb0 + il + [0, 64)
  uint64_t* Dm = reinterpret_cast<uint64_t*>(Vb + BAND * S);
  float* Ls = Vb + BAND * S + (DROP ? 2 * BQ : 0);  // (BQ,)
  float* Ds = Ls + BQ;            // (BQ,)
  float* Mb = Ds + BQ;            // (BAND,)

  // blockIdx.z = b * ds_n + qs: query chunk qs of batch row b
  const int nqt = Tp / BQ;
  const int b = blockIdx.z / ds_n, qs = blockIdx.z % ds_n;
  const int q_begin = qs * nqt / ds_n * BQ, q_end = (qs + 1) * nqt / ds_n * BQ;
  const int h = blockIdx.y;
  const int l0 = blockIdx.x * BQ;
  const int ll = threadIdx.x;
  const int l = l0 + ll;
  const int L = 2 * T - 1;
  const bool live = l < L;
  const E* ph = p + (int64_t)h * L * DH;

  float pl[DH], dpa[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    pl[d] = live ? to_f32(ph[(int64_t)l * DH + d]) : 0.f;
    dpa[d] = 0.f;
  }

  {
    const int64_t head = ((int64_t)b * H + h) * Tp * DH;
    const int64_t rows = ((int64_t)b * H + h) * Tp;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      // keys of the pair (q0 + il, l0 + ll): jb0 + il + ll
      const int jb0 = q0 + l0 - (T - 1);
      __syncthreads();
      stage<E, DH>(QUs, q + head, q0, BQ, Tp, u + h * DH);
      stage<E, DH>(QVs, q + head, q0, BQ, Tp, vb + h * DH);
      stage<float, DH>(Gs, dout + head, q0, BQ, Tp, nullptr);
      stage<E, DH>(Kb, k + head, jb0, BAND, Tp, nullptr);
      stage<E, DH>(Vb, v + head, jb0, BAND, Tp, nullptr);
      for (int e = ll; e < BQ; e += BQ) {
        Ls[e] = lse[rows + q0 + e];
        Ds[e] = dsum[rows + q0 + e];
      }
      for (int e = ll; e < BAND; e += BQ) {
        const int kj = jb0 + e;
        Mb[e] = (kj >= 0 && kj < Tp) ? madd[(int64_t)b * Tp + kj] : 0.f;
      }
      if (DROP) Dm[ll] = keep_bits(dr, b * H + h, q0 + ll, jb0 + ll);
      __syncthreads();
      if (!live) continue;
      for (int il = 0; il < BQ; ++il) {
        const int r = il + ll;
        const int kj = jb0 + r;
        if (kj < 0 || kj >= Tp) continue;
        const float* qvr = QVs + il * S;
        float s = (dot_rows<DH>(QUs + il * S, Kb + r * S) +
                   dot_row<DH>(pl, qvr)) *
                      scale +
                  Mb[r];
        if (causal && kj > q0 + il) s = NEG;
        const float pr = expf(s - Ls[il]);
        float dpw = dot_rows<DH>(Gs + il * S, Vb + r * S);
        if (DROP) dpw = ((Dm[il] >> ll) & 1) ? dpw * dr.inv : 0.f;
        const float ds = pr * (dpw - Ds[il]) * scale;
        axpy_row<DH>(dpa, ds, qvr);
      }
    }
  }
  // pairs whose position index T-1-q+k falls outside [0, 2T-2] read the
  // clipped row 0 or 2T-2; they exist only for padded rows (Tp > T)
  if (live && Tp > T && (l == 0 || l == L - 1)) {
    float qv[DH];
    for (int qi = q_begin; qi < q_end; ++qi) {
      for (int kj = 0; kj < Tp; ++kj) {
        const int idx = T - 1 - qi + kj;
        if ((l == 0 && idx >= 0) || (l == L - 1 && idx <= L - 1)) continue;
        const float ds = pair_ds<E, DH, DROP>(q, k, v, u, vb, madd, dout,
                                              lse, dsum, pl, qv, b, h, H, Tp,
                                              qi, kj, scale, causal, dr);
#pragma unroll
        for (int d = 0; d < DH; ++d) dpa[d] += ds * qv[d];
      }
    }
  }
  if (!live) return;
  // slice (b, qs) of the (B * ds_n, H, L, DH) partials that pass R sums
  float* dpr = dp + (((int64_t)blockIdx.z * gridDim.y + h) * L + l) * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) dpr[d] = dpa[d];
}

// ------------------------------------------- backward, pass E: du, dvb

__global__ void relpos_bwd_bias_kernel(const float* __restrict__ part,
                                       float* __restrict__ du,
                                       float* __restrict__ dvb, int B, int H,
                                       int nparts, int dh) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * H * dh) return;
  const int which = idx / (H * dh);
  const int h = (idx % (H * dh)) / dh, d = idx % dh;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    for (int r = 0; r < nparts; ++r) {  // (query tile, key chunk) in order
      acc += part[((((int64_t)which * B + b) * H + h) * nparts + r) * dh + d];
    }
  }
  (which == 0 ? du : dvb)[h * dh + d] = acc;
}

// ------------------------------- backward, pass R: sums of the partials

// out[i] = sum over r in order of parts[r * n + i]
__global__ void relpos_bwd_sum_kernel(const float* __restrict__ parts,
                                      float* __restrict__ out, int nparts,
                                      int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int r = 0; r < nparts; ++r) acc += parts[(int64_t)r * n + i];
  out[i] = acc;
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

// How the backward splits its work.  One thread per row leaves a pass
// with B x H x (Tp / 64) blocks of 64 threads: 256 at the training shape,
// two per SM, too few to hide the latency of the serial dot products.
// Each pass therefore also splits its loop (keys for pass A, queries for
// B and D) into chunks, aiming at ~1024 blocks; the chunks write partial
// sums that pass R adds up in chunk order, so the result does not depend
// on which block finishes first.
struct BwdPlan {
  int ks, qs, ds;       // key chunks (A), query chunks (B), query chunks (D)
  int64_t n;            // B * H * Tp * dh
  int64_t bias_floats;  // pass A's per-block du / dvb parts
  int64_t scratch;      // floats of scratch in all
};

int chunks(int64_t base_blocks, int tiles) {
  const int64_t want = 1024 / (base_blocks > 0 ? base_blocks : 1);
  return (int)(want < 1 ? 1 : (want > tiles ? tiles : want));
}

BwdPlan plan_bwd(int B, int H, int Tp, int T, int dh) {
  const int nqt = Tp / BQ, nkt = Tp / BK, nlt = (2 * T - 1 + BQ - 1) / BQ;
  BwdPlan pl;
  pl.ks = chunks((int64_t)nqt * H * B, nkt);
  pl.qs = chunks((int64_t)nkt * H * B, nqt);
  pl.ds = chunks((int64_t)nlt * H * B, nqt);
  pl.n = (int64_t)B * H * Tp * dh;
  pl.bias_floats = 2LL * B * H * nqt * pl.ks * dh;
  pl.scratch = pl.bias_floats + (pl.ks > 1 ? pl.ks * pl.n : 0) +
               (pl.qs > 1 ? 2 * pl.qs * pl.n : 0) +
               (int64_t)B * pl.ds * H * (2 * T - 1) * dh;
  return pl;
}

cudaError_t sum_parts(const float* parts, float* out, int nparts, int64_t n,
                      cudaStream_t s) {
  relpos_bwd_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      parts, out, nparts, n);
  return cudaGetLastError();
}

template <typename E, int DH, bool DROP>
int launch_bwd(const Args& a, const float* dout, const float* lse,
               const float* dsum, float* dq, float* dk, float* dv, float* dp,
               float* du, float* dvb, float* scratch) {
  const E *q = (const E*)a.q, *k = (const E*)a.k, *v = (const E*)a.v,
          *p = (const E*)a.p;
  const int nqt = a.Tp / BQ, nkt = a.Tp / BK;
  const int L = 2 * a.T - 1, nlt = (L + BQ - 1) / BQ;
  const BwdPlan pl = plan_bwd(a.B, a.H, a.Tp, a.T, DH);
  float* bias_part = scratch;
  float* next = scratch + pl.bias_floats;
  float* dq_out = dq;
  if (pl.ks > 1) { dq_out = next; next += pl.ks * pl.n; }
  float *dk_out = dk, *dv_out = dv;
  if (pl.qs > 1) {
    dk_out = next; next += pl.qs * pl.n;
    dv_out = next; next += pl.qs * pl.n;
  }
  float* dp_part = next;

  auto ka = relpos_bwd_dq_kernel<E, DH, DROP>;
  cudaError_t err = allow_smem(ka, bwd_a_smem_bytes<DH>());
  if (err != cudaSuccess) return (int)err;
  ka<<<dim3(nqt, a.H, a.B * pl.ks), BQ, bwd_a_smem_bytes<DH>(), a.s>>>(
      q, k, v, p, a.u, a.vb, a.madd, dout, lse, dsum, dq_out, bias_part, a.H,
      a.Tp, a.T, a.scale, a.causal, pl.ks, a.dr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (pl.ks > 1 && (err = sum_parts(dq_out, dq, pl.ks, pl.n, a.s))) {
    return (int)err;
  }

  auto kb = relpos_bwd_dkv_kernel<E, DH, DROP>;
  constexpr size_t smem_b = bwd_b_smem_bytes<DH, DROP>();
  if ((err = allow_smem(kb, smem_b)) != cudaSuccess) return (int)err;
  kb<<<dim3(nkt, a.H, a.B * pl.qs), BK, smem_b, a.s>>>(
      q, k, v, p, a.u, a.vb, a.madd, dout, lse, dsum, dk_out, dv_out, a.H,
      a.Tp, a.T, a.scale, a.causal, pl.qs, a.dr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (pl.qs > 1) {
    if ((err = sum_parts(dk_out, dk, pl.qs, pl.n, a.s))) return (int)err;
    if ((err = sum_parts(dv_out, dv, pl.qs, pl.n, a.s))) return (int)err;
  }

  auto kd = relpos_bwd_dp_kernel<E, DH, DROP>;
  constexpr size_t smem_d = bwd_d_smem_bytes<DH, DROP>();
  if ((err = allow_smem(kd, smem_d)) != cudaSuccess) return (int)err;
  kd<<<dim3(nlt, a.H, a.B * pl.ds), BQ, smem_d, a.s>>>(
      q, k, v, p, a.u, a.vb, a.madd, dout, lse, dsum, dp_part, a.H, a.Tp,
      a.T, a.scale, a.causal, pl.ds, a.dr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = sum_parts(dp_part, dp, a.B * pl.ds, (int64_t)a.H * L * DH,
                       a.s))) {
    return (int)err;
  }

  const int n = 2 * a.H * DH;
  relpos_bwd_bias_kernel<<<(n + 127) / 128, 128, 0, a.s>>>(
      bias_part, du, dvb, a.B, a.H, nqt * pl.ks, DH);
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

// Floats of scratch the backward needs at this shape.
extern "C" long long sb_relpos_attention_bwd_scratch(int B, int H, int Tp,
                                                     int T, int dh) {
  return (long long)plan_bwd(B, H, Tp, T, dh).scratch;
}

// Backward.  dout (B, H, Tp, dh), lse and dsum (B, H, Tp) and every
// output are float32: dq, dk, dv (B, H, Tp, dh), dp (H, 2T-1, dh), du and
// dvb (H, dh).  part is scratch of sb_relpos_attention_bwd_scratch floats.
// The dropout arguments are the forward's.  Returns cudaGetLastError()
// after the launches.
extern "C" int sb_relpos_attention_bwd(
    const void* q, const void* k, const void* v, const void* p, const void* u,
    const void* vb, const void* madd, const void* dout, const void* lse,
    const void* dsum, void* dq, void* dk, void* dv, void* dp, void* du,
    void* dvb, void* part, int B, int H, int Tp, int T, int dh, float scale,
    int causal, int drop, unsigned thresh, float inv, unsigned key0,
    unsigned key1, int dtype, void* stream) {
  if (B == 0 || H == 0 || Tp == 0) return 0;
  if (Tp % BQ != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, p, (const float*)u, (const float*)vb,
               (const float*)madd, B, H, Tp, T, scale, causal, drop,
               Drop{thresh, key0, key1, inv}, (cudaStream_t)stream};
  const float *g = (const float*)dout, *l = (const float*)lse,
              *D = (const float*)dsum;
  float *oq = (float*)dq, *ok = (float*)dk, *ov = (float*)dv,
        *op = (float*)dp, *ou = (float*)du, *ob = (float*)dvb,
        *pt = (float*)part;
  if (dtype == 0) {
    SB_DISPATCH_DH(drop, dh, (launch_bwd<float, DH, DROP>(
                                 a, g, l, D, oq, ok, ov, op, ou, ob, pt)))
  }
  if (dtype == 1) {
    SB_DISPATCH_DH(drop, dh, (launch_bwd<__nv_bfloat16, DH, DROP>(
                                 a, g, l, D, oq, ok, ov, op, ou, ob, pt)))
  }
  return (int)cudaErrorInvalidValue;
}
