// Flash-style attention with the Transformer-XL relative-position bias
// computed in the kernel, on the tensor cores: the forward, with the
// per-row log-sum-exp that the backward (relpos_attention_bwd.cu) reads.
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
// keep is the pure function of (seed, b, h, q, k) in relpos_dropout.cuh,
// so no tiling changes it; the TPU's hardware generator has no
// counterpart here, so its bits are not reproduced; its threshold rule
// and gradient formulas are.  The block's threads make the key tile's
// keep bits together into shared memory (a row half, 8 Philox calls, a
// thread) while the tile is staged.  DROP = false instantiations run no
// generator code.
//
// ---- what bounds it, and the design ----
//
// What bounds it on the H100: operations.  At the long-utterance shape
// that routes here (B=2..8, H=4, T=512..1024, dh=36) the least traffic
// is q, k, v, p, out and lse once each, a few MB, against 6 dh FLOPs per
// (b, h, q, k) (the content, position and context products): 1.8 GFLOP
// at B8 H4 T512, 3.7 us at TF32's 495 TFLOP/s (bf16: its 6.3 MB of
// traffic, 1.9 us).  The design before this one ran them on CUDA cores
// (67 TFLOP/s: 27 us), one thread per query row.
//
// The design: one block of 4 warps per (b, h, 64-query tile); warp w owns
// query rows 16w .. 16w+15.  (q + u) and (q + vb) are staged once.
// The block walks the 64-key tiles, staging K, V and the band of P rows
// the tile pair needs (row c is p[clip(T-1-q0-63+k0 + c)]; query i and
// key j read c = 63 - i + j), and each warp computes with mma.sync (f32
// sums):
//   PB = (q+vb) Band^T over the 80 band columns its rows reach, staged in
//        shared memory and read sheared, M[i, j] = PB[i, 63 - i + j]
//        (JAX's _shear, here an index), as the backward does;
//   S  = (q+u) K^T, then s = (S + M) scale + madd, the causal mask;
//   an online softmax in the accumulator fragments (FlashAttention-2): the
//        row max and sum over the quad of lanes that holds a row, O and
//        the sum rescaled when the max grows;
//   O += (P keep/(1-rate)) V, the weights staged per warp as the A
//        operand;
// and writes out = O / l and lse = m + log l once per row.
// Operands: bf16 inputs use bf16 multiplicands (m16n8k16), rounded where
// JAX's kernel rounds them ((q+u), (q+vb), k, the band, v and the weights
// before the context product); the weights are taken against the running
// max, where JAX's single pass takes the row's, so the rounding of a
// weight can differ by a bf16 step.  f32 inputs use 3xTF32 (m16n8k8):
// x = hi + lo, x y ~ hi hi + hi lo + lo hi, each k-step's three products
// summed apart and added to the f32 accumulator on the CUDA cores
// (warp_mma's STEP_SUM): ~f32 precision without the drift of the tensor
// core's own accumulation, which flipped ReLUs in the decoder of the
// training step's gradient check.  The head width is padded with zero
// columns to the MMA depth (dh 36: 48 for bf16, 40 for TF32); the padded
// columns are never written out.  The fragment loads, warp_mma, the
// operand strides and the staging helpers are the backward's, in
// relpos_mma.cuh.  No atomics: the same bits in every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "relpos_dropout.cuh"
#include "relpos_mma.cuh"

namespace {

using namespace relpos;

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int BAND = BQ + BK;   // band rows a tile pair stages (127 read)
constexpr int NW = 4;           // warps per block, 16 query rows each
constexpr int NTH = 32 * NW;

// A forward block's operand tiles of E and f32 scratch in shared memory.
template <typename E, int DH>
struct FwdCfg {
  // rows staged a round trip: the whole band while a thread's share fits
  // in a few registers (dh <= 36), else 32 rows (dh 64 spilled)
  static constexpr int BAND_PIECE = BAND * DH / 4 / NTH <= 14 ? BAND : 32;
  static constexpr int DHP = (DH + Op<E>::KS - 1) / Op<E>::KS * Op<E>::KS;
  static constexpr int NTD = DHP / 8;  // 8-column MMA tiles over the head
  static constexpr int LD_D = Op<E>::ld(DHP);
  static constexpr int LD_P = Op<E>::ld(BK);  // a warp's weights (16, BK)
  // operand tiles (elements of E)
  static constexpr int oQU = 0, oQV = oQU + BQ * LD_D, oK = oQV + BQ * LD_D,
                       oV = oK + BK * LD_D, oBand = oV + BK * LD_D,
                       oP = oBand + BAND * LD_D, nE = oP + NW * 16 * LD_P;
  // f32 scratch: the warps' PB, the tile's madd
  static constexpr int fPB = 0, fM = fPB + NW * 16 * LD_PB, nF = fM + BK;
  static constexpr size_t bytesE = (nE * sizeof(E) + 15) / 16 * 16;
  static constexpr size_t smem =
      bytesE + nF * sizeof(float) + 2 * BQ * sizeof(unsigned);
};

// Rows 0 .. N-1 of a DH-wide operand (row r is src + row(r) DH) into
// shared rows of stride LD, P rows a round trip: the loads of a piece
// are in flight together, in the registers of one piece.
template <int N, int P, int DH, int NT, int LD, typename E, typename Row>
__device__ __forceinline__ void stage(E* __restrict__ dst,
                                      const E* __restrict__ src, Row row) {
  static_assert(N % P == 0, "whole pieces");
#pragma unroll 1
  for (int r0 = 0; r0 < N; r0 += P) {
    Tile<P, DH, NT> x;
    x.load(src, [&](int r) { return row(r0 + r); });
    x.template store<LD>(dst + r0 * LD, nullptr);
  }
}

// Grid (Tp / BQ, H, B), NTH threads.  Writes out (B, H, Tp, DH) and lse
// (B, H, Tp), both f32.
template <typename E, int DH, bool DROP>
__global__ void __launch_bounds__(NTH)
    relpos_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ p,
                      const float* __restrict__ u,
                      const float* __restrict__ vb,
                      const float* __restrict__ madd, float* __restrict__ out,
                      float* __restrict__ lse, int H, int Tp, int T,
                      float scale, int causal, Drop dr) {
  using C = FwdCfg<E, DH>;
  constexpr int NTD = C::NTD, LD_D = C::LD_D, LD_P = C::LD_P;
  constexpr bool F32 = std::is_same<E, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sm = reinterpret_cast<E*>(smem_raw);
  E* QUs = sm + C::oQU;
  E* QVs = sm + C::oQV;
  E* Ks = sm + C::oK;
  E* Vs = sm + C::oV;
  E* Bs = sm + C::oBand;
  float* fs = reinterpret_cast<float*>(smem_raw + C::bytesE);
  float* Ms = fs + C::fM;
  unsigned* Km = reinterpret_cast<unsigned*>(fs + C::nF);  // (BQ, 2)

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = b * H + h;
  const int64_t head = (int64_t)bh * Tp * DH;
  const E* ph = p + (int64_t)h * (2 * T - 1) * DH;
  // zero every operand tile once (their padded columns stay 0), then
  // stage the block's (q + u) and (q + vb)
  for (int e = tid; e < (int)(C::bytesE / 16); e += NTH) {
    reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  {
    Tile<BQ, DH, NTH> qx;
    qx.load(q + head, Rows{q0});
    qx.template store<LD_D>(QUs, u + h * DH);
    qx.template store<LD_D>(QVs, vb + h * DH);
  }

  const int i0 = 16 * w;             // the warp's rows
  const int c0 = BQ - 16 - 16 * w;   // its first band column in PB
  float* pbw = fs + C::fPB + w * 16 * LD_PB;
  E* Pw = sm + C::oP + w * 16 * LD_P;
  float o[NTD][4] = {};
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};              // this lane's share of the sums

  for (int k0 = 0; k0 < Tp; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    {  // K and V in one round trip
      Tile<BK, DH, NTH> kx, vx;
      kx.load(k + head, Rows{k0});
      vx.load(v + head, Rows{k0});
      kx.template store<LD_D>(Ks, nullptr);
      vx.template store<LD_D>(Vs, nullptr);
    }
    stage<BAND, C::BAND_PIECE, DH, NTH, LD_D>(
        Bs, ph, BandRows{T - 1 - (q0 + BQ - 1) + k0, 2 * T - 2});
    for (int e = tid; e < BK; e += NTH) Ms[e] = madd[(int64_t)b * Tp + k0 + e];
    // thread tid: row tid / 2, keys 32 (tid % 2) .. + 31 of the tile
    if (DROP) Km[tid] = keep_bits32(dr, bh, q0 + (tid >> 1), k0 + 32 * (tid & 1));
    __syncthreads();

    // PB over the band columns c0 .. c0 + 79 that rows i0 .. i0 + 15 read
    {
      float pb[PB_N / 8][4] = {};
      warp_mma<E, false, false, PB_N / 8, F32>(pb, QVs, LD_D, i0, Bs, LD_D,
                                               c0, 0, C::DHP);
#pragma unroll
      for (int nt = 0; nt < PB_N / 8; ++nt) {
        const int col = 8 * nt + 2 * t;
        pbw[g * LD_PB + col] = pb[nt][0];
        pbw[g * LD_PB + col + 1] = pb[nt][1];
        pbw[(g + 8) * LD_PB + col] = pb[nt][2];
        pbw[(g + 8) * LD_PB + col + 1] = pb[nt][3];
      }
      __syncwarp();
    }
    // S over the 64 keys, the scores and the tile's row max
    float s[BK / 8][4] = {};
    warp_mma<E, false, false, BK / 8, F32>(s, QUs, LD_D, i0, Ks, LD_D, 0, 0,
                                           C::DHP);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int il = g + 8 * half, i = i0 + il;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * t + e, x = 2 * half + e;
          // M[i, j] = PB[i, 63 - i + j], column 15 - il + j of the warp's
          const float mpos = pbw[il * LD_PB + 15 - il + j];
          float sc = (s[nt][x] + mpos) * scale + Ms[j];
          if (causal && k0 + j > q0 + i) sc = NEG;
          s[nt][x] = sc;
          mt[half] = fmaxf(mt[half], sc);
        }
      }
    }
    // online softmax: the new row max over the quad, rescale O and l;
    // the weights (before dropout, as the normalizer) into Pw
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = mt[half];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float corr = expf(m_run[half] - m_new);  // 0 at the first tile
      m_run[half] = m_new;
      l_run[half] *= corr;
#pragma unroll
      for (int nt = 0; nt < NTD; ++nt) {
        o[nt][2 * half] *= corr;
        o[nt][2 * half + 1] *= corr;
      }
      const int il = g + 8 * half, i = i0 + il;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        float wgt[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * t + e;
          const float pr = expf(s[nt][2 * half + e] - m_new);
          l_run[half] += pr;
          wgt[e] = pr;
          if (DROP) {
            const bool kept = (Km[2 * i + (j >> 5)] >> (j & 31)) & 1u;
            wgt[e] = kept ? pr * dr.inv : 0.f;
          }
        }
        store2(Pw + il * LD_P + 8 * nt + 2 * t, wgt[0], wgt[1]);
      }
    }
    __syncwarp();
    // O += (P keep/(1-rate)) V over the tile's keys
    warp_mma<E, false, true, NTD, F32>(o, Pw, LD_P, 0, Vs, LD_D, 0, 0, BK);
  }

  // the row sums over the quad, then out = O / l and lse = m + log l
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + i0 + g + 8 * half;
    const float inv = 1.f / l;
    float* orow = out + head + (int64_t)row * DH;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < DH) {  // DH even: col + 1 < DH too
        store2(orow + col, o[nt][2 * half] * inv, o[nt][2 * half + 1] * inv);
      }
    }
    if (t == 0) lse[(int64_t)bh * Tp + row] = m_run[half] + logf(l);
  }
}

// ------------------------------------------------------------ launchers

struct Args {
  const void *q, *k, *v, *p;
  const float *u, *vb, *madd;
  int B, H, Tp, T;
  float scale;
  int causal;
  Drop dr;
  cudaStream_t s;
};

template <typename E, int DH, bool DROP>
int launch_fwd(const Args& a, float* out, float* lse) {
  using C = FwdCfg<E, DH>;
  auto kern = relpos_fwd_kernel<E, DH, DROP>;
  // once per instantiation: the attribute call costs host time on every
  // launch otherwise
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<dim3(a.Tp / BQ, a.H, a.B), NTH, C::smem, a.s>>>(
      (const E*)a.q, (const E*)a.k, (const E*)a.v, (const E*)a.p, a.u, a.vb,
      a.madd, out, lse, a.H, a.Tp, a.T, a.scale, a.causal, a.dr);
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
#define SB_DISPATCH_DH(drop, dh, CALL) \
  if (drop) {                          \
    constexpr bool DROP = true;        \
    SB_DISPATCH_DH_1(dh, CALL)         \
  } else {                             \
    constexpr bool DROP = false;       \
    SB_DISPATCH_DH_1(dh, CALL)         \
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
  if (Tp % 64 != 0 || T < 1 || T > Tp) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, p, (const float*)u, (const float*)vb,
               (const float*)madd, B, H, Tp, T, scale, causal,
               Drop{thresh, key0, key1, inv}, (cudaStream_t)stream};
  float *o = (float*)out, *l = (float*)lse;
  if (dtype == 0) {
    SB_DISPATCH_DH(drop, dh, (launch_fwd<float, DH, DROP>(a, o, l)))
  }
  if (dtype == 1) {
    SB_DISPATCH_DH(drop, dh, (launch_fwd<bf16, DH, DROP>(a, o, l)))
  }
  return (int)cudaErrorInvalidValue;
}
