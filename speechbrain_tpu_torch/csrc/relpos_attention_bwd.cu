// Backward of the flash-style rel-pos attention (relpos_attention.cu), on
// the tensor cores.
//
// Replaces: the Pallas TPU kernel
//   speechbrain_tpu/ops/pallas/relpos_attention.py _bwd_kernel / _bwd,
//   reached through relpos_attention's custom VJP.
//
// With s the forward's scores, P = exp(s - lse), dPw = dO . v (times
// keep / (1 - rate) with dropout), D = sum_d dO . O (computed outside),
// dS = P (dPw - D) scale:
//   dq = sum_k dS (k_k + p_l),  du = sum_{b,q} sum_k dS k_k,
//   dvb = sum_{b,q} sum_k dS p_l,  dk = sum_q dS (q + u),
//   dv = sum_q P keep / (1 - rate) dO,
//   dp[l] = sum over (b, q, k) with clip(T-1-q+k) = l of dS (q + vb);
// madd gets no gradient.
//
// What bounds it on the H100: operations.  The function needs 16 dh
// FLOPs per (b, h, q, k) (four products of the scores' shape, each 2 dh
// per pair, plus the position terms' four): 4.8 GFLOP at B8 H4 T512 dh36,
// 4.9 us at bf16's 989 TFLOP/s and 9.8 us at TF32's 495, against a few MB
// of traffic.  The design before this one ran every product on CUDA
// cores, one thread per row in three passes that each regenerated the
// scores: 28 dh FLOPs per pair at f32's 67 TFLOP/s.
//
// The design.  One block of four warps per (b, h, 64-key tile, query
// chunk) walks the chunk's 64-query tiles, so each (query tile, key tile)
// pair is visited once (FlashAttention-2's key-outer order).  The block
// stages K and V once, and per query tile (q + u), (q + vb), dO and the
// band of 128 P rows the pair needs (row c is p[clip(T-1-q0-63+k0 + c)];
// query i and key j of the tile read c = 63 - i + j).  Nine products per
// pair, every one an mma.sync on the tensor cores with f32 sums:
//   warp w owns query rows 16w .. 16w+15 for
//     PB  = (q+vb) Band^T  over the 80 band columns its rows reach, staged
//           in shared memory and read sheared, M[i, j] = PB[i, 63 - i + j]
//           (JAX's _shear, here an index);
//     S   = (q+u) K^T, then P = exp((S + M) scale + madd - lse), causal
//           mask, dPw = dO V^T, keep mask, dS; P keep/(1-rate) and dS go
//           to shared memory, and dS also into dPB[i, 63 - i + j] (a
//           (64, 128) buffer zeroed once: the inverse shear);
//     dQ  = dS K + dPB Band (the two parts summed per row for dq, and per
//           column over the block's rows for du and dvb);
//   warp w owns keys 16w .. 16w+15 for
//     dV += (P keep/(1-rate))^T dO,  dK += dS^T (q+u);
//   and band rows 16w .. and 64+16w .. of dBand = dPB^T (q+vb): rows
//   64 .. 127 of a pair are rows 0 .. 63 of the previous query tile's, so
//   a warp keeps its low rows in registers as the carry of its high rows
//   at the next tile and writes each band row once per block.
// Operands: bf16 inputs use bf16 multiplicands (m16n8k16), rounded where
// JAX rounds them ((q+u), (q+vb), k, v, band, dO, dS, dPB and P keep /
// (1-rate) cast to bf16 before each dot), fragments loaded with ldmatrix.
// f32 inputs use 3xTF32 (m16n8k8): x = hi + lo, x y ~ hi hi + hi lo + lo
// hi, so the rescored P agrees with the f32 lse of the forward to ~f32
// precision.  The head width is padded with zero columns to the MMA depth
// (dh 36: 48 for bf16, 40 for TF32) and the padded columns are never
// written out.  Shared rows are padded so that the rows of one ldmatrix
// (or of one fragment's word loads) fall in different banks.
// Occupancy: a bf16 block takes 108 KB of shared memory at dh 36, so two
// share an SM and hide each other's tile loads; an f32 block takes 168
// KB, one an SM, so it copies the next pair's q, dO and band rows in with
// cp.async (36 KB more) while the current pair computes, where that fits
// (dh <= 36).  The f32 passes are three MMAs each and their transposed
// operands are read a word a lane: f32 stays several times bf16's time.
//
// Dropout: the mask is the pure function of (seed, b, h, q, k) in
// relpos_dropout.cuh, so it does not depend on the tiling.  The 128
// threads generate the tile's 64 x 64 bits cooperatively into shared
// memory (one row half, 8 Philox calls, each) while the tile is staged;
// each fragment element then reads its bit.  DROP = false instantiations
// run no generator code.
//
// The fragment loads, the MMAs, one warp's tile product (warp_mma), the
// operand strides and the staging helpers are shared with the forward,
// in relpos_mma.cuh.
//
// Cross-block sums, in fixed order and with no atomics (the same inputs
// give the same bits in every run): each key tile writes its share of dq
// (pass R adds the shares in key-tile order), each query chunk its share
// of dk and dv (pass R, when there is more than one chunk), each block its
// column sums of the two dq parts (pass E: du, dvb) and its band rows in
// unclipped coordinates (pass F folds them into dp in (b, key tile,
// chunk, row) order; rows below 0 fold into row 0 and rows above 2T-2
// into row 2T-2: the clip of the padded rows, Tp > T).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "relpos_dropout.cuh"
#include "relpos_mma.cuh"

namespace {

using namespace relpos;

constexpr int BQ = 64;    // queries per tile
constexpr int BK = 64;    // keys per block
constexpr int BAND = 128; // band rows per tile pair (127 read)
constexpr int NW = 4;     // warps per block
constexpr int NTH = 32 * NW;

template <typename E, int DH>
struct Cfg {
  static constexpr int DHP = (DH + Op<E>::KS - 1) / Op<E>::KS * Op<E>::KS;
  static constexpr int NTD = DHP / 8;  // 8-column MMA tiles over the head
  static constexpr int LD_D = Op<E>::ld(DHP);
  static constexpr int LD_K = Op<E>::ld(BK);
  static constexpr int LD_P = ld_t<E>(BK);
  static constexpr int LD_B = Op<E>::ld(BAND);
  // operand tiles (elements of E)
  static constexpr int oK = 0, oV = oK + BK * LD_D, oQU = oV + BK * LD_D,
                       oQV = oQU + BQ * LD_D, oG = oQV + BQ * LD_D,
                       oBand = oG + BQ * LD_D, oPd = oBand + BAND * LD_D,
                       oDS = oPd + BQ * LD_P, oDPB = oDS + BQ * LD_K,
                       nE = oDPB + BQ * LD_B;
  // f32 scratch: the warps' PB, lse, D, madd, column-sum reduction
  static constexpr int fPB = 0, fL = fPB + NW * 16 * LD_PB, fD = fL + BQ,
                       fM = fD + BQ, fRed = fM + BK, nF = fRed + NW * 2 * DHP;
  static constexpr size_t bytesE = (nE * sizeof(E) + 15) / 16 * 16;
  static constexpr size_t base =
      bytesE + nF * sizeof(float) + 2 * BQ * sizeof(unsigned);
  // f32, where it fits: the next pair's q, dO and band rows land here by
  // cp.async (as in memory, DH wide) while the current pair computes
  static constexpr size_t landing = (size_t)(2 * BQ + BAND) * DH * 4;
  static constexpr bool PIPE =
      std::is_same<E, float>::value && base + landing <= 232448;
  static constexpr size_t smem = base + (PIPE ? landing : 0);
};

// ------------------------------------------------------------ main pass

// Grid (Tp / BK, H, B * qs_n); blockIdx.z = b * qs_n + qs.  Writes
//   dq_part  (Tp / BK, B, H, Tp, DH): key tile kt's share of dq;
//   dk_out, dv_out (qs_n, B, H, Tp, DH): query chunk qs's share;
//   band_part (B, H, Tp / BK, 64 (nqt + qs_n), DH): for each block its
//     band rows, row r <-> unclipped l = T - 64 qb + 64 kt + r, chunk qs
//     at row 64 (qa + qs) of its key tile's slab;
//   bias_part (2, B, H, Tp / BK * qs_n, DH): column sums of dq's content
//     (0) and position (1) parts over the block's rows.
template <typename E, int DH, bool DROP>
__global__ void __launch_bounds__(NTH)
    relpos_bwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ p,
                      const float* __restrict__ u,
                      const float* __restrict__ vb,
                      const float* __restrict__ madd,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      float* __restrict__ dq_part, float* __restrict__ dk_out,
                      float* __restrict__ dv_out,
                      float* __restrict__ band_part,
                      float* __restrict__ bias_part, int H, int Tp, int T,
                      float scale, int causal, int qs_n, Drop dr) {
  using C = Cfg<E, DH>;
  constexpr int NTD = C::NTD, LD_D = C::LD_D, LD_K = C::LD_K,
                LD_P = C::LD_P, LD_B = C::LD_B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sm = reinterpret_cast<E*>(smem_raw);
  E* Ks = sm + C::oK;
  E* Vs = sm + C::oV;
  E* QUs = sm + C::oQU;
  E* QVs = sm + C::oQV;
  E* Gs = sm + C::oG;
  E* Bs = sm + C::oBand;
  E* Pds = sm + C::oPd;
  E* DSs = sm + C::oDS;
  E* DPBs = sm + C::oDPB;
  float* fs = reinterpret_cast<float*>(smem_raw + C::bytesE);
  float* Ls = fs + C::fL;
  float* Dsum = fs + C::fD;
  float* Ms = fs + C::fM;
  float* red = fs + C::fRed;  // (NW, 2, DHP)
  unsigned* Km = reinterpret_cast<unsigned*>(fs + C::nF);  // (BQ, 2)

  const int nqt = Tp / BQ, nkt = gridDim.x;
  const int B = gridDim.z / qs_n;
  const int kt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / qs_n, qs = blockIdx.z % qs_n;
  const int k0 = kt * BK;
  const int qa = qs * nqt / qs_n, qb = (qs + 1) * nqt / qs_n;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = b * H + h;
  const int64_t head = (int64_t)bh * Tp * DH;
  const E* ph = p + (int64_t)h * (2 * T - 1) * DH;
  // zero every operand tile once (their padded columns and dPB's off-band
  // entries stay 0), then stage the block's keys
  for (int e = tid; e < (int)(C::bytesE / 16); e += NTH) {
    reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  {
    Tile<BK, DH, NTH> kx, vx;
    kx.load(k + head, Rows{k0});
    vx.load(v + head, Rows{k0});
    kx.template store<LD_D>(Ks, nullptr);
    vx.template store<LD_D>(Vs, nullptr);
  }
  for (int e = tid; e < BK; e += NTH) Ms[e] = madd[(int64_t)b * Tp + k0 + e];

  float dKa[NTD][4] = {}, dVa[NTD][4] = {}, carry[NTD][4] = {};
  float csc[NTD][2] = {}, csp[NTD][2] = {};  // column sums of dq's parts
  const int i0 = 16 * w;                    // the warp's rows (or keys)
  const int c0 = 48 - 16 * w;               // its first band column in PB
  float* pbw = fs + C::fPB + w * 16 * LD_PB;
  float* bandr = band_part + (((int64_t)bh * nkt + kt) * 64 * (nqt + qs_n) +
                              64 * (qa + qs)) * DH;

  // f32: tile qt + 1 is copied in while pair qt computes (landing: q, dO,
  // band rows); bf16 blocks (two an SM) hide each other's loads instead
  float* lq = reinterpret_cast<float*>(smem_raw + C::base);
  float* lg = lq + BQ * DH;
  float* lb = lg + BQ * DH;
  if constexpr (C::PIPE) {
    copy_async<BQ, DH, NTH>(lq, q + head, Rows{qa * BQ});
    copy_async<BQ, DH, NTH>(lg, dout + head, Rows{qa * BQ});
    copy_async<BAND, DH, NTH>(lb, ph, BandRows{T - 1 - (qa * BQ + BQ - 1) + k0,
                                          2 * T - 2});
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int qt = qa; qt < qb; ++qt) {
    const int q0 = qt * BQ;
    if constexpr (C::PIPE) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the previous pair's tiles are no longer read
    if constexpr (C::PIPE) {
      unpack<BQ, DH, LD_D, NTH>(QUs, lq, u + h * DH);
      unpack<BQ, DH, LD_D, NTH>(QVs, lq, vb + h * DH);
      unpack<BQ, DH, LD_D, NTH>(Gs, lg, nullptr);
      unpack<BAND, DH, LD_D, NTH>(Bs, lb, nullptr);
    } else {
      // q and dO in one round trip to memory, the band in a second (all
      // three at once would not fit in registers beside the accumulators)
      Tile<BQ, DH, NTH> qx, gx;
      qx.load(q + head, Rows{q0});
      gx.load(dout + head, Rows{q0});
      qx.template store<LD_D>(QUs, u + h * DH);
      qx.template store<LD_D>(QVs, vb + h * DH);
      gx.template store<LD_D>(Gs, nullptr);
      Tile<BAND, DH, NTH> bx;
      bx.load(ph, BandRows{T - 1 - (q0 + BQ - 1) + k0, 2 * T - 2});
      bx.template store<LD_D>(Bs, nullptr);
    }
    for (int e = tid; e < BQ; e += NTH) {
      Ls[e] = lse[(int64_t)bh * Tp + q0 + e];
      Dsum[e] = dsum[(int64_t)bh * Tp + q0 + e];
    }
    // thread tid: row tid / 2, keys 32 (tid % 2) .. + 31 of the tile
    if (DROP) Km[tid] = keep_bits32(dr, bh, q0 + (tid >> 1), k0 + 32 * (tid & 1));
    __syncthreads();
    if constexpr (C::PIPE) {  // the landing area is free again
      if (qt + 1 < qb) {
        const int q1 = q0 + BQ;
        copy_async<BQ, DH, NTH>(lq, q + head, Rows{q1});
        copy_async<BQ, DH, NTH>(lg, dout + head, Rows{q1});
        copy_async<BAND, DH, NTH>(lb, ph, BandRows{T - 1 - (q1 + BQ - 1) + k0,
                                              2 * T - 2});
        asm volatile("cp.async.commit_group;\n" ::);
      }
    }

    // PB over the band columns c0 .. c0 + 79 that rows i0 .. i0 + 15 read
    {
      float pb[PB_N / 8][4] = {};
      warp_mma<E, false, false, PB_N / 8>(pb, QVs, LD_D, i0, Bs, LD_D, c0, 0,
                                          C::DHP);
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
    // S and dPw over the 64 keys; then P keep/(1-rate) into s, dS into dp
    float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
    warp_mma<E, false, false, BK / 8>(s, QUs, LD_D, i0, Ks, LD_D, 0, 0,
                                      C::DHP);
    warp_mma<E, false, false, BK / 8>(dp, Gs, LD_D, i0, Vs, LD_D, 0, 0,
                                      C::DHP);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int il = g + 8 * half, i = i0 + il;
      const float L = Ls[i], Dr = Dsum[i];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * t + e, x = 2 * half + e;
          const float m = pbw[il * LD_PB + 63 - i + j - c0];
          float sc = (s[nt][x] + m) * scale + Ms[j];
          if (causal && k0 + j > q0 + i) sc = NEG;
          const float pr = expf(sc - L);
          float dpw = dp[nt][x], pw = pr;
          if (DROP) {
            const bool kept = (Km[2 * i + (j >> 5)] >> (j & 31)) & 1u;
            dpw = kept ? dpw * dr.inv : 0.f;
            pw = kept ? pr * dr.inv : 0.f;
          }
          s[nt][x] = pw;
          dp[nt][x] = pr * (dpw - Dr) * scale;
        }
        const int j = 8 * nt + 2 * t;
        store2(Pds + i * LD_P + j, s[nt][2 * half], s[nt][2 * half + 1]);
        store2(DSs + i * LD_K + j, dp[nt][2 * half], dp[nt][2 * half + 1]);
        E* drow = DPBs + i * LD_B + 63 - i + j;  // dPB[i, 63 - i + j] = dS
        drow[0] = from_f32<E>(dp[nt][2 * half]);
        drow[1] = from_f32<E>(dp[nt][2 * half + 1]);
      }
    }
    __syncthreads();  // P, dS and dPB of all 64 rows are in place

    // dV, dK over the warp's keys i0 .. i0 + 15 (all 64 query rows)
    warp_mma<E, true, true, NTD>(dVa, Pds, LD_P, i0, Gs, LD_D, 0, 0, BQ);
    warp_mma<E, true, true, NTD>(dKa, DSs, LD_K, i0, QUs, LD_D, 0, 0, BQ);

    // dq of the warp's rows: content dS K and position dPB Band
    {
      float qc[NTD][4] = {}, qp[NTD][4] = {};
      warp_mma<E, false, true, NTD>(qc, DSs, LD_K, i0, Ks, LD_D, 0, 0, BK);
      // columns c0 .. c0 + 79 as a fixed-length product from offset tiles
      warp_mma<E, false, true, NTD>(qp, DPBs + c0, LD_B, i0, Bs + c0 * LD_D,
                                    LD_D, 0, 0, PB_N);
      float* dqr = dq_part + ((int64_t)kt * B * H * Tp + (int64_t)bh * Tp +
                              q0 + i0) * DH;
#pragma unroll
      for (int nt = 0; nt < NTD; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (col < DH) {  // DH even: col + 1 < DH too
          store2(dqr + g * DH + col, qc[nt][0] + qp[nt][0],
                 qc[nt][1] + qp[nt][1]);
          store2(dqr + (g + 8) * DH + col, qc[nt][2] + qp[nt][2],
                 qc[nt][3] + qp[nt][3]);
        }
        csc[nt][0] += qc[nt][0] + qc[nt][2];
        csc[nt][1] += qc[nt][1] + qc[nt][3];
        csp[nt][0] += qp[nt][0] + qp[nt][2];
        csp[nt][1] += qp[nt][1] + qp[nt][3];
      }
    }

    // dBand = dPB^T (q+vb) on band rows 16w .. (the next tile's carry) and
    // 64 + 16w .. (finished: this tile's and the previous tile's share).
    // dPB[i, c] is 0 unless 63 - c <= i <= 126 - c, so each 16-row tile of
    // c reads only the 16-query steps that reach it.
    {
      float fin[NTD][4];
#pragma unroll
      for (int nt = 0; nt < NTD; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          fin[nt][x] = carry[nt][x];
          carry[nt][x] = 0.f;
        }
      }
      warp_mma<E, true, true, NTD>(carry, DPBs, LD_B, 16 * w, QVs, LD_D, 0,
                                   16 * (3 - w), BQ);
      warp_mma<E, true, true, NTD>(fin, DPBs, LD_B, 64 + 16 * w, QVs, LD_D, 0,
                                   0, 16 * (4 - w));
      // band row c of tile qt is block row 64 (qb - 1 - qt) + c
      float* fr = bandr + ((int64_t)64 * (qb - qt) + 16 * w) * DH;
      float* cr = bandr + (int64_t)16 * w * DH;  // the last tile's low rows
      const bool last = qt == qb - 1;
#pragma unroll
      for (int nt = 0; nt < NTD; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (col < DH) {
          store2(fr + g * DH + col, fin[nt][0], fin[nt][1]);
          store2(fr + (g + 8) * DH + col, fin[nt][2], fin[nt][3]);
          if (last) {
            store2(cr + g * DH + col, carry[nt][0], carry[nt][1]);
            store2(cr + (g + 8) * DH + col, carry[nt][2], carry[nt][3]);
          }
        }
      }
    }
  }

  // this chunk's dk, dv of the warp's keys
  {
    const int64_t at = ((int64_t)qs * B * H * Tp + (int64_t)bh * Tp + k0 +
                        i0) * DH;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < DH) {
        store2(dk_out + at + g * DH + col, dKa[nt][0], dKa[nt][1]);
        store2(dk_out + at + (g + 8) * DH + col, dKa[nt][2], dKa[nt][3]);
        store2(dv_out + at + g * DH + col, dVa[nt][0], dVa[nt][1]);
        store2(dv_out + at + (g + 8) * DH + col, dVa[nt][2], dVa[nt][3]);
      }
    }
  }
  // column sums of dq's parts: over the 8 row groups of the warp
  // (shuffles), then over the warps in order
#pragma unroll
  for (int nt = 0; nt < NTD; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = csc[nt][e], c = csp[nt][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        c += __shfl_xor_sync(0xffffffffu, c, o);
      }
      if (g == 0) {
        red[(w * 2 + 0) * C::DHP + 8 * nt + 2 * t + e] = a;
        red[(w * 2 + 1) * C::DHP + 8 * nt + 2 * t + e] = c;
      }
    }
  }
  __syncthreads();
  const int nparts = nkt * qs_n;
  for (int e = tid; e < 2 * DH; e += NTH) {
    const int which = e / DH, d = e % DH;
    float acc = 0.f;
    for (int ww = 0; ww < NW; ++ww) acc += red[(ww * 2 + which) * C::DHP + d];
    bias_part[((((int64_t)which * B + b) * H + h) * nparts + kt * qs_n + qs) *
                  DH + d] = acc;
  }
}

// ------------------------------------------ pass E: du, dvb from parts

// One warp per output (which, h, d): lane j adds parts j, j + 32, ... of
// the (b, key tile, query chunk) order, then the lanes' sums are added
// by a fixed butterfly.
__global__ void relpos_bwd_bias_kernel(const float* __restrict__ part,
                                       float* __restrict__ du,
                                       float* __restrict__ dvb, int B, int H,
                                       int nparts, int dh) {
  const int out = (int)((blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (out >= 2 * H * dh) return;  // whole warps
  const int which = out / (H * dh);
  const int h = out / dh % H, d = out % dh;
  float acc = 0.f;
  for (int i = lane; i < B * nparts; i += 32) {
    const int b = i / nparts, r = i % nparts;
    acc += part[((((int64_t)which * B + b) * H + h) * nparts + r) * dh + d];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) (which == 0 ? du : dvb)[h * dh + d] = acc;
}

// ------------------------------------------- pass R: sums of the shares

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

// ---------------------------------------- pass F: band rows into dp

constexpr int FOLD_B = 8;  // batch rows folded in parallel per output

// dp[h, l, d] = the sum of the block rows whose unclipped l' clips to l.
// Block (32, FOLD_B): threadIdx.x picks the output, threadIdx.y the batch
// rows b = y, y + FOLD_B, ...; each thread adds its rows in (b, query
// chunk, key tile, row) order, then the FOLD_B sums are added in y order.
// Key tile kt's slab holds row l at r = l - (T - 64 qb) - 64 kt: one row,
// or none, for every l but the two clipped ends.
__global__ void relpos_bwd_fold_kernel(const float* __restrict__ part,
                                       float* __restrict__ dp, int B, int H,
                                       int T, int nqt, int nkt, int qs_n,
                                       int dh) {
  __shared__ float red[FOLD_B][32];
  const int L = 2 * T - 1;
  const int64_t idx = (int64_t)blockIdx.x * 32 + threadIdx.x;
  const bool live = idx < (int64_t)H * L * dh;
  float acc = 0.f;
  if (live) {
    const int h = (int)(idx / ((int64_t)L * dh));
    const int l = (int)(idx / dh % L), d = (int)(idx % dh);
    const int slab = 64 * (nqt + qs_n) * dh;  // floats per (b, h, key tile)
    const bool edge = l == 0 || l == L - 1;
    for (int b = threadIdx.y; b < B; b += FOLD_B) {
      const float* pbh = part + (int64_t)(b * H + h) * nkt * slab + d;
      for (int qs = 0; qs < qs_n; ++qs) {
        const int qa = qs * nqt / qs_n, qb = (qs + 1) * nqt / qs_n;
        const int R = 64 * (qb - qa + 1);  // rows of the chunk
        const float* pc = pbh + 64 * (qa + qs) * dh;
        const int r0 = l - (T - 64 * qb);  // the row in key tile 0's slab
        if (!edge) {
#pragma unroll 8
          for (int kt = 0; kt < nkt; ++kt) {
            const int r = r0 - 64 * kt;
            acc += (r >= 0 && r < R) ? pc[kt * slab + r * dh] : 0.f;
          }
        } else {  // every row at or beyond the clip
          for (int kt = 0; kt < nkt; ++kt) {
            const int ra = max(l == 0 ? 0 : r0 - 64 * kt, 0);
            const int rb = min(l == L - 1 ? R : r0 - 64 * kt + 1, R);
            for (int r = ra; r < rb; ++r) acc += pc[kt * slab + r * dh];
          }
        }
      }
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    float sum = 0.f;
#pragma unroll
    for (int y = 0; y < FOLD_B; ++y) sum += red[y][threadIdx.x];
    dp[idx] = sum;
  }
}

// ------------------------------------------------------------ launchers

// How the work is split: one block per (b, h, key tile) gives B H Tp/64
// blocks (256 at B8 H4 T512); the query tiles are cut into qs_n chunks
// only when that leaves fewer than two blocks per SM.
struct BwdPlan {
  int nqt, nkt, qs;
  int64_t n;  // B * H * Tp * dh
  int64_t bias, dq, dkv, band, scratch;  // floats of each scratch area
};

BwdPlan plan_bwd(int B, int H, int Tp, int dh) {
  BwdPlan pl;
  pl.nqt = Tp / BQ;
  pl.nkt = Tp / BK;
  const int64_t base = (int64_t)pl.nkt * H * B;
  const int64_t want = 2 * 132 / (base > 0 ? base : 1);
  pl.qs = (int)(want < 1 ? 1 : (want > pl.nqt ? pl.nqt : want));
  pl.n = (int64_t)B * H * Tp * dh;
  pl.bias = 2LL * B * H * pl.nkt * pl.qs * dh;
  pl.dq = pl.nkt > 1 ? pl.nkt * pl.n : 0;
  pl.dkv = pl.qs > 1 ? 2 * pl.qs * pl.n : 0;
  pl.band = (int64_t)B * H * pl.nkt * 64 * (pl.nqt + pl.qs) * dh;
  pl.scratch = pl.bias + pl.dq + pl.dkv + pl.band;
  return pl;
}

struct Args {
  const void *q, *k, *v, *p;
  const float *u, *vb, *madd;
  int B, H, Tp, T;
  float scale;
  int causal;
  Drop dr;
  cudaStream_t s;
};

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
  const BwdPlan pl = plan_bwd(a.B, a.H, a.Tp, DH);
  float* bias_part = scratch;
  float* next = scratch + pl.bias;
  float* dq_part = dq;
  if (pl.nkt > 1) { dq_part = next; next += pl.dq; }
  float *dk_part = dk, *dv_part = dv;
  if (pl.qs > 1) {
    dk_part = next; next += pl.qs * pl.n;
    dv_part = next; next += pl.qs * pl.n;
  }
  float* band_part = next;

  auto kern = relpos_bwd_kernel<E, DH, DROP>;
  constexpr size_t smem = Cfg<E, DH>::smem;
  // once per instantiation: the attribute call costs host time on every
  // launch otherwise
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaError_t err = attr;
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(pl.nkt, a.H, a.B * pl.qs), NTH, smem, a.s>>>(
      (const E*)a.q, (const E*)a.k, (const E*)a.v, (const E*)a.p, a.u, a.vb,
      a.madd, dout, lse, dsum, dq_part, dk_part, dv_part, band_part,
      bias_part, a.H, a.Tp, a.T, a.scale, a.causal, pl.qs, a.dr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (pl.nkt > 1 && (err = sum_parts(dq_part, dq, pl.nkt, pl.n, a.s))) {
    return (int)err;
  }
  if (pl.qs > 1) {
    if ((err = sum_parts(dk_part, dk, pl.qs, pl.n, a.s))) return (int)err;
    if ((err = sum_parts(dv_part, dv, pl.qs, pl.n, a.s))) return (int)err;
  }
  const int64_t n_dp = (int64_t)a.H * (2 * a.T - 1) * DH;
  relpos_bwd_fold_kernel<<<(unsigned)((n_dp + 31) / 32), dim3(32, FOLD_B), 0,
                           a.s>>>(band_part, dp, a.B, a.H, a.T, pl.nqt,
                                  pl.nkt, pl.qs, DH);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_bias = 2 * a.H * DH;  // outputs, one warp each
  relpos_bwd_bias_kernel<<<(n_bias + 7) / 8, 256, 0, a.s>>>(
      bias_part, du, dvb, a.B, a.H, pl.nkt * pl.qs, DH);
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

// Floats of scratch the backward needs at this shape.
extern "C" long long sb_relpos_attention_bwd_scratch(int B, int H, int Tp,
                                                     int T, int dh) {
  (void)T;
  return (long long)plan_bwd(B, H, Tp, dh).scratch;
}

// q, k, v (B, H, Tp, dh) and p (H, 2T-1, dh) in dtype (0 = float32, 1 =
// bfloat16); u, vb (H, dh), madd (B, Tp), dout (B, H, Tp, dh), lse and
// dsum (B, H, Tp) float32.  Outputs, all float32: dq, dk, dv (B, H, Tp,
// dh), dp (H, 2T-1, dh), du and dvb (H, dh).  part is scratch of
// sb_relpos_attention_bwd_scratch floats.  Tp must be a multiple of 64
// and dh one of 16, 32, 36, 64.  The dropout arguments are the
// forward's: drop = 0 is rate 0, else thresh = min(2^32 - 1, floor(rate
// 2^32)), inv = 1 / (1 - rate), (key0, key1) = (seed & 0xffffffff, seed
// >> 32).  Returns cudaGetLastError() after the launches.
extern "C" int sb_relpos_attention_bwd(
    const void* q, const void* k, const void* v, const void* p, const void* u,
    const void* vb, const void* madd, const void* dout, const void* lse,
    const void* dsum, void* dq, void* dk, void* dv, void* dp, void* du,
    void* dvb, void* part, int B, int H, int Tp, int T, int dh, float scale,
    int causal, int drop, unsigned thresh, float inv, unsigned key0,
    unsigned key1, int dtype, void* stream) {
  if (B == 0 || H == 0 || Tp == 0) return 0;
  if (Tp % BQ != 0 || T < 1 || T > Tp) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, p, (const float*)u, (const float*)vb,
               (const float*)madd, B, H, Tp, T, scale, causal,
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
    SB_DISPATCH_DH(drop, dh, (launch_bwd<bf16, DH, DROP>(
                                 a, g, l, D, oq, ok, ov, op, ou, ob, pt)))
  }
  return (int)cudaErrorInvalidValue;
}
