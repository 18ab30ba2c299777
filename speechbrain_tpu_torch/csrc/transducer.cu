// RNN-T lattice (log semiring): the forward (alpha) recursion with the
// per-utterance log-likelihood, and the backward (beta) recursion with
// the occupancy gradients of the blank and emit tables.
//
// Replaces: the Pallas TPU kernels speechbrain_tpu/ops/pallas/transducer.py
//   _fwd_kernel / _run_forward (pl.pallas_call at l.253) and
//   _bwd_kernel / _run_backward (pl.pallas_call at l.311).
//
// Inputs are the masked tables of _pad_tables, batch-major and unpadded:
//   blank (B, T, U+1) = log P(blank | t, u), set to 0 (log 1) for t >= tb;
//   emit  (B, T, U)   = log P(y_{u+1} | t, u), set to NEG for u >= ub or
//                       t >= tb;
// with tb = t_lens[b], ub = u_lens[b].  Over the full T x (U+1) lattice:
//   alpha[0, 0] = 0
//   alpha[t, u] = lae(alpha[t-1, u] + blank[t-1, u],     (NEG at t = 0)
//                     alpha[t, u-1] + emit[t, u-1])      (NEG at u = 0)
//   final[b]    = alpha[tb-1, ub] + blank[tb-1, ub], 0 when tb = 0
//   beta[T, u]  = 0 at u = ub, else NEG                   (virtual row)
//   beta[t, u]  = lae(beta[t+1, u] + blank[t, u],
//                     beta[t, u+1] + emit[t, u])          (NEG at u = U)
//   dblank[t,u] = -exp(max(alpha[t,u] + blank[t,u] + beta[t+1,u] - logZ,
//                          -80)) for t < tb, else 0
//   demit[t,u]  = -exp(max(alpha[t,u] + emit[t,u] + beta[t,u+1] - logZ,
//                          -80)) where emit > NEG/2, else 0
// with NEG = -1e30, logZ = final[b], and lae(a, b) = m + log(exp(max(a-m,
// -80)) + exp(max(b-m, -80))), m = max(a, b, NEG): the JAX kernel's fill,
// clamps and form, so that impossible states take the same values.  The
// libm expf and logf that lae calls are branch-free on sm_90a (predicated
// special cases: their SASS holds no convergence barrier).
//
// The TPU walks t through its sequential grid and solves each row's
// u-recurrence as a Hillis-Steele prefix scan over 128 lanes.  Here the
// lattice is walked along its anti-diagonals d = t + u: every cell of a
// diagonal depends only on the previous diagonal (alpha's upper and left
// neighbours, beta's lower and right ones, lie on d - 1 or d + 1), so each
// cell is the recurrence itself, computed once, T + U dependent steps.
//
// What bounds it on the H100.  The bytes: blank, emit in and alpha out,
// 12 B a cell (2.35 MB at B 12, T 251, U+1 65: 0.7 us at 3.35 TB/s); the
// backward reads blank, emit and alpha and writes the two gradients, 20 B
// a cell (1.2 us).  Far above either stands the chain of T + U dependent
// diagonals, each a lae behind a warp shuffle: ~0.1 us a step
// (chip_smoke.py's chain_term_ms), 31 us at T 251, U 64.  A table walked
// along its diagonals touches a different row, a different sector, in
// every lane.
//
// What the design does about it.  Lattices of up to CHAIN_COLS = 160
// columns take the warp-chain path: one block per utterance; W = 1..5
// chain warps, each with R role warps (K8: 2, K9: 3).
//   Chain warp w: lane l owns column u = 32 w + l and keeps the last
//   diagonal in a register; the neighbour column comes from lane l -+ 1 by
//   one __shfl_sync, the warp's edge column from warp w -+ 1 through a
//   small ring in shared memory (bnd).  At the start of a chunk of DCH =
//   16 diagonals the lane reads its column's 16 table values with four
//   16-byte loads from a ring in shared memory (lat), and at its end
//   writes its 16 results the same way: on the chain itself there is no
//   barrier, no memory access and no branch, only the shuffle, a few
//   selects and the lae.
//   Role warps: they fill lat with 4-byte cp.async two chunks ahead of
//   their chain warp, row by row over the chunk's parallelogram of cells
//   (16 consecutive cells of a row a half warp, 2-3 sectors instead of
//   16), and drain the chain's output ring the same way: alpha (K8), or
//   (K9) the sums down = beta[t+1, u] + blank[t, u] and right = beta[t,
//   u+1] + emit[t, u] of each cell, from which they compute the gradients
//   in exactly the expressions above (alpha gathered a chunk ahead, the
//   masks from lat) and write dblank and demit by rows.  A role warp's
//   memory instructions issue slowly, whatever their bytes, so a chain
//   warp has several, each a share of the rows; their copies, masks and
//   stores are predicated instructions, not branches.
//   The warps move in lockstep steps, one block barrier a step (not a
//   named-barrier pair a chain warp: five chain warps would need more of
//   those than a block has); no spin-wait, flag or atomic.  Each output
//   element is written by one thread, so two calls give the same bits.
// Wider lattices (up to MAX_COLS = 29056) take the block path: one block
// per utterance, each of its threads (at most 1024) owns NC = 1, 2, 4, ...
// 32 columns, u = thread + c blockDim; the last two diagonals
// double-buffered in shared memory and one barrier a diagonal; up to 8
// columns a thread, each thread prefetches the table values of its next
// 8 / NC diagonals into registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory of a block

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG);
  return m + logf(expf(fmaxf(a - m, -80.f)) + expf(fmaxf(b - m, -80.f)));
}

// ------------------------------------------------------ warp-chain path

constexpr int DCH = 16;  // diagonals a chunk (a half warp's row segment)
constexpr int RING = 2;  // chunks the output rings (and bnd) hold
// chunks the table ring holds: filled two chunks ahead of the chain,
// while K9's role warps still read the masks of the chunk before it
constexpr int LAT = 4;
// The widest lattice of the warp-chain path: up to 5 chain warps, each
// with ROLES_K8 or ROLES_K9 role warps (fewer role warps set the step
// with their memory instructions; past 5 chain warps no more than one
// fits a block, and the block path is the faster at U+1 = 257).
constexpr int CHAIN_COLS = 160;
constexpr int ROLES_K8 = 2, ROLES_K9 = 3;
constexpr int CHAIN_THREADS = 640;  // chain and role warps of a block

// A 4-byte cp.async of src where on is true, else 4 zero bytes (the
// zero-fill form: no predicate, which ptxas would turn into a branch
// around each copy); lanes that are off write to a dummy float.
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src,
                                                  bool on) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 4 : 0));
}
// A global store where on is true: one predicated instruction (written
// as a C++ if, it becomes a branch around the store).
__device__ __forceinline__ void st_if(float* p, float v, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"((int)on)
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A chunk's DCH values of one column, kept in registers by the chain lane
// and moved to and from a ring slot (column u at u * DCH) in four 16-byte
// accesses.
__device__ __forceinline__ void ld_col(float (&v)[DCH], const float* p) {
#pragma unroll
  for (int q = 0; q < DCH / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
  }
}
__device__ __forceinline__ void st_col(float* p, const float (&v)[DCH]) {
#pragma unroll
  for (int q = 0; q < DCH / 4; ++q) {
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// Every cell of chunk rows j < DCH whose column u lies in [ulo, uhi) and
// whose row ts = e0 + j - u lies in [0, nrow): f(u * DCH + j, ts, u,
// true), two rows an instruction (lane: j = lane % 16, row parity lane /
// 16), so that a half warp visits 16 consecutive cells of one row (and 16
// banks of the ring: column stride DCH + row step 1).  Lanes off those
// cells get f(i, ts, u', false) with u' clamped into [ulo, uhi), so that f
// reads in bounds and predicates its writes: no branch in the loop, and
// the unrolled iterations' loads overlap.  Warp-uniform loop.
template <typename F>
__device__ __forceinline__ void chunk_rows(int e0, int ulo, int uhi, int nrow,
                                           int lane, int r, int R, F f) {
  if (uhi <= ulo) return;
  const int j = lane & (DCH - 1);
  const int t0 = max(0, e0 - uhi + 1);
  const int t1 = min(nrow, e0 + DCH - ulo);
#pragma unroll 4
  for (int ts = t0 + 2 * r + (lane >> 4); ts < t1; ts += 2 * R) {
    const int u = e0 + j - ts;
    const bool in = u >= ulo && u < uhi;
    const int uc = min(max(u, ulo), uhi - 1);
    f(uc * DCH + j, ts, uc, in);
  }
}

// cp.async into a ring slot (column-major) the cell of table src (nrow x
// ncol, row-major) that chain column u of chunk row j reads: row t - dt,
// column u - dv of the cell (t, u) on diagonal e0 + j.  dummy: a float
// of shared memory that lanes off the chunk fill with zeros.
__device__ __forceinline__ void gather(float* dst, float* dummy,
                                       const float* __restrict__ src,
                                       int nrow, int ncol, int dt, int dv,
                                       int e0, int ulo, int uhi, int lane,
                                       int r, int R) {
  chunk_rows(e0 - dt, max(ulo, dv), min(uhi, ncol + dv), nrow, lane, r, R,
             [&](int i, int ts, int u, bool in) {
               cp_async4_or_zero(in ? dst + i : dummy,
                                 src + (int64_t)ts * ncol + u - dv, in);
             });
}

// Shared memory of the chain kernels, in floats: the two table rings of
// LAT slots, `rings` output rings of RING slots (a slot: W 32 columns of
// DCH), bnd [W][RING][DCH], then 4 floats, the gathers' dummy.
__host__ __device__ inline size_t chain_floats(int W, int rings) {
  return (size_t)(2 * LAT + rings * RING) * W * 32 * DCH +
         (size_t)W * RING * DCH + 4;
}

// The kernels walk in steps, one block barrier a step.  Chain warp w
// computes chunk k at step k + lag(w), lag(w) = w for alpha (each warp
// reads the edge column of the warp on its left, computed a step
// earlier) and W - 1 - w for beta; its role warps drain chunk k at the
// step after, and at each step fill the table ring two chunks ahead of
// their chain warp (chunks 0 and 1 before the first step).  Role warp r
// of chain warp w (warp W + W r + w) takes the rows of a chunk in pairs
// r, r + R, ...  A ring slot is rewritten only steps after its last
// reader, and every cp.async a step depends on completed before the
// barrier in front of it.

// K8, one block per utterance, W chain warps and W R role warps, R =
// ROLES_K8.  Rings:
// lat_b (blank[t-1, u] of cell (t, u)) and lat_e (emit[t, u-1]), LAT
// slots each; then out (alpha), RING slots.
__global__ void __launch_bounds__(CHAIN_THREADS)
    transducer_alpha_chain_kernel(const float* __restrict__ blank,
                                  const float* __restrict__ emit,
                                  const int* __restrict__ tlen,
                                  const int* __restrict__ ulen,
                                  float* __restrict__ alpha,
                                  float* __restrict__ final_lp, int T, int U,
                                  int W, int R) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x;
  const int U1 = U + 1;
  const int tb = tlen[b], ub = ulen[b];
  const float* bl = blank + (int64_t)b * T * U1;
  const float* em = emit + (int64_t)b * T * U;
  float* al = alpha + (int64_t)b * T * U1;
  const int slot = W * 32 * DCH;
  float* lat_b = sm;
  float* lat_e = lat_b + LAT * slot;
  float* out = lat_e + LAT * slot;
  float* bnd = out + RING * slot;
  float* dummy = bnd + W * RING * DCH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool chain = warp < W;
  // the chain warp, or the one served and this role warp's share of it
  const int w = chain ? warp : (warp - W) % W, r = chain ? 0 : (warp - W) / W;
  const int ulo = w * 32, uhi = min(U1, ulo + 32);
  const int nchunk = (T + U + DCH - 1) / DCH;
  auto fill = [&](int k, bool on) {  // role: the tables of chunk k, a group
    if (on) {
      const int s = (k % LAT) * slot;
      gather(lat_b + s, dummy, bl, T, U1, 1, 0, k * DCH, ulo, uhi, lane, r, R);
      gather(lat_e + s, dummy, em, T, U, 0, 1, k * DCH, ulo, uhi, lane, r, R);
    }
    cp_commit();
  };
  if (threadIdx.x == 0 && tb == 0) final_lp[b] = 0.f;  // never harvested (JAX: 0)
  if (!chain) {
    fill(0, true);
    fill(1, nchunk > 1);
    cp_wait<0>();
  }
  __syncthreads();

  const int u = ulo + lane;  // the chain lane's column
  float a = NEG;             // alpha on the last diagonal
  float afin = 0.f;          // alpha[tb-1, ub], in the lane that holds ub
  const int dfin = tb - 1 + ub;
  float carry = NEG;         // warp w-1's edge column on the last diagonal
  for (int step = 0; step < nchunk + W; ++step) {
    if (chain) {
      const int k = step - w;
      if (k >= 0 && k < nchunk) {
        const int e0 = k * DCH;
        float b_up[DCH], e_left[DCH], bin[DCH];
        ld_col(b_up, lat_b + (k % LAT) * slot + u * DCH);
        ld_col(e_left, lat_e + (k % LAT) * slot + u * DCH);
        if (w > 0) ld_col(bin, bnd + ((w - 1) * RING + k % RING) * DCH);
        // every cell computed and every table value read (a cell off the
        // lattice, or a slot left stale, feeds no cell on it): selects
        // only, and nothing but the shuffle and the lae on the chain
#pragma unroll
        for (int j = 0; j < DCH; ++j) {
          const int d = e0 + j;
          const int t = d - u;
          const float sh = __shfl_sync(FULL_MASK, a, (lane + 31) & 31);
          const float edge = w > 0 ? (j == 0 ? carry : bin[j > 0 ? j - 1 : 0])
                                   : NEG;
          const float aleft = lane > 0 ? sh : edge;
          const float up = t == 0 ? (u == 0 ? 0.f : NEG) : a + b_up[j];
          const float left = u == 0 ? NEG : aleft + e_left[j];
          a = lae(up, left);
          b_up[j] = a;  // the chunk's alpha, in place
          afin = d == dfin && u == ub ? a : afin;
        }
        if (w > 0) carry = bin[DCH - 1];
        st_col(out + (k % RING) * slot + u * DCH, b_up);
        if (w + 1 < W && lane == 31) {
          st_col(bnd + (w * RING + k % RING) * DCH, b_up);
        }
      }
    } else {
      const int kd = step - w - 1;  // the chunk drained
      const int kg = step - w + 2;  // the chunk filled
      fill(kg, kg >= 2 && kg < nchunk);
      if (kd >= 0 && kd < nchunk) {
        const float* o = out + (kd % RING) * slot;
        chunk_rows(kd * DCH, ulo, uhi, T, lane, r, R,
                   [&](int i, int t, int uu, bool in) {
                     st_if(al + (int64_t)t * U1 + uu, o[i], in);
                   });
      }
      cp_wait<1>();  // the tables of chunk kg - 1 are in
    }
    __syncthreads();
  }
  if (chain && tb > 0 && u == ub) {
    final_lp[b] = afin + bl[(int64_t)(tb - 1) * U1 + ub];
  }
}

// K9, one block per utterance, W chain warps and W R role warps, R =
// ROLES_K9.  Rings:
// lat_b (blank[t, u]) and lat_e (emit[t, u]), LAT slots each, read by the
// chain and, for the masks, by the role warps; then alr (alpha[t, u], the
// role warps'), dn and rt (the chain's down and right sums), RING slots
// each.  Chunk k holds diagonals e0 .. e0 + DCH - 1, e0 = T + U - (k + 1)
// DCH, walked down.
__global__ void __launch_bounds__(CHAIN_THREADS)
    transducer_beta_grad_chain_kernel(const float* __restrict__ blank,
                                      const float* __restrict__ emit,
                                      const float* __restrict__ alpha,
                                      const int* __restrict__ tlen,
                                      const int* __restrict__ ulen,
                                      const float* __restrict__ logz,
                                      float* __restrict__ dblank,
                                      float* __restrict__ demit, int T, int U,
                                      int W, int R) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x;
  const int U1 = U + 1;
  const int tb = tlen[b], ub = ulen[b];
  const float z = logz[b];
  const float* bl = blank + (int64_t)b * T * U1;
  const float* em = emit + (int64_t)b * T * U;
  const float* al = alpha + (int64_t)b * T * U1;
  float* db = dblank + (int64_t)b * T * U1;
  float* de = demit + (int64_t)b * T * U;
  const int slot = W * 32 * DCH;
  float* lat_b = sm;
  float* lat_e = lat_b + LAT * slot;
  float* alr = lat_e + LAT * slot;
  float* dn = alr + RING * slot;
  float* rt = dn + RING * slot;
  float* bnd = rt + RING * slot;
  float* dummy = bnd + W * RING * DCH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool chain = warp < W;
  const int w = chain ? warp : (warp - W) % W, r = chain ? 0 : (warp - W) / W;
  const int lag = W - 1 - w;  // warp W-1 leads: beta flows leftwards
  const int ulo = w * 32, uhi = min(U1, ulo + 32);
  const int D = T + U;
  const int nchunk = (D + DCH - 1) / DCH;
  auto first = [&](int k) { return D - (k + 1) * DCH; };
  auto fill = [&](int k, bool on) {  // role: the tables of chunk k, a group
    if (on) {
      const int s = (k % LAT) * slot;
      gather(lat_b + s, dummy, bl, T, U1, 0, 0, first(k), ulo, uhi, lane, r,
             R);
      gather(lat_e + s, dummy, em, T, U, 0, 0, first(k), ulo, uhi, lane, r,
             R);
    }
    cp_commit();
  };
  auto fill_alpha = [&](int k, bool on) {  // alpha of chunk k, a group
    if (on) {
      gather(alr + (k % RING) * slot, dummy, al, T, U1, 0, 0, first(k), ulo,
             uhi, lane, r, R);
    }
    cp_commit();
  };
  if (!chain) {
    fill(0, true);
    fill(1, nchunk > 1);
    fill_alpha(0, true);
    cp_wait<0>();
  }
  __syncthreads();

  const int u = ulo + lane;  // the chain lane's column
  float be = NEG;     // beta on the diagonal below (d + 1)
  float carry = NEG;  // warp w+1's edge column on diagonal d + 1
  for (int step = 0; step < nchunk + W; ++step) {
    if (chain) {
      const int k = step - lag;
      if (k >= 0 && k < nchunk) {
        const int e0 = first(k);
        float down[DCH], right[DCH], bout[DCH], bin[DCH];
        ld_col(down, lat_b + (k % LAT) * slot + u * DCH);   // blank[t, u]
        ld_col(right, lat_e + (k % LAT) * slot + u * DCH);  // emit[t, u]
        if (w + 1 < W) ld_col(bin, bnd + ((w + 1) * RING + k % RING) * DCH);
#pragma unroll
        for (int jj = 0; jj < DCH; ++jj) {
          const int j = DCH - 1 - jj;
          const int t = e0 + j - u;
          const float sh = __shfl_sync(FULL_MASK, be, (lane + 1) & 31);
          const float edge =
              w + 1 < W ? (jj == 0 ? carry : bin[j + 1 < DCH ? j + 1 : 0])
                        : NEG;
          const float bright = lane < 31 ? sh : edge;
          // beta below the cell: the virtual row T, or diagonal d + 1
          const float below = t == T - 1 ? (u == ub ? 0.f : NEG) : be;
          // the two sums, in place of the tables (the gradients' too)
          down[j] = below + down[j];
          right[j] = u < U ? bright + right[j] : NEG;
          be = lae(down[j], right[j]);
          bout[j] = be;
        }
        if (w + 1 < W) carry = bin[0];
        st_col(dn + (k % RING) * slot + u * DCH, down);
        st_col(rt + (k % RING) * slot + u * DCH, right);
        if (w > 0 && lane == 0) st_col(bnd + (w * RING + k % RING) * DCH, bout);
      }
    } else {
      const int kd = step - lag - 1;  // the chunk drained
      fill_alpha(kd + 1, kd + 1 >= 1 && kd + 1 < nchunk);
      fill(kd + 3, kd + 3 >= 2 && kd + 3 < nchunk);
      if (kd >= 0 && kd < nchunk) {
        const int e0 = first(kd);
        const float* ak = alr + (kd % RING) * slot;
        const float* bk = lat_b + (kd % LAT) * slot;
        const float* ek = lat_e + (kd % LAT) * slot;
        const float* dk = dn + (kd % RING) * slot;
        const float* rk = rt + (kd % RING) * slot;
        // the exp of every cell, masked or not, then a select: no branch
        chunk_rows(e0, ulo, uhi, T, lane, r, R,
                   [&](int i, int t, int uu, bool in) {
          const float a = ak[i];
          const float gb = -expf(fmaxf(a + dk[i] - z, -80.f));
          const float ge = -expf(fmaxf(a + rk[i] - z, -80.f));
          st_if(db + (int64_t)t * U1 + uu,
                t < tb && bk[i] > 0.5f * NEG ? gb : 0.f, in);
          st_if(de + (int64_t)t * U + uu, ek[i] > 0.5f * NEG ? ge : 0.f,
                in && uu < U);
        });
      }
      cp_wait<1>();  // alpha of chunk kd + 1, the tables of chunk kd + 2
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------- block path

// Diagonals whose inputs a thread prefetches for each of its NC columns:
// 8 cells' worth up to 8 columns; wider lattices load each cell's inputs
// when they reach it (the prefetch registers would spill).
template <int NC>
struct Pf {
  static constexpr bool on = NC <= 8;
  static constexpr int dch = on ? 8 / NC : 1;
};

// The inputs thread u needs on diagonal d (cell t = d - u) of the
// forward: blank[t-1, u] and emit[t, u-1].
__device__ __forceinline__ void fwd_inputs(const float* __restrict__ bl,
                                           const float* __restrict__ em,
                                           int d, int u, int T, int U,
                                           bool on, float& b_up,
                                           float& e_left) {
  const int t = d - u;
  const bool cell = on && t >= 0 && t < T;
  b_up = (cell && t >= 1) ? bl[(int64_t)(t - 1) * (U + 1) + u] : 0.f;
  e_left = (cell && u >= 1) ? em[(int64_t)t * U + u - 1] : NEG;
}

// Column u = threadIdx.x + c blockDim.x is the thread's c-th column.
// diag (2, U+1) in dynamic shared memory holds the last two diagonals:
// a cell reads its upper neighbour (same column) and its left neighbour
// from the previous one.
template <int NC>
__global__ void __launch_bounds__(MAX_THREADS) transducer_alpha_kernel(
    const float* __restrict__ blank, const float* __restrict__ emit,
    const int* __restrict__ tlen, const int* __restrict__ ulen,
    float* __restrict__ alpha, float* __restrict__ final_lp, int T, int U) {
  constexpr int DCH = Pf<NC>::dch;
  extern __shared__ float diag[];
  const int b = blockIdx.x;
  const int nth = blockDim.x;
  const int U1 = U + 1;
  const int tb = tlen[b], ub = ulen[b];
  const float* bl = blank + (int64_t)b * T * U1;
  const float* em = emit + (int64_t)b * T * U;
  float* al = alpha + (int64_t)b * T * U1;
  if (threadIdx.x == 0 && tb == 0) final_lp[b] = 0.f;  // never harvested (JAX: 0)

  const int D = T + U;  // diagonals 0 .. T + U - 1
  float cb[NC][DCH], ce[NC][DCH];
  if constexpr (Pf<NC>::on) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int u = threadIdx.x + c * nth;
#pragma unroll
      for (int k = 0; k < DCH; ++k) {
        fwd_inputs(bl, em, k, u, T, U, u < U1, cb[c][k], ce[c][k]);
      }
    }
  }
  for (int d0 = 0; d0 < D; d0 += DCH) {
    float nb[NC][DCH], ne[NC][DCH];
    if constexpr (Pf<NC>::on) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int u = threadIdx.x + c * nth;
#pragma unroll
        for (int k = 0; k < DCH; ++k) {
          fwd_inputs(bl, em, d0 + DCH + k, u, T, U, u < U1, nb[c][k],
                     ne[c][k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      const int d = d0 + k;
      if (d >= D) break;  // uniform across the block
      const float* prev = diag + ((d - 1) & 1) * U1;
      float* cur = diag + (d & 1) * U1;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int u = threadIdx.x + c * nth;
        const int t = d - u;
        if (u < U1 && t >= 0 && t < T) {
          float b_up, e_left;
          if constexpr (Pf<NC>::on) {
            b_up = cb[c][k];
            e_left = ce[c][k];
          } else {
            fwd_inputs(bl, em, d, u, T, U, true, b_up, e_left);
          }
          const float up = t == 0 ? (u == 0 ? 0.f : NEG) : prev[u] + b_up;
          const float left = u == 0 ? NEG : prev[u - 1] + e_left;
          const float a = lae(up, left);
          cur[u] = a;
          al[(int64_t)t * U1 + u] = a;
          if (u == ub && t == tb - 1) final_lp[b] = a + bl[(int64_t)t * U1 + u];
        }
      }
      __syncthreads();
    }
    if constexpr (Pf<NC>::on) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int k = 0; k < DCH; ++k) {
          cb[c][k] = nb[c][k];
          ce[c][k] = ne[c][k];
        }
      }
    }
  }
}

// The inputs thread u needs on diagonal d (cell t = d - u) of the
// backward: blank, emit and alpha of the cell itself.
__device__ __forceinline__ void bwd_inputs(const float* __restrict__ bl,
                                           const float* __restrict__ em,
                                           const float* __restrict__ al,
                                           int d, int u, int T, int U,
                                           bool on, float& b_here,
                                           float& e_here, float& a_here) {
  const int t = d - u;
  const bool cell = on && t >= 0 && t < T;
  const int64_t i = (int64_t)t * (U + 1) + u;
  b_here = cell ? bl[i] : 0.f;
  e_here = (cell && u < U) ? em[(int64_t)t * U + u] : NEG;
  a_here = cell ? al[i] : NEG;
}

template <int NC>
__global__ void __launch_bounds__(MAX_THREADS) transducer_beta_grad_kernel(
    const float* __restrict__ blank, const float* __restrict__ emit,
    const float* __restrict__ alpha, const int* __restrict__ tlen,
    const int* __restrict__ ulen, const float* __restrict__ logz,
    float* __restrict__ dblank, float* __restrict__ demit, int T, int U) {
  constexpr int DCH = Pf<NC>::dch;
  extern __shared__ float diag[];
  const int b = blockIdx.x;
  const int nth = blockDim.x;
  const int U1 = U + 1;
  const int tb = tlen[b], ub = ulen[b];
  const float z = logz[b];
  const float* bl = blank + (int64_t)b * T * U1;
  const float* em = emit + (int64_t)b * T * U;
  const float* al = alpha + (int64_t)b * T * U1;
  float* db = dblank + (int64_t)b * T * U1;
  float* de = demit + (int64_t)b * T * U;

  const int D = T + U;
  float cb[NC][DCH], ce[NC][DCH], ca[NC][DCH];
  if constexpr (Pf<NC>::on) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int u = threadIdx.x + c * nth;
#pragma unroll
      for (int k = 0; k < DCH; ++k) {
        bwd_inputs(bl, em, al, D - 1 - k, u, T, U, u < U1, cb[c][k],
                   ce[c][k], ca[c][k]);
      }
    }
  }
  for (int d0 = D - 1; d0 >= 0; d0 -= DCH) {
    float nb[NC][DCH], ne[NC][DCH], na[NC][DCH];
    if constexpr (Pf<NC>::on) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int u = threadIdx.x + c * nth;
#pragma unroll
        for (int k = 0; k < DCH; ++k) {
          bwd_inputs(bl, em, al, d0 - DCH - k, u, T, U, u < U1, nb[c][k],
                     ne[c][k], na[c][k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      const int d = d0 - k;
      if (d < 0) break;  // uniform across the block
      const float* nxt = diag + ((d + 1) & 1) * U1;
      float* cur = diag + (d & 1) * U1;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int u = threadIdx.x + c * nth;
        const int t = d - u;
        if (u < U1 && t >= 0 && t < T) {
          float b_here, e_here, a_here;
          if constexpr (Pf<NC>::on) {
            b_here = cb[c][k];
            e_here = ce[c][k];
            a_here = ca[c][k];
          } else {
            bwd_inputs(bl, em, al, d, u, T, U, true, b_here, e_here, a_here);
          }
          // beta below the cell: the virtual row T, or diagonal d + 1
          const float below = t == T - 1 ? (u == ub ? 0.f : NEG) : nxt[u];
          const float down = below + b_here;
          const float right = u == U ? NEG : nxt[u + 1] + e_here;
          cur[u] = lae(down, right);
          const int64_t i = (int64_t)t * U1 + u;
          db[i] = (t < tb && b_here > 0.5f * NEG)
                      ? -expf(fmaxf(a_here + down - z, -80.f))
                      : 0.f;
          if (u < U) {
            de[(int64_t)t * U + u] =
                e_here > 0.5f * NEG ? -expf(fmaxf(a_here + right - z, -80.f))
                                    : 0.f;
          }
        }
      }
      __syncthreads();
    }
    if constexpr (Pf<NC>::on) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int k = 0; k < DCH; ++k) {
          cb[c][k] = nb[c][k];
          ce[c][k] = ne[c][k];
          ca[c][k] = na[c][k];
        }
      }
    }
  }
}

// Columns per thread (a power of two) and threads for U + 1 columns.
int cols_per_thread(int U1) {
  int nc = 1;
  while (nc * MAX_THREADS < U1) nc *= 2;
  return nc;
}

int threads_for(int U1, int nc) {
  return ((U1 + nc - 1) / nc + 31) / 32 * 32;
}

size_t diag_smem(int U1) { return 2 * (size_t)U1 * sizeof(float); }

template <typename... P, typename... A>
cudaError_t launch(void (*kern)(P...), int nc, int B, int U1, cudaStream_t s,
                   A... args) {
  const size_t smem = diag_smem(U1);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, threads_for(U1, nc), smem, s>>>(args...);
  return cudaGetLastError();
}

// Returns CALL with the compile-time NC set to the runtime nc.
#define SB_DISPATCH_NC(nc, CALL)                      \
  switch (nc) {                                       \
    case 1: { constexpr int NC = 1; return CALL; }    \
    case 2: { constexpr int NC = 2; return CALL; }    \
    case 4: { constexpr int NC = 4; return CALL; }    \
    case 8: { constexpr int NC = 8; return CALL; }    \
    case 16: { constexpr int NC = 16; return CALL; }  \
    case 32: { constexpr int NC = 32; return CALL; }  \
    default: return (int)cudaErrorInvalidValue;       \
  }

// U1 <= CHAIN_COLS columns: W = ceil(U1 / 32) chain warps of R role
// warps each, both passed to the kernel as arguments: compiled in as
// constants they make both kernels slower (ptxas schedules the loops
// otherwise; tools/transducer_chain_study.py, variant "const").
template <int R, typename... P, typename... A>
cudaError_t chain_launch(void (*kern)(P...), int U1, int B, int rings,
                         cudaStream_t s, A... args) {
  static_assert(32 * (CHAIN_COLS / 32) * (1 + R) <= CHAIN_THREADS,
                "the widest chain's warps exceed CHAIN_THREADS");
  const int W = (U1 + 31) / 32;
  const size_t smem = chain_floats(W, rings) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, 32 * W * (1 + R), smem, s>>>(args..., W, R);
  return cudaGetLastError();
}

}  // namespace

// blank (B, T, U+1) and emit (B, T, U) float32, masked; tlen, ulen (B,)
// int32 with 0 <= tlen <= T, 0 <= ulen <= U; alpha (B, T, U+1) and
// final (B,) float32, written in full.  T >= 1; U + 1 <= CHAIN_COLS takes
// the warp-chain kernel, wider the block kernel, whose 2 (U + 1) floats of shared memory must fit a
// block's 227 KB: U + 1 <= 29056.  Returns cudaGetLastError() after the
// launch.
extern "C" int sb_transducer_alpha(const void* blank, const void* emit,
                                   const void* tlen, const void* ulen,
                                   void* alpha, void* final_lp, int B, int T,
                                   int U, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (U + 1 <= CHAIN_COLS) {
    return (int)chain_launch<ROLES_K8>(
        transducer_alpha_chain_kernel, U + 1, B, 1, st, (const float*)blank,
        (const float*)emit, (const int*)tlen, (const int*)ulen, (float*)alpha,
        (float*)final_lp, T, U);
  }
  if (diag_smem(U + 1) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  SB_DISPATCH_NC(cols_per_thread(U + 1),
                 (int)launch(transducer_alpha_kernel<NC>, NC, B, U + 1, st,
                             (const float*)blank, (const float*)emit,
                             (const int*)tlen, (const int*)ulen, (float*)alpha,
                             (float*)final_lp, T, U))
}

// The backward from sb_transducer_alpha's alpha and logz = final:
// dblank (B, T, U+1) and demit (B, T, U) float32, written in full, the
// derivatives of -final[b] (the per-utterance loss) w.r.t. the tables.
// The same paths and limits.  Returns cudaGetLastError() after the
// launch.
extern "C" int sb_transducer_beta_grad(const void* blank, const void* emit,
                                       const void* alpha, const void* tlen,
                                       const void* ulen, const void* logz,
                                       void* dblank, void* demit, int B,
                                       int T, int U, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (U + 1 <= CHAIN_COLS) {
    return (int)chain_launch<ROLES_K9>(
        transducer_beta_grad_chain_kernel, U + 1, B, 3, st,
        (const float*)blank, (const float*)emit, (const float*)alpha,
        (const int*)tlen, (const int*)ulen, (const float*)logz,
        (float*)dblank, (float*)demit, T, U);
  }
  if (diag_smem(U + 1) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  SB_DISPATCH_NC(cols_per_thread(U + 1),
                 (int)launch(transducer_beta_grad_kernel<NC>, NC, B, U + 1,
                             st, (const float*)blank, (const float*)emit,
                             (const float*)alpha, (const int*)tlen,
                             (const int*)ulen, (const float*)logz,
                             (float*)dblank, (float*)demit, T, U))
}
