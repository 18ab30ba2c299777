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
// clamps and form, so that impossible states take the same values.
//
// Design.  The TPU walks t through its sequential grid and solves each
// row's u-recurrence as a Hillis-Steele prefix scan over 128 lanes.  Here
// the lattice is walked along its anti-diagonals d = t + u instead: every
// cell of a diagonal depends only on the previous diagonal (its upper
// neighbour alpha[t-1, u] and its left neighbour alpha[t, u-1] both lie on
// d - 1), so no scan is needed and each cell is the recurrence itself,
// computed once.  One block per utterance, one thread per column u
// (U+1 <= 1024): thread u owns column u, keeps its own previous cell in a
// register and reads its left neighbour from the previous diagonal,
// double-buffered in shared memory; one barrier per diagonal, T + U
// diagonals.  The backward walks the diagonals in reverse and writes both
// gradients of each cell as soon as its beta is known (beta itself never
// goes to global memory).  Each thread prefetches the table values of its
// next DCH cells into registers while it works through the current DCH,
// so the loads stay off the chain.
//
// What bounds it on the H100.  The bytes: blank, emit in and alpha out,
// 12 B per cell (2.35 MB at B 12, T 251, U+1 65: 0.7 us at 3.35 TB/s);
// the backward reads blank, emit and alpha and writes the two gradients,
// 20 B per cell (1.2 us).  The chain of T + U dependent diagonals, each a
// barrier and a log-add-exp, stands far above either; the first design
// makes no attempt to shorten it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr int MAX_COLS = 1024;  // U + 1, one thread each
constexpr int DCH = 8;          // diagonals whose inputs are prefetched

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG);
  return m + logf(expf(fmaxf(a - m, -80.f)) + expf(fmaxf(b - m, -80.f)));
}

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

// Both kernels take up to 1024 threads a block: at most 64 registers a
// thread.
__global__ void __launch_bounds__(MAX_COLS) transducer_alpha_kernel(
    const float* __restrict__ blank, const float* __restrict__ emit,
    const int* __restrict__ tlen, const int* __restrict__ ulen,
    float* __restrict__ alpha, float* __restrict__ final_lp, int T, int U) {
  __shared__ float diag[2][MAX_COLS];
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const int U1 = U + 1;
  const bool on = u < U1;
  const int tb = tlen[b], ub = ulen[b];
  const float* bl = blank + (int64_t)b * T * U1;
  const float* em = emit + (int64_t)b * T * U;
  float* al = alpha + (int64_t)b * T * U1;
  if (u == 0 && tb == 0) final_lp[b] = 0.f;  // never harvested (JAX: 0)

  const int D = T + U;  // diagonals 0 .. T + U - 1
  float a = NEG;        // alpha at this column's last cell
  float cb[DCH], ce[DCH];
#pragma unroll
  for (int k = 0; k < DCH; ++k) fwd_inputs(bl, em, k, u, T, U, on, cb[k], ce[k]);
  for (int d0 = 0; d0 < D; d0 += DCH) {
    float nb[DCH], ne[DCH];
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      fwd_inputs(bl, em, d0 + DCH + k, u, T, U, on, nb[k], ne[k]);
    }
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      const int d = d0 + k;
      if (d >= D) break;  // uniform across the block
      const int t = d - u;
      if (on && t >= 0 && t < T) {
        const float up = t == 0 ? (u == 0 ? 0.f : NEG) : a + cb[k];
        const float left = u == 0 ? NEG : diag[(d - 1) & 1][u - 1] + ce[k];
        a = lae(up, left);
        diag[d & 1][u] = a;
        al[(int64_t)t * U1 + u] = a;
        if (u == ub && t == tb - 1) final_lp[b] = a + bl[(int64_t)t * U1 + u];
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      cb[k] = nb[k];
      ce[k] = ne[k];
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

__global__ void __launch_bounds__(MAX_COLS) transducer_beta_grad_kernel(
    const float* __restrict__ blank, const float* __restrict__ emit,
    const float* __restrict__ alpha, const int* __restrict__ tlen,
    const int* __restrict__ ulen, const float* __restrict__ logz,
    float* __restrict__ dblank, float* __restrict__ demit, int T, int U) {
  __shared__ float diag[2][MAX_COLS];
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const int U1 = U + 1;
  const bool on = u < U1;
  const int tb = tlen[b], ub = ulen[b];
  const float z = logz[b];
  const float* bl = blank + (int64_t)b * T * U1;
  const float* em = emit + (int64_t)b * T * U;
  const float* al = alpha + (int64_t)b * T * U1;
  float* db = dblank + (int64_t)b * T * U1;
  float* de = demit + (int64_t)b * T * U;

  const int D = T + U;
  float be = u == ub ? 0.f : NEG;  // beta below this column's cell: row T
  float cb[DCH], ce[DCH], ca[DCH];
#pragma unroll
  for (int k = 0; k < DCH; ++k) {
    bwd_inputs(bl, em, al, D - 1 - k, u, T, U, on, cb[k], ce[k], ca[k]);
  }
  for (int d0 = D - 1; d0 >= 0; d0 -= DCH) {
    float nb[DCH], ne[DCH], na[DCH];
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      bwd_inputs(bl, em, al, d0 - DCH - k, u, T, U, on, nb[k], ne[k], na[k]);
    }
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      const int d = d0 - k;
      if (d < 0) break;  // uniform across the block
      const int t = d - u;
      if (on && t >= 0 && t < T) {
        const float down = be + cb[k];
        const float right = u == U ? NEG : diag[(d + 1) & 1][u + 1] + ce[k];
        be = lae(down, right);
        diag[d & 1][u] = be;
        const int64_t i = (int64_t)t * U1 + u;
        db[i] = (t < tb && cb[k] > 0.5f * NEG)
                    ? -expf(fmaxf(ca[k] + down - z, -80.f))
                    : 0.f;
        if (u < U) {
          de[(int64_t)t * U + u] =
              ce[k] > 0.5f * NEG ? -expf(fmaxf(ca[k] + right - z, -80.f))
                                 : 0.f;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      cb[k] = nb[k];
      ce[k] = ne[k];
      ca[k] = na[k];
    }
  }
}

int threads_for(int U1) { return (U1 + 31) / 32 * 32; }

}  // namespace

// blank (B, T, U+1) and emit (B, T, U) float32, masked; tlen, ulen (B,)
// int32 with 0 <= tlen <= T, 0 <= ulen <= U; alpha (B, T, U+1) and
// final (B,) float32, written in full.  U + 1 <= 1024, T >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int sb_transducer_alpha(const void* blank, const void* emit,
                                   const void* tlen, const void* ulen,
                                   void* alpha, void* final_lp, int B, int T,
                                   int U, void* stream) {
  if (B == 0) return 0;
  if (U + 1 > MAX_COLS || T < 1 || U < 0) return (int)cudaErrorInvalidValue;
  transducer_alpha_kernel<<<B, threads_for(U + 1), 0,
                            (cudaStream_t)stream>>>(
      (const float*)blank, (const float*)emit, (const int*)tlen,
      (const int*)ulen, (float*)alpha, (float*)final_lp, T, U);
  return (int)cudaGetLastError();
}

// The backward from sb_transducer_alpha's alpha and logz = final:
// dblank (B, T, U+1) and demit (B, T, U) float32, written in full, the
// derivatives of -final[b] (the per-utterance loss) w.r.t. the tables.
// Returns cudaGetLastError() after the launch.
extern "C" int sb_transducer_beta_grad(const void* blank, const void* emit,
                                       const void* alpha, const void* tlen,
                                       const void* ulen, const void* logz,
                                       void* dblank, void* demit, int B,
                                       int T, int U, void* stream) {
  if (B == 0) return 0;
  if (U + 1 > MAX_COLS || T < 1 || U < 0) return (int)cudaErrorInvalidValue;
  transducer_beta_grad_kernel<<<B, threads_for(U + 1), 0,
                                (cudaStream_t)stream>>>(
      (const float*)blank, (const float*)emit, (const float*)alpha,
      (const int*)tlen, (const int*)ulen, (const float*)logz,
      (float*)dblank, (float*)demit, T, U);
  return (int)cudaGetLastError();
}
