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
// computed once.  One block per utterance; each of its threads (at most
// 1024) owns NC = 1, 2, 4, ... 32 columns, u = thread + c blockDim, the
// fewest that cover U+1.  The last two diagonals are double-buffered in
// dynamic shared memory, 2 (U+1) floats: a cell reads its upper neighbour
// (its own column) and its left neighbour there; one barrier per
// diagonal, T + U diagonals, whatever NC.  The only width limit left is
// that buffer: U+1 <= 29056 in a block's 227 KB.  The backward walks the
// diagonals in reverse and writes both gradients of each cell as soon as
// its beta is known (beta itself never goes to global memory).  Up to 8
// columns a thread, each thread prefetches the table values of its next
// 8 / NC diagonals into registers while it works through the current
// ones, so the loads stay off the chain; wider lattices load them when
// they reach them.
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
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG);
  return m + logf(expf(fmaxf(a - m, -80.f)) + expf(fmaxf(b - m, -80.f)));
}

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

constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory of a block

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

}  // namespace

// blank (B, T, U+1) and emit (B, T, U) float32, masked; tlen, ulen (B,)
// int32 with 0 <= tlen <= T, 0 <= ulen <= U; alpha (B, T, U+1) and
// final (B,) float32, written in full.  T >= 1 and 2 (U + 1) floats of
// shared memory within a block's 227 KB: U + 1 <= 29056.  Returns
// cudaGetLastError() after the launch.
extern "C" int sb_transducer_alpha(const void* blank, const void* emit,
                                   const void* tlen, const void* ulen,
                                   void* alpha, void* final_lp, int B, int T,
                                   int U, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U < 0 || diag_smem(U + 1) > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  SB_DISPATCH_NC(cols_per_thread(U + 1),
                 (int)launch(transducer_alpha_kernel<NC>, NC, B, U + 1,
                             (cudaStream_t)stream, (const float*)blank,
                             (const float*)emit, (const int*)tlen,
                             (const int*)ulen, (float*)alpha,
                             (float*)final_lp, T, U))
}

// The backward from sb_transducer_alpha's alpha and logz = final:
// dblank (B, T, U+1) and demit (B, T, U) float32, written in full, the
// derivatives of -final[b] (the per-utterance loss) w.r.t. the tables.
// The same limits.  Returns cudaGetLastError() after the launch.
extern "C" int sb_transducer_beta_grad(const void* blank, const void* emit,
                                       const void* alpha, const void* tlen,
                                       const void* ulen, const void* logz,
                                       void* dblank, void* demit, int B,
                                       int T, int U, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U < 0 || diag_smem(U + 1) > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  SB_DISPATCH_NC(cols_per_thread(U + 1),
                 (int)launch(transducer_beta_grad_kernel<NC>, NC, B, U + 1,
                             (cudaStream_t)stream, (const float*)blank,
                             (const float*)emit, (const float*)alpha,
                             (const int*)tlen, (const int*)ulen,
                             (const float*)logz, (float*)dblank,
                             (float*)demit, T, U))
}
