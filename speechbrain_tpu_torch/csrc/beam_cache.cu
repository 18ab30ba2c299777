// Fused beam-search self-cache step: permute + append + causal attend.
//
// Replaces: the Pallas TPU kernel speechbrain_tpu/ops/pallas/beam_cache.py
//   (_kernel / _pallas_call, reached through beam_attend_step).
//
// The cache is the merged time-minor K|V layout (n, H*Dh, 2L): K of
// feature f at time l sits at [f, l], its V at [f, L + l].  For every
// output row i the kernel
//   1. copies cache row rows[i] into output row i,
//   2. writes the new K at lane pos and the new V at lane L + pos,
//   3. computes per head h: s[l] = sum_d q[h,d] * K[h*Dh+d, l] for l <= pos
//      (q is pre-scaled), p = softmax(s) in f32, rounded to the cache's
//      dtype (where JAX's Pallas kernel rounds it; exact in f32), and
//      ctx[h*Dh+d] = sum_l p[l] V[.., l] in f32,
// and returns ctx (n, H*Dh) in f32.  The output cache is a different
// buffer from the input: the permutation is many-to-one, so writing in
// place would overwrite rows that other blocks still read.
//
// What bounds it on the H100: bytes.  Each source row is read once and
// each output row written once: at the conformer_small serving shape
// (80 rows from 36 sources, H*Dh = 144, L = 256) 116 x 295 KB = 34 MB in
// f32, 10.2 us at 3.35 TB/s, against a few MFLOP of attention.
//
// What the design does about it: one block per (output row, head), 320
// blocks at the serving shape where one block per row gave 80 for 132
// SMs.  Head h's slice of a row, features [h*Dh, (h+1)*Dh), is one
// contiguous Dh x 2L block.  The block streams it through a
// double-buffered shared tile (up to 128 lanes by the rows that fit in
// 24 KB) with cp.async, 16 bytes a copy (8 where L's bytes are not a
// multiple of 16), so that the next tile's loads are in flight while
// this one is used.  Each tile is read from device memory once: the new
// column is put into the staged tile, the tile is written to the output
// row, and the attention reads it from shared memory.  K tiles: one
// thread per lane sums q[d] K[d, l] over the tile's rows, with no branch
// per load; lanes > pos are copied and never scored.  The scores (L
// floats) stay in shared memory; the softmax is a block reduction in
// f32.  V tiles: a warp per feature, lanes over time, each tile's sum
// reduced by shuffles and added in tile order.  Every sum has a fixed
// order and there are no atomics: the same bits on every call.  q, k_new
// and v_new are read with a row stride (the decoder's qkv.chunk views)
// and rows as int32 or int64, so the decoder's call is one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;               // threads a block
constexpr int LT_MAX = 128;           // lanes a tile
constexpr int TILE_BYTES = 24 * 1024;  // one stage of the tile ring
constexpr int STAGES = 2;              // tiles in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max or sum of v (every thread gets it); red: 32 floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_ring() {  // all but the newest STAGES-1
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
}

template <int VB>
struct Vec;
template <>
struct Vec<16> {
  using V = uint4;
};
template <>
struct Vec<8> {
  using V = uint2;
};

template <typename T>
struct Args {
  const T* kv;
  const void* rows;
  const T* q;
  const T* k_new;
  const T* v_new;
  float* ctx;
  T* out;
  int64_t q_stride, k_stride, v_stride;  // row strides, in elements
  int rows64, H, Dh, L, pos;
  int LT, DR, NR, NJ;  // tile lanes and rows; row chunks; lane tiles a half
};

// Tile t of a block's slice: the K half goes lane tiles outer, row chunks
// inner (a lane's score sums over every row before the next lane tile);
// the V half row chunks outer (a feature's context is complete at the end
// of its chunk).
struct TileGeom {
  int part, r, j, d0, nd, l0, nl;
};

template <typename T>
__device__ __forceinline__ TileGeom tile_geom(const Args<T>& a, int t) {
  TileGeom g;
  const int nk = a.NJ * a.NR;
  g.part = t >= nk;
  if (!g.part) {
    g.j = t / a.NR;
    g.r = t - g.j * a.NR;
  } else {
    g.r = (t - nk) / a.NJ;
    g.j = t - nk - g.r * a.NJ;
  }
  g.d0 = g.r * a.DR;
  g.nd = min(a.DR, a.Dh - g.d0);
  g.l0 = g.j * a.LT;
  g.nl = min(a.LT, a.L - g.l0);
  return g;
}

// Issue the cp.async copies of tile t into stage buffer st.
template <typename T, int VB>
__device__ __forceinline__ void issue_tile(const Args<T>& a, const T* src,
                                           T* st, int t) {
  const TileGeom g = tile_geom(a, t);
  const int cpr = g.nl * (int)sizeof(T) / VB;  // copies a row
  const int64_t L2 = 2 * (int64_t)a.L;
  for (int c = threadIdx.x; c < g.nd * cpr; c += NT) {
    const int d = c / cpr, k = c - d * cpr;
    const T* gp = src + (g.d0 + d) * L2 + g.part * a.L + g.l0;
    cp_async<VB>(reinterpret_cast<char*>(st + d * a.LT) + k * VB,
                 reinterpret_cast<const char*>(gp) + k * VB);
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(NT)
    beam_attend_step_kernel(const Args<T> a) {
  using V = typename Vec<VB>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_elems = a.DR * a.LT;
  T* stages = reinterpret_cast<T*>(smem);  // STAGES x (DR, LT)
  float* sc = reinterpret_cast<float*>(
      smem + ((STAGES * stage_elems * sizeof(T) + 15) & ~(size_t)15));  // (L,)
  float* q_s = sc + a.L;      // (DR,) this tile's q rows
  float* ctx_s = q_s + a.DR;  // (DR,) context of the chunk, by feature
  float* red = ctx_s + a.DR;  // (32,)
  const int i = blockIdx.x / a.H;
  const int h = blockIdx.x - i * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HD = a.H * a.Dh;
  const int64_t L2 = 2 * (int64_t)a.L;
  const int64_t srow = a.rows64 ? reinterpret_cast<const int64_t*>(a.rows)[i]
                                : reinterpret_cast<const int*>(a.rows)[i];
  const T* src = a.kv + (srow * HD + (int64_t)h * a.Dh) * L2;
  T* dst = a.out + ((int64_t)i * HD + (int64_t)h * a.Dh) * L2;
  const T* qi = a.q + i * a.q_stride + h * a.Dh;
  const T* ki = a.k_new + i * a.k_stride + h * a.Dh;
  const T* vi = a.v_new + i * a.v_stride + h * a.Dh;
  const int pos = a.pos;
  const int n_tiles = 2 * a.NJ * a.NR;
  const int nk = a.NJ * a.NR;

  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) issue_tile<T, VB>(a, src, stages + t * stage_elems, t);
    cp_commit();
  }

  float sacc = 0.f;  // this thread's lane score, summed over row chunks
  for (int t = 0; t < n_tiles; ++t) {
    // tile t + STAGES - 1 goes into the stage that tile t - 1 left
    {
      const int tn = t + STAGES - 1;
      if (tn < n_tiles) issue_tile<T, VB>(a, src, stages + (tn % STAGES) * stage_elems, tn);
      cp_commit();
    }
    T* st = stages + (t % STAGES) * stage_elems;
    const TileGeom g = tile_geom(a, t);
    cp_wait_ring();
    __syncthreads();
    // the new column, where it falls in this tile; this tile's q rows
    if (pos >= g.l0 && pos < g.l0 + g.nl) {
      const T* col = g.part ? vi : ki;
      for (int d = tid; d < g.nd; d += NT) st[d * a.LT + pos - g.l0] = col[g.d0 + d];
    }
    if (!g.part) {
      for (int d = tid; d < g.nd; d += NT) q_s[d] = to_f32(qi[g.d0 + d]);
    }
    __syncthreads();
    // the tile, new column included, to the output row
    {
      const int cpr = g.nl * (int)sizeof(T) / VB;
      for (int c = tid; c < g.nd * cpr; c += NT) {
        const int d = c / cpr, k = c - d * cpr;
        T* gp = dst + (g.d0 + d) * L2 + g.part * a.L + g.l0;
        reinterpret_cast<V*>(gp)[k] = reinterpret_cast<const V*>(st + d * a.LT)[k];
      }
    }
    if (!g.part) {
      // scores: a thread per lane, rows in order
      const int l = g.l0 + tid;
      if (tid < g.nl && l <= pos) {
        float s = sacc;
        for (int d = 0; d < g.nd; ++d) s = fmaf(q_s[d], to_f32(st[d * a.LT + tid]), s);
        if (g.r == a.NR - 1) {
          sc[l] = s;
          s = 0.f;
        }
        sacc = s;
      }
      if (t == nk - 1) {
        // softmax over lanes 0..pos, f32; p rounded to the cache dtype
        __syncthreads();
        float m = -INFINITY;
        for (int l2 = tid; l2 <= pos; l2 += NT) m = fmaxf(m, sc[l2]);
        m = block_reduce<true>(m, red);
        float sum = 0.f;
        for (int l2 = tid; l2 <= pos; l2 += NT) {
          const float e = expf(sc[l2] - m);
          sc[l2] = e;
          sum += e;
        }
        sum = block_reduce<false>(sum, red);
        for (int l2 = tid; l2 <= pos; l2 += NT) sc[l2] = round_to(sc[l2] / sum, T());
      }
    } else {
      // context: a warp per feature, lanes over time; each tile's sum is
      // reduced by shuffles and added in tile order
      const int nl = min(g.nl, pos - g.l0 + 1);  // lanes <= pos
      for (int d = warp; d < g.nd; d += NT / 32) {
        float part = 0.f;
        for (int l = lane; l < nl; l += 32)
          part = fmaf(sc[g.l0 + l], to_f32(st[d * a.LT + l]), part);
        part = warp_sum(part);
        if (lane == 0) {
          const float c = (g.j == 0 ? 0.f : ctx_s[d]) + part;
          if (g.j == a.NJ - 1) {
            a.ctx[(int64_t)i * HD + h * a.Dh + g.d0 + d] = c;
          } else {
            ctx_s[d] = c;
          }
        }
      }
    }
    __syncthreads();  // the stage is read: it may be refilled
  }
}

template <typename T>
int launch(const void* kv, const void* rows, int rows64, const void* q,
           int64_t q_stride, const void* k_new, int64_t k_stride,
           const void* v_new, int64_t v_stride, void* ctx, void* out, int n,
           int H, int Dh, int L, int pos, cudaStream_t s) {
  const int es = (int)sizeof(T);
  Args<T> a;
  a.kv = (const T*)kv;
  a.rows = rows;
  a.q = (const T*)q;
  a.k_new = (const T*)k_new;
  a.v_new = (const T*)v_new;
  a.ctx = (float*)ctx;
  a.out = (T*)out;
  a.q_stride = q_stride;
  a.k_stride = k_stride;
  a.v_stride = v_stride;
  a.rows64 = rows64;
  a.H = H;
  a.Dh = Dh;
  a.L = L;
  a.pos = pos;
  a.LT = min(LT_MAX, L);
  const int dr_max = max(1, TILE_BYTES / (a.LT * es));
  a.NR = (Dh + dr_max - 1) / dr_max;
  a.DR = (Dh + a.NR - 1) / a.NR;
  a.NJ = (L + a.LT - 1) / a.LT;
  const size_t stage_bytes = ((size_t)STAGES * a.DR * a.LT * es + 15) & ~(size_t)15;
  const size_t smem = stage_bytes + sizeof(float) * ((size_t)L + 2 * a.DR + 32);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // 16-byte copies where a half row (L elements) is whole 16-byte words
  // (the wrapper checks that 2L elements are); 8-byte copies otherwise
  const bool v16 = (L * es) % 16 == 0;
  auto kern = v16 ? beam_attend_step_kernel<T, 16> : beam_attend_step_kernel<T, 8>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)n * H, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (kv, q, k_new, v_new, kv_out).
// rows: (n,) int32 (rows64 = 0) or int64 (rows64 = 1).  q, k_new and
// v_new are (n, H*Dh) with unit feature stride and the given row strides
// (elements).  kv and kv_out are contiguous, 16-byte aligned, 2L
// elements a whole number of 16-byte words.  Returns cudaGetLastError()
// after the launch.
extern "C" int sb_beam_attend_step(const void* kv, const void* rows,
                                   int rows64, const void* q,
                                   long long q_stride, const void* k_new,
                                   long long k_stride, const void* v_new,
                                   long long v_stride, void* ctx,
                                   void* kv_out, int n, int H, int Dh, int L,
                                   int pos, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  if (H < 1 || Dh < 1 || L < 1 || pos < 0 || pos >= L)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch<float>(kv, rows, rows64, q, q_stride, k_new, k_stride,
                         v_new, v_stride, ctx, kv_out, n, H, Dh, L, pos, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(kv, rows, rows64, q, q_stride, k_new,
                                 k_stride, v_new, v_stride, ctx, kv_out, n,
                                 H, Dh, L, pos, s);
  }
  return (int)cudaErrorInvalidValue;
}
