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
//      (q is pre-scaled), p = softmax(s), ctx[h*Dh+d] = sum_l p[l] V[.., l],
// and returns ctx (n, H*Dh) in f32.  The output cache is a different
// buffer from the input: the permutation is many-to-one, so writing in
// place would overwrite rows that other blocks still read.
//
// What bounds it on the H100: bytes.  Per step and layer it must read
// each predecessor row once and write n rows: 2 x 80 x 144 x 512 x 2 B =
// 23.6 MB in bf16 at the conformer_small shape (n = 8 x 10 beams, L = 256),
// against ~2 x n x H*Dh x pos FLOPs of attention, a few MFLOP.
//
// What the simple design does about it: one block per output row.  The
// row copy moves 16 bytes per thread per load, consecutive threads on
// consecutive addresses.  The attention reads the source row again (from
// L2, where the copy just brought it) with threads spread over time lanes,
// so the time-minor layout makes both the score pass (thread per lane,
// loop over features) and the context pass (warp per feature, lanes over
// time) coalesced.  Scores and probabilities live in shared memory
// (H x L floats).  Softmax and both reductions are f32, as in the plain
// version (gather + append_attend).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void beam_attend_step_kernel(
    const T* __restrict__ kv, const int* __restrict__ rows,
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, float* __restrict__ ctx,
    T* __restrict__ kv_out, int H, int Dh, int L, int pos) {
  extern __shared__ float smem[];
  const int HD = H * Dh;
  const int L2 = 2 * L;
  float* qs = smem;      // (HD,) query row in f32
  float* sc = smem + HD; // (H, L) scores, then probabilities
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* src = kv + (int64_t)rows[i] * HD * L2;
  T* dst = kv_out + (int64_t)i * HD * L2;
  const T* qi = q + (int64_t)i * HD;
  const T* ki = k_new + (int64_t)i * HD;
  const T* vi = v_new + (int64_t)i * HD;

  // 1. copy the predecessor row, 16 bytes per load (the wrapper checks
  //    that a row is a whole number of 16-byte words and aligned).
  const int64_t n16 = (int64_t)HD * L2 * sizeof(T) / 16;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int64_t j = tid; j < n16; j += blockDim.x) dst4[j] = src4[j];
  for (int f = tid; f < HD; f += blockDim.x) qs[f] = to_f32(qi[f]);
  __syncthreads();  // orders the copy before the column writes below

  // 2. append this step's K and V columns.
  for (int f = tid; f < HD; f += blockDim.x) {
    dst[(int64_t)f * L2 + pos] = ki[f];
    dst[(int64_t)f * L2 + L + pos] = vi[f];
  }

  // 3. scores over lanes l <= pos, one lane per thread.
  for (int l = tid; l <= pos; l += blockDim.x) {
    for (int h = 0; h < H; ++h) {
      float acc = 0.f;
      for (int d = 0; d < Dh; ++d) {
        const int f = h * Dh + d;
        const float kval =
            (l == pos) ? to_f32(ki[f]) : to_f32(src[(int64_t)f * L2 + l]);
        acc += qs[f] * kval;
      }
      sc[h * L + l] = acc;
    }
  }
  __syncthreads();

  // 4. softmax per head, one warp per head.
  for (int h = warp; h < H; h += nwarps) {
    float* s = sc + h * L;
    float m = -INFINITY;
    for (int l = lane; l <= pos; l += 32) m = fmaxf(m, s[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l <= pos; l += 32) {
      const float e = expf(s[l] - m);
      s[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int l = lane; l <= pos; l += 32) s[l] = s[l] / sum;
  }
  __syncthreads();

  // 5. context, one warp per feature, lanes over time.
  for (int f = warp; f < HD; f += nwarps) {
    const float* p = sc + (f / Dh) * L;
    const T* vrow = src + (int64_t)f * L2 + L;
    float acc = 0.f;
    for (int l = lane; l <= pos; l += 32) {
      const float vval = (l == pos) ? to_f32(vi[f]) : to_f32(vrow[l]);
      acc += p[l] * vval;
    }
    acc = warp_sum(acc);
    if (lane == 0) ctx[(int64_t)i * HD + f] = acc;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (kv, q, k_new, v_new, kv_out).
// rows: int32 (n,).  Returns cudaGetLastError() after the launch.
extern "C" int sb_beam_attend_step(const void* kv, const void* rows,
                                   const void* q, const void* k_new,
                                   const void* v_new, void* ctx, void* kv_out,
                                   int n, int H, int Dh, int L, int pos,
                                   int dtype, void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)(H * Dh + H * L) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    beam_attend_step_kernel<float><<<n, threads, smem, s>>>(
        (const float*)kv, (const int*)rows, (const float*)q,
        (const float*)k_new, (const float*)v_new, (float*)ctx,
        (float*)kv_out, H, Dh, L, pos);
  } else if (dtype == 1) {
    beam_attend_step_kernel<__nv_bfloat16><<<n, threads, smem, s>>>(
        (const __nv_bfloat16*)kv, (const int*)rows,
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new,
        (const __nv_bfloat16*)v_new, (float*)ctx, (__nv_bfloat16*)kv_out, H,
        Dh, L, pos);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
