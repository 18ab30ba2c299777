// Tensor-core pieces shared by the rel-pos attention kernels, the forward
// (relpos_attention.cu) and the backward (relpos_attention_bwd.cu):
// operand row strides, mma.sync fragments loaded with ldmatrix (bf16
// m16n8k16 and 3xTF32 m16n8k8), one warp's tile product, and the staging
// of q, k, v and band rows into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace relpos {

using bf16 = __nv_bfloat16;

constexpr int PB_N = 80;   // band columns one warp's 16 query rows reach
constexpr int LD_PB = 84;  // f32 row stride of a warp's staged PB
constexpr float NEG = -1e9f;

// The MMA depth of an operand type and the shared row stride (elements)
// of a W-column operand.  bf16 rows are read by ldmatrix in 16-byte
// pieces: an odd number of pieces per row puts the eight rows of one 8x8
// matrix in eight bank groups.  f32 rows are read one word per lane, row
// g = lane / 4 and column t = lane % 4 (+ 4): a stride of 4 (mod 8) words
// spreads the 32 lanes over the 32 banks.
template <typename E>
struct Op;
template <>
struct Op<bf16> {
  static constexpr int KS = 16;
  static constexpr int ld(int W) { return (W / 8) % 2 ? W : W + 8; }
};
template <>
struct Op<float> {
  static constexpr int KS = 8;
  static constexpr int ld(int W) { return W + 4; }
};

// The stride of a tile that is only read transposed (P keep/(1-rate), as
// A of dV): bf16 as above; f32 words at rows t and columns g, so a stride
// of 8 (mod 32) words spreads the lanes over the banks.
template <typename E>
constexpr int ld_t(int W) {
  return std::is_same<E, bf16>::value ? Op<E>::ld(W) : W + 8;
}

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ fragments

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both TF32 (round to nearest).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// One warp: acc (16 x 8 NT) += A (16 x [kb, ke)) B ([kb, ke) x 8 NT).
// A is stored (m, k), element A[m * lda + k], or (k, m) when A_T; B is
// stored (n, k), element B[n * ldb + k], or (k, n) when B_T.  m0 is A's
// first row, n0 B's first column.  The accumulator fragment holds rows
// lane/4 and lane/4 + 8, columns 2 (lane%4) + {0, 1} of each 8-column tile.
// STEP_SUM (TF32 only): each k-step's three products go into a zeroed
// fragment that is then added to acc on the CUDA cores, rounding to
// nearest; otherwise they accumulate into acc through the tensor core,
// whose f32 additions do not round to nearest, so that over many k-steps
// the sums drift by a few f32 ulps one way (enough to flip a ReLU
// downstream of the forward; the backward keeps the direct form).
template <typename E, bool A_T, bool B_T, int NT, bool STEP_SUM = false>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const E* __restrict__ A, int lda,
                                         int m0, const E* __restrict__ B,
                                         int ldb, int n0, int kb, int ke) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<E, bf16>::value) {
    static_assert(NT % 2 == 0, "ldmatrix loads B two tiles at a time");
    const int r8 = lane & 7, j1 = (lane >> 3) & 1, j2 = lane >> 4;
    for (int k = kb; k < ke; k += 16) {
      unsigned a[4];
      if constexpr (A_T) {
        ldsm_t(a, A + (k + r8 + 8 * j2) * lda + m0 + 8 * j1);
      } else {
        ldsm(a, A + (m0 + r8 + 8 * j1) * lda + k + 8 * j2);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        const int n = n0 + 8 * nt;
        unsigned b[4];
        if constexpr (B_T) {
          ldsm_t(b, B + (k + r8 + 8 * j1) * ldb + n + 8 * j2);
        } else {
          ldsm(b, B + (n + r8 + 8 * j2) * ldb + k + 8 * j1);
        }
        mma_bf16(acc[nt], a, b[0], b[1]);
        mma_bf16(acc[nt + 1], a, b[2], b[3]);
      }
    }
  } else {
    // TF32: an 8x8 matrix of 16-bit pairs is 8 rows of 4 floats, so
    // ldmatrix (without .trans) loads the fragments of operands stored
    // with k contiguous; the transposed ones are read one word a lane
    const int g = lane >> 2, t = lane & 3;
    const int r8 = lane & 7, j1 = (lane >> 3) & 1, j2 = lane >> 4;
    for (int k = kb; k < ke; k += 8) {
      float af[4];
      if constexpr (A_T) {
        af[0] = A[(k + t) * lda + m0 + g];
        af[1] = A[(k + t) * lda + m0 + g + 8];
        af[2] = A[(k + t + 4) * lda + m0 + g];
        af[3] = A[(k + t + 4) * lda + m0 + g + 8];
      } else {
        unsigned r[4];
        ldsm(r, A + (m0 + r8 + 8 * j1) * lda + k + 4 * j2);
#pragma unroll
        for (int x = 0; x < 4; ++x) af[x] = __uint_as_float(r[x]);
      }
      unsigned ah[4], al[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) split_tf32(af[x], ah[x], al[x]);
#pragma unroll
      for (int nt = 0; nt < NT; nt += (B_T ? 1 : 2)) {
        float bf[4];
        if constexpr (B_T) {
          const int n = n0 + 8 * nt + g;
          bf[0] = B[(k + t) * ldb + n];
          bf[1] = B[(k + t + 4) * ldb + n];
        } else {
          static_assert(NT % 2 == 0, "ldmatrix loads B two tiles at a time");
          unsigned r[4];
          ldsm(r, B + (n0 + 8 * nt + r8 + 8 * j2) * ldb + k + 4 * j1);
#pragma unroll
          for (int x = 0; x < 4; ++x) bf[x] = __uint_as_float(r[x]);
        }
#pragma unroll
        for (int e = 0; e < (B_T ? 1 : 2); ++e) {
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(bf[2 * e], bh0, bl0);
          split_tf32(bf[2 * e + 1], bh1, bl1);
          if constexpr (STEP_SUM) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, al, bh0, bh1);  // the small terms first
            mma_tf32(d, ah, bl0, bl1);
            mma_tf32(d, ah, bh0, bh1);
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[nt + e][x] += d[x];
          } else {
            mma_tf32(acc[nt + e], al, bh0, bh1);  // the small terms first
            mma_tf32(acc[nt + e], ah, bl0, bl1);
            mma_tf32(acc[nt + e], ah, bh0, bh1);
          }
        }
      }
    }
  }
}


// --------------------------------------------------------------- staging

// Four consecutive elements as floats, and back in the operand type.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned*>(&a);
  w.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}
__device__ __forceinline__ float4 add4(float4 x, const float* __restrict__ a) {
  return make_float4(x.x + a[0], x.y + a[1], x.z + a[2], x.w + a[3]);
}

// A tile of N rows, DH wide, read four elements (16 or 8 bytes) a thread
// of the block's NT and step: load() issues all of the thread's global reads into
// registers, store() writes them to shared rows of stride LD, plus a
// bias row when one is given.  Loading several tiles before storing any
// puts all their reads in flight at once.  Row r is src + row(r) DH.
// The padded columns are left as they are.
template <int N, int DH, int NT>
struct Tile {
  static_assert(DH % 4 == 0, "rows are read four elements at a time");
  static constexpr int CH = N * DH / 4, IT = (CH + NT - 1) / NT;
  float4 x[IT];

  template <typename S, typename Row>
  __device__ __forceinline__ void load(const S* __restrict__ src, Row row) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int c = threadIdx.x + it * NT;
      if (c < CH) {
        const int r = 4 * c / DH, d = 4 * c - r * DH;
        x[it] = load4(src + (int64_t)row(r) * DH + d);
      }
    }
  }

  template <int LD, typename E>
  __device__ __forceinline__ void store(E* __restrict__ dst,
                                        const float* __restrict__ add) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int c = threadIdx.x + it * NT;
      if (c < CH) {
        const int r = 4 * c / DH, d = 4 * c - r * DH;
        store4(dst + r * LD + d, add != nullptr ? add4(x[it], add + d) : x[it]);
      }
    }
  }
};

// f32 tiles prefetched by cp.async (16 bytes a copy), unpacked in shared
// memory when the pair that reads them starts.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(dst)), "l"(src));
}

// Rows 0 .. N-1 (row r is src + row(r) DH) to dst rows of DH floats.
template <int N, int DH, int NT, typename Row>
__device__ __forceinline__ void copy_async(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           Row row) {
  for (int c = threadIdx.x; c < N * DH / 4; c += NT) {
    const int r = 4 * c / DH, d = 4 * c - r * DH;
    cp_async16(dst + 4 * c, src + (int64_t)row(r) * DH + d);
  }
}

// Landed rows (DH wide) + add into shared rows of stride LD.
template <int N, int DH, int LD, int NT>
__device__ __forceinline__ void unpack(float* __restrict__ dst,
                                       const float* __restrict__ src,
                                       const float* __restrict__ add) {
  for (int c = threadIdx.x; c < N * DH / 4; c += NT) {
    const int r = 4 * c / DH, d = 4 * c - r * DH;
    const float4 x = *reinterpret_cast<const float4*>(src + 4 * c);
    store4(dst + r * LD + d, add != nullptr ? add4(x, add + d) : x);
  }
}

struct Rows {  // row r of a contiguous tile starting at row r0
  int r0;
  __device__ int operator()(int r) const { return r0 + r; }
};
struct BandRows {  // band row c is p[clip(band0 + c)]
  int band0, last;
  __device__ int operator()(int c) const {
    return min(max(band0 + c, 0), last);
  }
};

}  // namespace relpos
