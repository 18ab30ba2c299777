// The attention-dropout mask of the rel-pos kernels, shared by the
// forward (relpos_attention.cu) and the backward (relpos_attention_bwd.cu).
//
// keep is a pure function of (seed, b, h, q, k): Philox4x32-10 (Salmon
// et al., SC'11) with key (seed & 0xffffffff, seed >> 32) and counter
// (k >> 2, q, b H + h, 0); output word k & 3 belongs to key k, which is
// kept iff that word >= thresh = min(2^32 - 1, floor(rate 2^32)).  The
// plain version is relpos_dropout_keep in ops/relpos_attention.py.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace relpos {

// Dropout parameters; unused when a kernel's DROP is false.
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
// multiple of 4; bits of keys outside [0, Tp) are computed all the same
// and never read.
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

// Keep bits of query row q over the 32 keys kstart .. kstart + 31, kstart
// a multiple of 4: bit t is the pair (q, kstart + t).
__device__ __forceinline__ unsigned keep_bits32(const Drop& d, int bh, int q,
                                                int kstart) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 r = philox(make_uint4((unsigned)((kstart >> 2) + i),
                                      (unsigned)q, (unsigned)bh, 0u),
                           d.k0, d.k1);
    bits |= (unsigned)(r.x >= d.thresh) << (4 * i);
    bits |= (unsigned)(r.y >= d.thresh) << (4 * i + 1);
    bits |= (unsigned)(r.z >= d.thresh) << (4 * i + 2);
    bits |= (unsigned)(r.w >= d.thresh) << (4 * i + 3);
  }
  return bits;
}

}  // namespace relpos
