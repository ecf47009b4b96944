// Counter-based Philox4x32-10 on the card: the frontier's random stream.
//
// The same stream as kernels/philox.py (the plain version, bit for bit; the
// layout is set out there): key = the seed's two 32-bit words, counter
// (slot / P, rep, candidate, 0), four words per counter serving P slots.
// The known-answer vectors of Random123's philox4x32_10 pin both versions
// (tests/test_torch_philox.py).
#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;  // round multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // key schedule (Weyl) increments
constexpr uint32_t kW1 = 0xBB67AE85u;

// ten rounds; each is two 32 x 32 -> 64-bit products and three-input xors
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// float32 uniform in [0, 1): 23 bits under the exponent of 1.0, minus 1
__device__ __forceinline__ float uniform_f32(uint32_t w) {
  return __uint_as_float((w >> 9) | 0x3f800000u) - 1.0f;
}

// float64 uniform in [0, 1): 52 bits (a's 32, b's top 20) under the
// exponent of 1.0, minus 1
__device__ __forceinline__ double uniform_f64(uint32_t a, uint32_t b) {
  const uint64_t bits = (static_cast<uint64_t>(a) << 20) | (b >> 12) | 0x3ff0000000000000ull;
  return __longlong_as_double(static_cast<long long>(bits)) - 1.0;
}

// index into a table of n entries: (w * n) >> 32, biased by at most n / 2^32
__device__ __forceinline__ uint32_t table_index(uint32_t w, uint32_t n) {
  return __umulhi(w, n);
}

}  // namespace philox
