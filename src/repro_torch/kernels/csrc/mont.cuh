// Montgomery arithmetic shared by every kernel of the port (R = 2^32).
//
// Residues are u32 values below q < 2^30.  mont_mul uses one 64-bit product
// t = a*b < 2^60, m = lo32(t) * (-q^{-1}) mod 2^32 and (t + m*q) >> 32, which
// stays below 2^64 (t + m*q < 2^60 + 2^62) and below 2q, then subtracts q
// once.  The result is the canonical value in [0, q), so it equals the JAX
// package's 16-bit-split ref.mont_mul bit for bit; that is what makes every
// kernel of the port exact against its plain version.
//
// Built with nvcc, the functions are __host__ __device__.  Built with a
// host compiler (the CPU test of this header), MONT_HD is plain inline.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define MONT_HD __host__ __device__ __forceinline__
#else
#define MONT_HD static inline
#endif

MONT_HD uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t q,
                          uint32_t qinv_neg) {
  uint64_t t = (uint64_t)a * b;
  uint32_t m = (uint32_t)t * qinv_neg;
  uint32_t r = (uint32_t)((t + (uint64_t)m * q) >> 32);
  return r >= q ? r - q : r;
}

MONT_HD uint32_t mod_add(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;  // < 2^31, no wrap
  return s >= q ? s - q : s;
}

MONT_HD uint32_t mod_sub(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}
