// Goldilocks field arithmetic on native 64-bit lanes (p = 2^64 - 2^32 + 1).
//
// Shared by gl_mul.cu and poseidon_gl.cu.  Each function computes exactly
// what the plain PyTorch versions in fields/gl.py compute (the same
// branch-free plonky2 reduction), so kernel and plain version agree bit for
// bit on every 64-bit input, canonical or not.
#pragma once
#include <stdint.h>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL  // 2^64 mod p = 2^32 - 1

// hi * 2^64 + lo mod p, canonical; uses 2^64 = 2^32 - 1 and 2^96 = -1.
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & 0xFFFFFFFFULL;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= GL_EPS;
  uint64_t t1 = hi_lo * GL_EPS;
  uint64_t r = t0 + t1;
  if (r < t0) r += GL_EPS;
  if (r >= GL_P) r -= GL_P;
  return r;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

// a + b mod p for any 64-bit a and b < p; canonical result.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += GL_EPS;
  if (s >= GL_P) s -= GL_P;
  return s;
}
