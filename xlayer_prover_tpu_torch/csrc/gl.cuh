// Goldilocks field arithmetic on native 64-bit lanes (p = 2^64 - 2^32 + 1).
//
// Shared by gl_mul.cu and poseidon_gl.cu.  The canonical functions compute
// exactly what the plain PyTorch versions in fields/gl.py compute (the
// same plonky2 reduction), so kernel and plain version agree bit for bit on
// every 64-bit input, canonical or not.
//
// The `_nc` functions keep results non-canonical: any 64-bit pattern that
// is congruent to the value mod p.  Every function here accepts such
// inputs, so a chain of them needs one gl_canonical at its end.  Their
// plain PyTorch model is in ops/poseidon_gl.py (_mul128, _reduce128_nc,
// ...).  Carries go through PTX carry chains (add.cc / addc) on 32-bit
// words, and a carry of 2^64 is folded back as + (2^32 - 1): no compares.
#pragma once
#include <stdint.h>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL  // 2^64 mod p = 2^32 - 1

__device__ __forceinline__ uint32_t lo32(uint64_t x) { return (uint32_t)x; }
__device__ __forceinline__ uint32_t hi32(uint64_t x) {
  return (uint32_t)(x >> 32);
}
__device__ __forceinline__ uint64_t pack64(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

// x mod p for any 64-bit x.
__device__ __forceinline__ uint64_t gl_canonical(uint64_t x) {
  return x >= GL_P ? x - GL_P : x;
}

// (r1, r0) + c * (2^32 - 1) for c in {0, 1}, on the integer ALU pipe (a
// mask add; the multiply pipe is the kernels' bottleneck), where the
// caller has shown that it stays below 2^64.
__device__ __forceinline__ uint64_t add_eps(uint32_t r0, uint32_t r1,
                                            uint32_t c) {
  uint32_t lo, hi;
  asm("add.cc.u32 %0, %2, %4;\n\t"
      "addc.u32 %1, %3, 0;"
      : "=r"(lo), "=r"(hi) : "r"(r0), "r"(r1), "r"(0u - c));
  return pack64(lo, hi);
}

// 64x64 -> 128-bit product: eight 32-bit multiply halves (mul.lo /
// mul.hi) in carry chains over the 32-bit words.
__device__ __forceinline__ void gl_mul128(uint64_t a, uint64_t b,
                                          uint64_t& lo, uint64_t& hi) {
  uint32_t x0, x1, x2, x3;
  asm("mul.lo.u32 %0, %4, %6;\n\t"
      "mul.hi.u32 %1, %4, %6;\n\t"
      "mad.lo.cc.u32 %1, %4, %7, %1;\n\t"
      "madc.hi.u32 %2, %4, %7, 0;\n\t"
      "mad.lo.cc.u32 %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "addc.u32 %3, 0, 0;\n\t"
      "mad.lo.cc.u32 %2, %5, %7, %2;\n\t"
      "madc.hi.u32 %3, %5, %7, %3;"
      : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  lo = pack64(x0, x1);
  hi = pack64(x2, x3);
}

// hi * 2^64 + lo mod p, non-canonical; uses 2^64 = 2^32 - 1 and
// 2^96 = -1: (lo - hi_hi) + hi_lo * (2^32 - 1), hi_lo * (2^32 - 1) as a
// shift and a subtract.
__device__ __forceinline__ uint64_t gl_reduce128_nc(uint64_t lo, uint64_t hi) {
  uint32_t r0, r1, b, u0, u1, c;
  asm("sub.cc.u32 %0, %6, %9;\n\t"     // r = lo - hi_hi
      "subc.cc.u32 %1, %7, 0;\n\t"
      "subc.u32 %2, %10, 0;\n\t"       // b = borrow ? 2^32 - 1 : 0
      "sub.cc.u32 %0, %0, %2;\n\t"     // a borrow of 2^64: r -= 2^32 - 1
      "subc.u32 %1, %1, 0;\n\t"
      "sub.cc.u32 %3, %10, %8;\n\t"    // u = hi_lo * 2^32 - hi_lo
      "subc.u32 %4, %8, 0;\n\t"
      "add.cc.u32 %0, %0, %3;\n\t"     // r += u
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %5, %10, 0;"           // c = carry
      : "=r"(r0), "=r"(r1), "=r"(b), "=r"(u0), "=r"(u1), "=r"(c)
      : "r"(lo32(lo)), "r"(hi32(lo)), "r"(lo32(hi)), "r"(hi32(hi)),
        "r"(0u));
  // r >= 2^64 - 2^32 + 1 after a borrow, u <= (2^32 - 1)^2: no wrap here
  return add_eps(r0, r1, c);
}

__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  return gl_canonical(gl_reduce128_nc(lo, hi));
}

__device__ __forceinline__ uint64_t gl_mul_nc(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  gl_mul128(a, b, lo, hi);
  return gl_reduce128_nc(lo, hi);
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_canonical(gl_mul_nc(a, b));
}

// a + c mod p for any 64-bit a and c < p; non-canonical.
__device__ __forceinline__ uint64_t gl_add_nc(uint64_t a, uint64_t c) {
  uint32_t s0, s1, cy;
  asm("add.cc.u32 %0, %3, %5;\n\t"
      "addc.cc.u32 %1, %4, %6;\n\t"
      "addc.u32 %2, %7, 0;"
      : "=r"(s0), "=r"(s1), "=r"(cy)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(c)), "r"(hi32(c)), "r"(0u));
  return add_eps(s0, s1, cy);   // a + c < 2^64 + p
}
