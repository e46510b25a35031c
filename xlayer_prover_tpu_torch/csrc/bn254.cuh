// BN254 scalar field Fr (r = 0x30644e72...f0000001, 254 bits) on 32-bit
// words, in Montgomery form with R = 2^256.
//
// An element is eight little-endian 32-bit words.  fr_mul is CIOS
// Montgomery multiplication: for each word b_i of b, the accumulator
// takes a * b_i, then m * p with m = t_0 * (-p^-1 mod 2^32), and drops its
// (now zero) low word.  Each "a * b_i" is two PTX carry chains over the
// accumulator (mad.lo.cc / madc.lo.cc for the low halves of the eight
// products at words 0..7, mad.hi.cc / madc.hi.cc for the high halves at
// words 1..8), the idiom of gl.cuh: 16 multiply-adds a row, 33 a word
// of b with the reduction's row and m, 264 a product.  The accumulator
// holds ten words (it stays below 2^289).  With a < 2^256 and b < p the
// result is below 2p, so one conditional subtraction makes it canonical:
// every function here takes and returns canonical values, except that
// fr_mul's `a` may be any 256-bit value (fr_to_mont reduces raw inputs).
//
// The plain model of the same field arithmetic is ops/poseidon_bn254.py
// (16-bit limbs, R' = 2^272); ops/poseidon_bn254.py MONT_N0INV and
// MONT_R2 hold the constants below, and a CPU test reads them out of this
// file and compares.
#pragma once
#include <stdint.h>

#define FR_WORDS 8

// r, little-endian 32-bit words
#define FR_P0 0xf0000001u
#define FR_P1 0x43e1f593u
#define FR_P2 0x79b97091u
#define FR_P3 0x2833e848u
#define FR_P4 0x8181585du
#define FR_P5 0xb85045b6u
#define FR_P6 0xe131a029u
#define FR_P7 0x30644e72u
// -r^-1 mod 2^32
#define FR_N0INV 0xefffffffu
// R^2 mod r (R = 2^256), little-endian 32-bit words
#define FR_R2_0 0xae216da7u
#define FR_R2_1 0x1bb8e645u
#define FR_R2_2 0xe35c59e3u
#define FR_R2_3 0x53fe3ab1u
#define FR_R2_4 0x53bb8085u
#define FR_R2_5 0x8c49833du
#define FR_R2_6 0x7f4e44a5u
#define FR_R2_7 0x0216d0b1u

// t[0..9] += a[0..7] * b
__device__ __forceinline__ void fr_mac_row(uint32_t t[10], const uint32_t a[8],
                                           uint32_t b) {
  asm("mad.lo.cc.u32  %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// r = t - p if t (nine words, t < 2p) >= p, else t
__device__ __forceinline__ void fr_reduce_once(uint32_t r[8],
                                               const uint32_t t[9]) {
  uint32_t d[8], top;
  asm("sub.cc.u32  %0, %9, %18;\n\t"
      "subc.cc.u32 %1, %10, %19;\n\t"
      "subc.cc.u32 %2, %11, %20;\n\t"
      "subc.cc.u32 %3, %12, %21;\n\t"
      "subc.cc.u32 %4, %13, %22;\n\t"
      "subc.cc.u32 %5, %14, %23;\n\t"
      "subc.cc.u32 %6, %15, %24;\n\t"
      "subc.cc.u32 %7, %16, %25;\n\t"
      "subc.u32    %8, %17, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(top)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(FR_P0), "r"(FR_P1),
        "r"(FR_P2), "r"(FR_P3), "r"(FR_P4), "r"(FR_P5), "r"(FR_P6),
        "r"(FR_P7));
  // top is 0 when t >= p, 0xffffffff when the subtraction borrowed
  const bool keep = top != 0;
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = keep ? t[k] : d[k];
}

// r = a * b / R mod p
__device__ __forceinline__ void fr_mul(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  const uint32_t p[8] = {FR_P0, FR_P1, FR_P2, FR_P3,
                         FR_P4, FR_P5, FR_P6, FR_P7};
  uint32_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    fr_mac_row(t, a, b[i]);
    fr_mac_row(t, p, t[0] * FR_N0INV);   // t[0] becomes 0
#pragma unroll
    for (int k = 0; k < 9; k++) t[k] = t[k + 1];
    t[9] = 0;
  }
  fr_reduce_once(r, t);
}

// r = a + b mod p
__device__ __forceinline__ void fr_add(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  uint32_t s[9];
  asm("add.cc.u32  %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32    %8, %25, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(s[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(0u));
  fr_reduce_once(r, s);
}

// r = a^5
__device__ __forceinline__ void fr_pow5(uint32_t r[8], const uint32_t a[8]) {
  uint32_t a2[8], a4[8];
  fr_mul(a2, a, a);
  fr_mul(a4, a2, a2);
  fr_mul(r, a4, a);
}

// raw 256-bit value (any) -> Montgomery form of its value mod p
__device__ __forceinline__ void fr_to_mont(uint32_t r[8], const uint32_t x[8]) {
  const uint32_t r2[8] = {FR_R2_0, FR_R2_1, FR_R2_2, FR_R2_3,
                          FR_R2_4, FR_R2_5, FR_R2_6, FR_R2_7};
  fr_mul(r, x, r2);
}

// Montgomery form -> canonical value
__device__ __forceinline__ void fr_from_mont(uint32_t r[8], const uint32_t x[8]) {
  const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  fr_mul(r, x, one);
}
