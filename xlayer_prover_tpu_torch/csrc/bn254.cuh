// BN254's two prime fields on 32-bit words, in Montgomery form with
// R = 2^256: the scalar field Fr (r = 0x30644e72...f0000001) and the base
// field Fq (p = 0x30644e72...d87cfd47), both 254 bits.
//
// An element is eight little-endian 32-bit words.  The arithmetic is one
// template over the modulus (a constants struct: FrMod, FqMod).  mont_mul
// is CIOS Montgomery multiplication: for each word b_i of b, the
// accumulator takes a * b_i, then m * p with m = t_0 * (-p^-1 mod 2^32),
// and drops its (now zero) low word.  Each "a * b_i" is two PTX carry
// chains over the accumulator (mad.lo.cc / madc.lo.cc for the low halves
// of the eight products at words 0..7, mad.hi.cc / madc.hi.cc for the high
// halves at words 1..8), the idiom of gl.cuh: 16 multiply-adds a row, 33 a
// word of b with the reduction's row and m, 264 a product.  The
// accumulator holds ten words (it stays below 2^289).  With a < 2^256 and
// b < p the result is below 2p, so one conditional subtraction makes it
// canonical: every function here takes and returns canonical values,
// except that mont_mul's `a` may be any 256-bit value (mont_to reduces raw
// inputs).  A canonical a times the Montgomery form of w is the canonical
// a w: the Fr NTT's twiddles are stored so.
//
// The fr_* functions are the Fr instances that the Poseidon-BN254 kernels
// call.  The plain model of the same field arithmetic is
// ops/bn254_mont.py (16-bit limbs, R' = 2^272); ops/poseidon_bn254.py
// MONT_N0INV and MONT_R2 hold the Fr constants below, and CPU tests read
// the constants of both moduli out of this file and compare.
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

// p, little-endian 32-bit words
#define FQ_P0 0xd87cfd47u
#define FQ_P1 0x3c208c16u
#define FQ_P2 0x6871ca8du
#define FQ_P3 0x97816a91u
#define FQ_P4 0x8181585du
#define FQ_P5 0xb85045b6u
#define FQ_P6 0xe131a029u
#define FQ_P7 0x30644e72u
// -p^-1 mod 2^32
#define FQ_N0INV 0xe4866389u
// R^2 mod p
#define FQ_R2_0 0x538afa89u
#define FQ_R2_1 0xf32cfc5bu
#define FQ_R2_2 0xd44501fbu
#define FQ_R2_3 0xb5e71911u
#define FQ_R2_4 0x0a417ff6u
#define FQ_R2_5 0x47ab1effu
#define FQ_R2_6 0xcab8351fu
#define FQ_R2_7 0x06d89f71u
// R mod p: the Montgomery form of 1
#define FQ_ONE_0 0xc58f0d9du
#define FQ_ONE_1 0xd35d438du
#define FQ_ONE_2 0xf5c70b3du
#define FQ_ONE_3 0x0a78eb28u
#define FQ_ONE_4 0x7879462cu
#define FQ_ONE_5 0x666ea36fu
#define FQ_ONE_6 0x9a07df2fu
#define FQ_ONE_7 0x0e0a77c1u

struct FrMod {
  static constexpr uint32_t N0INV = FR_N0INV;
  __device__ __forceinline__ static void modulus(uint32_t p[8]) {
    p[0] = FR_P0; p[1] = FR_P1; p[2] = FR_P2; p[3] = FR_P3;
    p[4] = FR_P4; p[5] = FR_P5; p[6] = FR_P6; p[7] = FR_P7;
  }
  __device__ __forceinline__ static void r2(uint32_t r[8]) {
    r[0] = FR_R2_0; r[1] = FR_R2_1; r[2] = FR_R2_2; r[3] = FR_R2_3;
    r[4] = FR_R2_4; r[5] = FR_R2_5; r[6] = FR_R2_6; r[7] = FR_R2_7;
  }
};

struct FqMod {
  static constexpr uint32_t N0INV = FQ_N0INV;
  __device__ __forceinline__ static void modulus(uint32_t p[8]) {
    p[0] = FQ_P0; p[1] = FQ_P1; p[2] = FQ_P2; p[3] = FQ_P3;
    p[4] = FQ_P4; p[5] = FQ_P5; p[6] = FQ_P6; p[7] = FQ_P7;
  }
  __device__ __forceinline__ static void r2(uint32_t r[8]) {
    r[0] = FQ_R2_0; r[1] = FQ_R2_1; r[2] = FQ_R2_2; r[3] = FQ_R2_3;
    r[4] = FQ_R2_4; r[5] = FQ_R2_5; r[6] = FQ_R2_6; r[7] = FQ_R2_7;
  }
  __device__ __forceinline__ static void one(uint32_t r[8]) {
    r[0] = FQ_ONE_0; r[1] = FQ_ONE_1; r[2] = FQ_ONE_2; r[3] = FQ_ONE_3;
    r[4] = FQ_ONE_4; r[5] = FQ_ONE_5; r[6] = FQ_ONE_6; r[7] = FQ_ONE_7;
  }
};

// t[0..9] += a[0..7] * b
__device__ __forceinline__ void mont_mac_row(uint32_t t[10],
                                             const uint32_t a[8],
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
template <class M>
__device__ __forceinline__ void mont_reduce_once(uint32_t r[8],
                                                 const uint32_t t[9]) {
  uint32_t p[8], d[8], top;
  M::modulus(p);
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
        "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(p[0]), "r"(p[1]), "r"(p[2]),
        "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]));
  // top is 0 when t >= p, 0xffffffff when the subtraction borrowed
  const bool keep = top != 0;
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = keep ? t[k] : d[k];
}

// r = a * b / R mod p
template <class M>
__device__ __forceinline__ void mont_mul(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t p[8];
  M::modulus(p);
  uint32_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    mont_mac_row(t, a, b[i]);
    mont_mac_row(t, p, t[0] * M::N0INV);   // t[0] becomes 0
#pragma unroll
    for (int k = 0; k < 9; k++) t[k] = t[k + 1];
    t[9] = 0;
  }
  mont_reduce_once<M>(r, t);
}

// r = a + b mod p
template <class M>
__device__ __forceinline__ void mont_add(uint32_t r[8], const uint32_t a[8],
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
  mont_reduce_once<M>(r, s);
}

// r = a - b mod p
template <class M>
__device__ __forceinline__ void mont_sub(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t p[8], d[8], borrow;
  M::modulus(p);
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  // borrow is 0xffffffff when a < b: add p back
#pragma unroll
  for (int k = 0; k < 8; k++) p[k] &= borrow;
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7])
      : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]),
        "r"(d[6]), "r"(d[7]), "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]),
        "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]));
}

// raw 256-bit value (any) -> Montgomery form of its value mod p
template <class M>
__device__ __forceinline__ void mont_to(uint32_t r[8], const uint32_t x[8]) {
  uint32_t r2[8];
  M::r2(r2);
  mont_mul<M>(r, x, r2);
}

// Montgomery form -> canonical value
template <class M>
__device__ __forceinline__ void mont_from(uint32_t r[8], const uint32_t x[8]) {
  const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  mont_mul<M>(r, x, one);
}

// -- Fr, as the Poseidon-BN254 kernels call it ------------------------------

__device__ __forceinline__ void fr_mul(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  mont_mul<FrMod>(r, a, b);
}

__device__ __forceinline__ void fr_add(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  mont_add<FrMod>(r, a, b);
}

__device__ __forceinline__ void fr_sub(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  mont_sub<FrMod>(r, a, b);
}

// r = a^5
__device__ __forceinline__ void fr_pow5(uint32_t r[8], const uint32_t a[8]) {
  uint32_t a2[8], a4[8];
  fr_mul(a2, a, a);
  fr_mul(a4, a2, a2);
  fr_mul(r, a4, a);
}

__device__ __forceinline__ void fr_to_mont(uint32_t r[8], const uint32_t x[8]) {
  mont_to<FrMod>(r, x);
}

__device__ __forceinline__ void fr_from_mont(uint32_t r[8],
                                             const uint32_t x[8]) {
  mont_from<FrMod>(r, x);
}
