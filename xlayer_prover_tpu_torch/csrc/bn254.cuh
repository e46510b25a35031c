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
// The fr_* functions are the Fr instances that the Poseidon-BN254 and Fr
// NTT kernels call.  The plain model of the same field arithmetic is
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

// -- Fr, as the Poseidon-BN254 and Fr NTT kernels call it -------------------

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

__device__ __forceinline__ void fr_to_mont(uint32_t r[8], const uint32_t x[8]) {
  mont_to<FrMod>(r, x);
}

__device__ __forceinline__ void fr_from_mont(uint32_t r[8],
                                             const uint32_t x[8]) {
  mont_from<FrMod>(r, x);
}

// -- Fr wide products and lazy reduction (the Poseidon-BN254 kernels) -------
//
// A sum of products of canonical values, sum_j a_j b_j over at most 17
// terms, stays below 17 r^2 < 2^512 (r < 2^253.6): it is kept exactly in
// sixteen words (fr_mac_wide) and reduced once (fr_redc_wide).  The
// reduction splits S = S_hi 2^256 + S_lo and returns
//   y = S_hi + add + u,  u = (S_lo + m r) / 2^256 <= r,
// the CIOS rows of mont_mul without its products (m r cancels the eight
// low words), so y = S / R + add mod r.  For such a sum S_hi < 17 r^2 /
// 2^256 < 3.22 r (r / 2^256 < 0.1891), so with add = 0 y < 4.22 r; for one
// product of a value below 2r and a canonical one, plus a canonical
// addend, y < 0.38 r + r + r.  Either way y < 2^256 (5.28 r): fr_canon
// brings any 256-bit y to canonical.  It takes
// q = floor(y_7 / (r_7 + 1)) from the top words: q r <= q (r_7 + 1) 2^224
// <= y, and y - q r < (r_7 + 1 + q) 2^224 < 2r, so one conditional
// subtraction after y - q r ends it (tests/test_torch_poseidon_bn254.py
// runs the same steps on the worst cases).  A square of a value below 2r
// has S_hi < 4 r^2 / 2^256 < 0.76 r, so fr_sqr_lazy's y = S_hi + u stays
// below 2r without fr_canon, and a value below 2r may be squared again.

// q[0..8] += a[0..7] * b, where the sum fits nine words (q[8] takes the low
// chain's carry and the high chain's last word; nothing carries out)
__device__ __forceinline__ void wide_mac_row(uint32_t q[9],
                                             const uint32_t a[8],
                                             uint32_t b) {
  asm("mad.lo.cc.u32  %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32    %8, %16, %17, %8;"
      : "+r"(q[0]), "+r"(q[1]), "+r"(q[2]), "+r"(q[3]), "+r"(q[4]),
        "+r"(q[5]), "+r"(q[6]), "+r"(q[7]), "+r"(q[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// p = a * b, the full 512-bit product (a, b any 256-bit values): row i adds
// a b_i at word i, and the partial product of rows 0..i fits i + 9 words
__device__ __forceinline__ void fr_mul_wide(uint32_t p[16],
                                            const uint32_t a[8],
                                            const uint32_t b[8]) {
#pragma unroll
  for (int k = 0; k < 16; k++) p[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) wide_mac_row(p + i, a, b[i]);
}

// p = a^2: the 28 products a_i a_j (i < j) summed by rows (row i ends at
// word i + 8, which it finds 0), doubled, then the 8 squares a_i^2 added
// at words 2i, 2i + 1: 72 multiplies against a product's 128
__device__ __forceinline__ void fr_sqr_wide(uint32_t p[16],
                                            const uint32_t a[8]) {
#pragma unroll
  for (int k = 0; k < 16; k++) p[k] = 0;
  asm("mad.lo.cc.u32  %1, %16, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %16, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %16, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %16, %20, %4;\n\t"
      "madc.lo.cc.u32 %5, %16, %21, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %22, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %23, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %2, %16, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %16, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %16, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %16, %20, %5;\n\t"
      "madc.hi.cc.u32 %6, %16, %21, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %22, %7;\n\t"
      "madc.hi.u32    %8, %16, %23, %8;\n\t"
      "mad.lo.cc.u32  %3, %17, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %17, %19, %4;\n\t"
      "madc.lo.cc.u32 %5, %17, %20, %5;\n\t"
      "madc.lo.cc.u32 %6, %17, %21, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %22, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %23, %8;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %4, %17, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %17, %19, %5;\n\t"
      "madc.hi.cc.u32 %6, %17, %20, %6;\n\t"
      "madc.hi.cc.u32 %7, %17, %21, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %22, %8;\n\t"
      "madc.hi.u32    %9, %17, %23, %9;\n\t"
      "mad.lo.cc.u32  %5, %18, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %18, %20, %6;\n\t"
      "madc.lo.cc.u32 %7, %18, %21, %7;\n\t"
      "madc.lo.cc.u32 %8, %18, %22, %8;\n\t"
      "madc.lo.cc.u32 %9, %18, %23, %9;\n\t"
      "addc.u32       %10, %10, 0;\n\t"
      "mad.hi.cc.u32  %6, %18, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %18, %20, %7;\n\t"
      "madc.hi.cc.u32 %8, %18, %21, %8;\n\t"
      "madc.hi.cc.u32 %9, %18, %22, %9;\n\t"
      "madc.hi.u32    %10, %18, %23, %10;\n\t"
      "mad.lo.cc.u32  %7, %19, %20, %7;\n\t"
      "madc.lo.cc.u32 %8, %19, %21, %8;\n\t"
      "madc.lo.cc.u32 %9, %19, %22, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, %23, %10;\n\t"
      "addc.u32       %11, %11, 0;\n\t"
      "mad.hi.cc.u32  %8, %19, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %19, %21, %9;\n\t"
      "madc.hi.cc.u32 %10, %19, %22, %10;\n\t"
      "madc.hi.u32    %11, %19, %23, %11;\n\t"
      "mad.lo.cc.u32  %9, %20, %21, %9;\n\t"
      "madc.lo.cc.u32 %10, %20, %22, %10;\n\t"
      "madc.lo.cc.u32 %11, %20, %23, %11;\n\t"
      "addc.u32       %12, %12, 0;\n\t"
      "mad.hi.cc.u32  %10, %20, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %20, %22, %11;\n\t"
      "madc.hi.u32    %12, %20, %23, %12;\n\t"
      "mad.lo.cc.u32  %11, %21, %22, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, %23, %12;\n\t"
      "addc.u32       %13, %13, 0;\n\t"
      "mad.hi.cc.u32  %12, %21, %22, %12;\n\t"
      "madc.hi.u32    %13, %21, %23, %13;\n\t"
      "mad.lo.cc.u32  %13, %22, %23, %13;\n\t"
      "addc.u32       %14, %14, 0;\n\t"
      "mad.hi.u32     %14, %22, %23, %14;\n\t"
      "add.cc.u32     %1, %1, %1;\n\t"
      "addc.cc.u32    %2, %2, %2;\n\t"
      "addc.cc.u32    %3, %3, %3;\n\t"
      "addc.cc.u32    %4, %4, %4;\n\t"
      "addc.cc.u32    %5, %5, %5;\n\t"
      "addc.cc.u32    %6, %6, %6;\n\t"
      "addc.cc.u32    %7, %7, %7;\n\t"
      "addc.cc.u32    %8, %8, %8;\n\t"
      "addc.cc.u32    %9, %9, %9;\n\t"
      "addc.cc.u32    %10, %10, %10;\n\t"
      "addc.cc.u32    %11, %11, %11;\n\t"
      "addc.cc.u32    %12, %12, %12;\n\t"
      "addc.cc.u32    %13, %13, %13;\n\t"
      "addc.cc.u32    %14, %14, %14;\n\t"
      "addc.u32       %15, 0, 0;\n\t"
      "mad.lo.cc.u32  %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32    %15, %23, %23, %15;"
      : "+r"(p[0]), "+r"(p[1]), "+r"(p[2]), "+r"(p[3]), "+r"(p[4]),
        "+r"(p[5]), "+r"(p[6]), "+r"(p[7]), "+r"(p[8]), "+r"(p[9]),
        "+r"(p[10]), "+r"(p[11]), "+r"(p[12]), "+r"(p[13]), "+r"(p[14]),
        "+r"(p[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]));
}

// acc += p (sixteen words; the caller keeps the sum below 2^512)
__device__ __forceinline__ void wide_add(uint32_t acc[16],
                                         const uint32_t p[16]) {
  asm("add.cc.u32  %0, %0, %16;\n\t"
      "addc.cc.u32 %1, %1, %17;\n\t"
      "addc.cc.u32 %2, %2, %18;\n\t"
      "addc.cc.u32 %3, %3, %19;\n\t"
      "addc.cc.u32 %4, %4, %20;\n\t"
      "addc.cc.u32 %5, %5, %21;\n\t"
      "addc.cc.u32 %6, %6, %22;\n\t"
      "addc.cc.u32 %7, %7, %23;\n\t"
      "addc.cc.u32 %8, %8, %24;\n\t"
      "addc.cc.u32 %9, %9, %25;\n\t"
      "addc.cc.u32 %10, %10, %26;\n\t"
      "addc.cc.u32 %11, %11, %27;\n\t"
      "addc.cc.u32 %12, %12, %28;\n\t"
      "addc.cc.u32 %13, %13, %29;\n\t"
      "addc.cc.u32 %14, %14, %30;\n\t"
      "addc.u32    %15, %15, %31;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15])
      : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]),
        "r"(p[6]), "r"(p[7]), "r"(p[8]), "r"(p[9]), "r"(p[10]),
        "r"(p[11]), "r"(p[12]), "r"(p[13]), "r"(p[14]), "r"(p[15]));
}

// acc += a * b, unreduced
__device__ __forceinline__ void fr_mac_wide(uint32_t acc[16],
                                            const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint32_t p[16];
  fr_mul_wide(p, a, b);
  wide_add(acc, p);
}

// r = a + b (eight words; the caller keeps the sum below 2^256)
__device__ __forceinline__ void add8(uint32_t r[8], const uint32_t a[8],
                                     const uint32_t b[8]) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// r = y mod r for any 256-bit y: y - q r with q from the top words, then
// one conditional subtraction (the bound is in the note above)
__device__ __forceinline__ void fr_canon(uint32_t r[8], const uint32_t y[8]) {
  uint32_t p[8], qp[8], d[9];
  FrMod::modulus(p);
  const uint32_t q = y[7] / (FR_P7 + 1u);
  asm("mul.lo.u32     %0, %16, %8;\n\t"
      "mul.lo.u32     %1, %16, %9;\n\t"
      "mul.lo.u32     %2, %16, %10;\n\t"
      "mul.lo.u32     %3, %16, %11;\n\t"
      "mul.lo.u32     %4, %16, %12;\n\t"
      "mul.lo.u32     %5, %16, %13;\n\t"
      "mul.lo.u32     %6, %16, %14;\n\t"
      "mul.lo.u32     %7, %16, %15;\n\t"
      "mad.hi.cc.u32  %1, %16, %8, %1;\n\t"
      "madc.hi.cc.u32 %2, %16, %9, %2;\n\t"
      "madc.hi.cc.u32 %3, %16, %10, %3;\n\t"
      "madc.hi.cc.u32 %4, %16, %11, %4;\n\t"
      "madc.hi.cc.u32 %5, %16, %12, %5;\n\t"
      "madc.hi.cc.u32 %6, %16, %13, %6;\n\t"
      "madc.hi.u32    %7, %16, %14, %7;"
      : "=r"(qp[0]), "=r"(qp[1]), "=r"(qp[2]), "=r"(qp[3]), "=r"(qp[4]),
        "=r"(qp[5]), "=r"(qp[6]), "=r"(qp[7])
      : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]),
        "r"(p[6]), "r"(p[7]), "r"(q));
  asm("sub.cc.u32  %0, %8, %16;\n\t"
      "subc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.u32    %7, %15, %23;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7])
      : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
        "r"(y[6]), "r"(y[7]), "r"(qp[0]), "r"(qp[1]), "r"(qp[2]),
        "r"(qp[3]), "r"(qp[4]), "r"(qp[5]), "r"(qp[6]), "r"(qp[7]));
  d[8] = 0;
  mont_reduce_once<FrMod>(r, d);
}

// y = S_hi + add + (S_lo + m r) / 2^256, S / R + add mod r but not
// canonical (the caller keeps it below 2^256: the note above)
__device__ __forceinline__ void fr_redc_lazy_add(uint32_t y[8],
                                                 const uint32_t s[16],
                                                 const uint32_t add[8]) {
  uint32_t p[8];
  FrMod::modulus(p);
  uint32_t t[10] = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], 0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    mont_mac_row(t, p, t[0] * FR_N0INV);     // t[0] becomes 0
#pragma unroll
    for (int k = 0; k < 9; k++) t[k] = t[k + 1];
    t[9] = 0;
  }
  add8(y, t, s + 8);
  add8(y, y, add);
}

// r = S / R + add mod r, canonical, for a sixteen-word S below 17 r^2 and
// a canonical add (the bound is in the note above)
__device__ __forceinline__ void fr_redc_wide_add(uint32_t r[8],
                                                 const uint32_t s[16],
                                                 const uint32_t add[8]) {
  uint32_t y[8];
  fr_redc_lazy_add(y, s, add);
  fr_canon(r, y);
}

__device__ __forceinline__ void fr_redc_wide(uint32_t r[8],
                                             const uint32_t s[16]) {
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  fr_redc_wide_add(r, s, zero);
}

// r = a^2 / R mod r below 2r (not canonical), for a below 2r
__device__ __forceinline__ void fr_sqr_lazy(uint32_t r[8],
                                            const uint32_t a[8]) {
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t s[16];
  fr_sqr_wide(s, a);
  fr_redc_lazy_add(r, s, zero);
}
