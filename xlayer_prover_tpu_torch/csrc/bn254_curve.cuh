// BN254's G1 (over Fq) and G2 (over Fq2 = Fq[u]/(u^2 + 1), the sextic
// twist) in Jacobian coordinates, one template over the coordinate field.
//
// Coordinates are Montgomery-form field elements of bn254.cuh, always
// canonical (f_sqr of an Fq2 element takes two Fq products, not three).
// A point is (X, Y, Z) with x = X / Z^2, y = Y / Z^3, and Z = 0 at
// infinity.  The curves are y^2 = x^3 + b with a = 0, so no formula
// below reads b: doubling is dbl-2009-l, the addition of an affine point
// madd-2007-bl, the addition of two Jacobian points add-2007-bl (the
// Explicit-Formulas Database).  The additions handle every case: an
// operand at infinity, P = Q (H = 0 and r = 0: the doubling) and P = -Q
// (H = 0, r != 0: infinity), so a bucket may receive a point twice or a
// point beside its negation.
//
// The plain model of the same group law is ops/bn254_msm.py (_double,
// _add): both give the same affine points.
#pragma once
#include "bn254.cuh"

struct Fq {
  uint32_t v[8];
};

struct Fq2 {      // c0 + c1 u
  Fq c0, c1;
};

// -- Fq ----------------------------------------------------------------------

__device__ __forceinline__ void f_add(Fq& r, const Fq& a, const Fq& b) {
  mont_add<FqMod>(r.v, a.v, b.v);
}
__device__ __forceinline__ void f_sub(Fq& r, const Fq& a, const Fq& b) {
  mont_sub<FqMod>(r.v, a.v, b.v);
}
__device__ __forceinline__ void f_mul(Fq& r, const Fq& a, const Fq& b) {
  mont_mul<FqMod>(r.v, a.v, b.v);
}
__device__ __forceinline__ void f_sqr(Fq& r, const Fq& a) { f_mul(r, a, a); }
__device__ __forceinline__ bool f_is_zero(const Fq& a) {
  uint32_t o = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) o |= a.v[k];
  return o == 0;
}
__device__ __forceinline__ void f_zero(Fq& r) {
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = 0;
}
__device__ __forceinline__ void f_one(Fq& r) { FqMod::one(r.v); }
// canonical words <-> Montgomery form
__device__ __forceinline__ void f_load(Fq& r, const uint32_t* w) {
  uint32_t x[8];
#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = w[k];
  mont_to<FqMod>(r.v, x);
}
__device__ __forceinline__ void f_store(uint32_t* w, const Fq& a) {
  uint32_t x[8];
  mont_from<FqMod>(x, a.v);
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = x[k];
}
// r = a^(p - 2) = a^-1 (0 for 0)
__device__ __forceinline__ void f_inv(Fq& r, const Fq& a) {
  uint32_t e[8];
  FqMod::modulus(e);
  e[0] -= 2;                       // p's low word is above 2
  Fq acc;
  f_one(acc);
  for (int bit = 253; bit >= 0; bit--) {
    f_mul(acc, acc, acc);
    if ((e[bit >> 5] >> (bit & 31)) & 1) f_mul(acc, acc, a);
  }
  r = acc;
}

// -- Fq2 ---------------------------------------------------------------------

__device__ __forceinline__ void f_add(Fq2& r, const Fq2& a, const Fq2& b) {
  f_add(r.c0, a.c0, b.c0);
  f_add(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ void f_sub(Fq2& r, const Fq2& a, const Fq2& b) {
  f_sub(r.c0, a.c0, b.c0);
  f_sub(r.c1, a.c1, b.c1);
}
// (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
__device__ __forceinline__ void f_mul(Fq2& r, const Fq2& a, const Fq2& b) {
  Fq t0, t1, s, t;
  f_mul(t0, a.c0, b.c0);
  f_mul(t1, a.c1, b.c1);
  f_add(s, a.c0, a.c1);
  f_add(t, b.c0, b.c1);
  f_mul(s, s, t);
  f_sub(s, s, t0);
  f_sub(r.c1, s, t1);
  f_sub(r.c0, t0, t1);
}
// (c0 + c1)(c0 - c1) + 2 c0 c1 u: two Fq products
__device__ __forceinline__ void f_sqr(Fq2& r, const Fq2& a) {
  Fq s, d, m;
  f_add(s, a.c0, a.c1);
  f_sub(d, a.c0, a.c1);
  f_mul(m, a.c0, a.c1);
  f_mul(r.c0, s, d);
  f_add(r.c1, m, m);
}
__device__ __forceinline__ bool f_is_zero(const Fq2& a) {
  return f_is_zero(a.c0) && f_is_zero(a.c1);
}
__device__ __forceinline__ void f_zero(Fq2& r) {
  f_zero(r.c0);
  f_zero(r.c1);
}
__device__ __forceinline__ void f_one(Fq2& r) {
  f_one(r.c0);
  f_zero(r.c1);
}
__device__ __forceinline__ void f_load(Fq2& r, const uint32_t* w) {
  f_load(r.c0, w);
  f_load(r.c1, w + 8);
}
__device__ __forceinline__ void f_store(uint32_t* w, const Fq2& a) {
  f_store(w, a.c0);
  f_store(w + 8, a.c1);
}
// (c0 - c1 u) / (c0^2 + c1^2)
__device__ __forceinline__ void f_inv(Fq2& r, const Fq2& a) {
  Fq n, t, z;
  f_mul(n, a.c0, a.c0);
  f_mul(t, a.c1, a.c1);
  f_add(n, n, t);
  f_inv(n, n);
  f_zero(z);
  f_sub(t, z, a.c1);
  f_mul(r.c0, a.c0, n);
  f_mul(r.c1, t, n);
}

// 32-bit words of a field element
template <class F> struct FieldWords;
template <> struct FieldWords<Fq> { static constexpr int N = 8; };
template <> struct FieldWords<Fq2> { static constexpr int N = 16; };

// raw Montgomery words in scratch memory, word k at w[k STRIDE]
template <class F, int STRIDE = 1>
__device__ __forceinline__ void f_load_raw(F& r, const uint32_t* w) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < FieldWords<F>::N; k++) d[k] = w[k * STRIDE];
}
template <class F, int STRIDE = 1>
__device__ __forceinline__ void f_store_raw(uint32_t* w, const F& a) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll
  for (int k = 0; k < FieldWords<F>::N; k++) w[k * STRIDE] = s[k];
}

// -- points ------------------------------------------------------------------

template <class F>
struct Jac {
  F x, y, z;
};

template <class F>
__device__ __forceinline__ void jac_set_inf(Jac<F>& p) {
  f_zero(p.x);
  f_one(p.y);
  f_zero(p.z);
}

template <class F>
__device__ __forceinline__ bool jac_is_inf(const Jac<F>& p) {
  return f_is_zero(p.z);
}

template <class F, int STRIDE = 1>
__device__ __forceinline__ void jac_load_raw(Jac<F>& p, const uint32_t* w) {
  f_load_raw<F, STRIDE>(p.x, w);
  f_load_raw<F, STRIDE>(p.y, w + FieldWords<F>::N * STRIDE);
  f_load_raw<F, STRIDE>(p.z, w + 2 * FieldWords<F>::N * STRIDE);
}

template <class F, int STRIDE = 1>
__device__ __forceinline__ void jac_store_raw(uint32_t* w, const Jac<F>& p) {
  f_store_raw<F, STRIDE>(w, p.x);
  f_store_raw<F, STRIDE>(w + FieldWords<F>::N * STRIDE, p.y);
  f_store_raw<F, STRIDE>(w + 2 * FieldWords<F>::N * STRIDE, p.z);
}

// r = 2 p (dbl-2009-l); r may alias p.  Each coordinate of p is read for
// the last time before r's is written, and at most four values besides p
// are live (the G2 kernels' register budget).
template <class F>
__device__ __forceinline__ void jac_double(Jac<F>& r, const Jac<F>& p) {
  if (jac_is_inf(p)) {
    r = p;
    return;
  }
  F a, b, c, d;
  f_sqr(a, p.x);                   // A = X^2
  f_sqr(b, p.y);                   // B = Y^2
  f_sqr(c, b);                     // C = B^2
  f_add(d, p.x, b);
  f_sqr(d, d);
  f_sub(d, d, a);
  f_sub(d, d, c);
  f_add(d, d, d);                  // D = 2 ((X + B)^2 - A - C)
  f_add(b, a, a);
  f_add(a, b, a);                  // E = 3 A
  f_mul(b, p.y, p.z);
  f_add(r.z, b, b);                // Z3 = 2 Y Z (0 if Y = 0)
  f_sqr(b, a);                     // F = E^2
  f_sub(b, b, d);
  f_sub(r.x, b, d);                // X3 = F - 2 D
  f_sub(d, d, r.x);
  f_mul(d, a, d);
  f_add(c, c, c);
  f_add(c, c, c);
  f_add(c, c, c);
  f_sub(r.y, d, c);                // Y3 = E (D - X3) - 8 C
}

// r = p + (qx, qy), an affine point not at infinity (madd-2007-bl); r may
// alias p.  Ordered so that at most six values are live (the G2 kernels'
// register budget): Z3 as soon as H is known, 2 Y1 J before X3.
template <class F>
__device__ void jac_add_affine(Jac<F>& r, const Jac<F>& p, const F& qx,
                               const F& qy) {
  if (jac_is_inf(p)) {
    r.x = qx;
    r.y = qy;
    f_one(r.z);
    return;
  }
  F z1z1, h, rr, t;
  f_sqr(z1z1, p.z);
  f_mul(h, qx, z1z1);
  f_sub(h, h, p.x);                // H = U2 - X1, U2 = X2 Z1Z1
  f_mul(rr, qy, p.z);
  f_mul(rr, rr, z1z1);
  f_sub(rr, rr, p.y);              // S2 - Y1, S2 = Y2 Z1 Z1Z1
  if (f_is_zero(h)) {
    if (f_is_zero(rr)) {
      jac_double(r, p);            // P = Q
    } else {
      jac_set_inf(r);              // P = -Q
    }
    return;
  }
  f_add(t, p.z, h);
  f_sqr(t, t);
  f_sub(t, t, z1z1);
  f_sqr(z1z1, h);                  // HH
  f_sub(r.z, t, z1z1);             // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  f_add(z1z1, z1z1, z1z1);
  f_add(z1z1, z1z1, z1z1);         // I = 4 HH
  f_mul(h, h, z1z1);               // J = H I
  f_mul(t, p.x, z1z1);             // V = X1 I
  f_mul(z1z1, p.y, h);
  f_add(z1z1, z1z1, z1z1);         // 2 Y1 J
  f_add(rr, rr, rr);               // r = 2 (S2 - Y1)
  f_sqr(r.x, rr);
  f_sub(r.x, r.x, h);
  f_sub(r.x, r.x, t);
  f_sub(r.x, r.x, t);              // X3 = r^2 - J - 2 V
  f_sub(t, t, r.x);
  f_mul(t, rr, t);
  f_sub(r.y, t, z1z1);             // Y3 = r (V - X3) - 2 Y1 J
}

// acc += Q (add-2007-bl with Z3 = 2 Z1 Z2 H), Q's raw Montgomery words
// in memory (global or shared): word k of coordinate j at
// q[(j fw + k) STRIDE].  Each coordinate of Q is read where it is first
// needed (Z2 twice), so that at most five values besides acc are live (the
// G2 kernels' register budget).  Every case: Q or acc at infinity, acc =
// Q (the doubling) and acc = -Q (infinity).
template <class F, int STRIDE = 1>
__device__ __forceinline__ void jac_add_from(Jac<F>& acc, const uint32_t* q) {
  constexpr int fw = FieldWords<F>::N;
  F z2, t0, t1, t2, t3;
  f_load_raw<F, STRIDE>(z2, q + 2 * fw * STRIDE);
  if (f_is_zero(z2)) return;
  if (jac_is_inf(acc)) {
    f_load_raw<F, STRIDE>(acc.x, q);
    f_load_raw<F, STRIDE>(acc.y, q + fw * STRIDE);
    acc.z = z2;
    return;
  }
  f_sqr(t0, z2);                   // Z2Z2
  f_mul(t1, acc.x, t0);            // U1 = X1 Z2Z2
  f_mul(t2, acc.y, z2);
  f_mul(t2, t2, t0);               // S1 = Y1 Z2 Z2Z2
  f_sqr(t0, acc.z);                // Z1Z1
  f_load_raw<F, STRIDE>(z2, q);
  f_mul(t3, z2, t0);
  f_sub(t3, t3, t1);               // H = U2 - U1, U2 = X2 Z1Z1
  f_load_raw<F, STRIDE>(z2, q + fw * STRIDE);
  f_mul(z2, z2, acc.z);
  f_mul(z2, z2, t0);
  f_sub(t0, z2, t2);               // S2 - S1, S2 = Y2 Z1 Z1Z1
  if (f_is_zero(t3)) {
    if (f_is_zero(t0)) {
      jac_double(acc, acc);        // acc = Q
    } else {
      jac_set_inf(acc);            // acc = -Q
    }
    return;
  }
  f_load_raw<F, STRIDE>(z2, q + 2 * fw * STRIDE);
  f_mul(z2, z2, acc.z);
  f_mul(z2, z2, t3);
  f_add(acc.z, z2, z2);            // Z3 = 2 Z1 Z2 H
  f_add(z2, t3, t3);
  f_sqr(z2, z2);                   // I = (2 H)^2
  f_mul(t3, t3, z2);               // J = H I
  f_mul(t1, t1, z2);               // V = U1 I
  f_mul(t2, t2, t3);
  f_add(t2, t2, t2);               // 2 S1 J
  f_add(t0, t0, t0);               // r = 2 (S2 - S1)
  f_sqr(acc.x, t0);
  f_sub(acc.x, acc.x, t3);
  f_sub(acc.x, acc.x, t1);
  f_sub(acc.x, acc.x, t1);         // X3 = r^2 - J - 2 V
  f_sub(t1, t1, acc.x);
  f_mul(t1, t0, t1);
  f_sub(acc.y, t1, t2);            // Y3 = r (V - X3) - 2 S1 J
}
