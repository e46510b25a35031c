// BN254's G1 (over Fq) and G2 (over Fq2 = Fq[u]/(u^2 + 1), the sextic
// twist) in Jacobian coordinates, one template over the coordinate field.
//
// Coordinates are Montgomery-form field elements of bn254.cuh, always
// canonical.  A point is (X, Y, Z) with x = X / Z^2, y = Y / Z^3, and Z = 0
// at infinity.  The curves are y^2 = x^3 + b with a = 0, so no formula
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

// raw Montgomery words in scratch memory
template <class F>
__device__ __forceinline__ void f_load_raw(F& r, const uint32_t* w) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < FieldWords<F>::N; k++) d[k] = w[k];
}
template <class F>
__device__ __forceinline__ void f_store_raw(uint32_t* w, const F& a) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll
  for (int k = 0; k < FieldWords<F>::N; k++) w[k] = s[k];
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

template <class F>
__device__ __forceinline__ void jac_load_raw(Jac<F>& p, const uint32_t* w) {
  f_load_raw(p.x, w);
  f_load_raw(p.y, w + FieldWords<F>::N);
  f_load_raw(p.z, w + 2 * FieldWords<F>::N);
}

template <class F>
__device__ __forceinline__ void jac_store_raw(uint32_t* w, const Jac<F>& p) {
  f_store_raw(w, p.x);
  f_store_raw(w + FieldWords<F>::N, p.y);
  f_store_raw(w + 2 * FieldWords<F>::N, p.z);
}

// r = 2 p (dbl-2009-l); r may alias p
template <class F>
__device__ void jac_double(Jac<F>& r, const Jac<F>& p) {
  if (jac_is_inf(p)) {
    r = p;
    return;
  }
  F a, b, c, d, e, f, t, x3, y3, z3;
  f_mul(a, p.x, p.x);
  f_mul(b, p.y, p.y);
  f_mul(c, b, b);
  f_add(t, p.x, b);
  f_mul(t, t, t);
  f_sub(t, t, a);
  f_sub(t, t, c);
  f_add(d, t, t);                  // D = 2 ((X + B)^2 - A - C)
  f_add(e, a, a);
  f_add(e, e, a);                  // E = 3 A
  f_mul(f, e, e);
  f_add(t, d, d);
  f_sub(x3, f, t);                 // X3 = F - 2 D
  f_sub(t, d, x3);
  f_mul(y3, e, t);
  f_add(c, c, c);
  f_add(c, c, c);
  f_add(c, c, c);
  f_sub(y3, y3, c);                // Y3 = E (D - X3) - 8 C
  f_mul(z3, p.y, p.z);
  f_add(z3, z3, z3);               // Z3 = 2 Y Z (0 if Y = 0)
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// r = p + (qx, qy), an affine point not at infinity (madd-2007-bl); r may
// alias p
template <class F>
__device__ void jac_add_affine(Jac<F>& r, const Jac<F>& p, const F& qx,
                               const F& qy) {
  if (jac_is_inf(p)) {
    r.x = qx;
    r.y = qy;
    f_one(r.z);
    return;
  }
  F z1z1, u2, s2, h, hh, i, j, rr, v, t, x3, y3, z3;
  f_mul(z1z1, p.z, p.z);
  f_mul(u2, qx, z1z1);
  f_mul(s2, qy, p.z);
  f_mul(s2, s2, z1z1);
  f_sub(h, u2, p.x);               // H = U2 - X1
  f_sub(rr, s2, p.y);              // S2 - Y1
  if (f_is_zero(h)) {
    if (f_is_zero(rr)) {
      jac_double(r, p);            // P = Q
    } else {
      jac_set_inf(r);              // P = -Q
    }
    return;
  }
  f_mul(hh, h, h);
  f_add(i, hh, hh);
  f_add(i, i, i);                  // I = 4 HH
  f_mul(j, h, i);
  f_add(rr, rr, rr);               // r = 2 (S2 - Y1)
  f_mul(v, p.x, i);
  f_mul(x3, rr, rr);
  f_sub(x3, x3, j);
  f_sub(x3, x3, v);
  f_sub(x3, x3, v);                // X3 = r^2 - J - 2 V
  f_sub(t, v, x3);
  f_mul(y3, rr, t);
  f_mul(t, p.y, j);
  f_add(t, t, t);
  f_sub(y3, y3, t);                // Y3 = r (V - X3) - 2 Y1 J
  f_add(z3, p.z, h);
  f_mul(z3, z3, z3);
  f_sub(z3, z3, z1z1);
  f_sub(z3, z3, hh);               // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// r = p + q (add-2007-bl); r may alias p or q
template <class F>
__device__ void jac_add(Jac<F>& r, const Jac<F>& p, const Jac<F>& q) {
  if (jac_is_inf(p)) {
    r = q;
    return;
  }
  if (jac_is_inf(q)) {
    r = p;
    return;
  }
  F z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t, x3, y3, z3;
  f_mul(z1z1, p.z, p.z);
  f_mul(z2z2, q.z, q.z);
  f_mul(u1, p.x, z2z2);
  f_mul(u2, q.x, z1z1);
  f_mul(s1, p.y, q.z);
  f_mul(s1, s1, z2z2);
  f_mul(s2, q.y, p.z);
  f_mul(s2, s2, z1z1);
  f_sub(h, u2, u1);
  f_sub(rr, s2, s1);
  if (f_is_zero(h)) {
    if (f_is_zero(rr)) {
      jac_double(r, p);
    } else {
      jac_set_inf(r);
    }
    return;
  }
  f_add(i, h, h);
  f_mul(i, i, i);                  // I = (2 H)^2
  f_mul(j, h, i);
  f_add(rr, rr, rr);               // r = 2 (S2 - S1)
  f_mul(v, u1, i);
  f_mul(x3, rr, rr);
  f_sub(x3, x3, j);
  f_sub(x3, x3, v);
  f_sub(x3, x3, v);                // X3 = r^2 - J - 2 V
  f_sub(t, v, x3);
  f_mul(y3, rr, t);
  f_mul(t, s1, j);
  f_add(t, t, t);
  f_sub(y3, y3, t);                // Y3 = r (V - X3) - 2 S1 J
  f_add(z3, p.z, q.z);
  f_mul(z3, z3, z3);
  f_sub(z3, z3, z1z1);
  f_sub(z3, z3, z2z2);
  f_mul(z3, z3, h);                // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  r.x = x3;
  r.y = y3;
  r.z = z3;
}
