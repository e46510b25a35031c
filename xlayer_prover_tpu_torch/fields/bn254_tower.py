"""BN254 extension tower (Fq2/Fq12), G2, and the optimal-ate pairing.

The port's copy of ``xlayer_prover_tpu/fields/bn254_tower.py``, host
Python ints: the Groth16 verifier's pairing check, the host-side G2
operations of the proof's final combination, and the G2 generator of the
fixed-base kernel's table.  The G2 MSM runs on the card
(``ops/bn254_msm.py``).

Standard alt_bn128 parametrization (EIP-196/197): Fq2 = Fq[i]/(i^2+1),
Fq12 = Fq[w]/(w^12 - 18 w^6 + 82) (so w^6 = 9 + i), G2 on the sextic twist
y^2 = x^3 + 3/(9+i), ate loop count 6u+2 with u = 4965661367192848881.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .bn254 import P, R

U = 4965661367192848881
ATE_LOOP_COUNT = 6 * U + 2          # 29793968203157093288
LOG_ATE_LOOP_COUNT = 63

# Fq12 modulus polynomial coefficients: w^12 - 18 w^6 + 82
FQ12_MODULUS_COEFFS = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]

G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


# ---------------------------------------------------------------------------
# Fq2 = Fq[i]/(i^2 + 1): pairs (a, b) = a + b*i
# ---------------------------------------------------------------------------

def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_conj(a):
    return (a[0] % P, (-a[1]) % P)


def fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ni = pow(norm, P - 2, P)
    return (a[0] * ni % P, (-a[1]) * ni % P)


def fq2_mul_scalar(a, s: int):
    return (a[0] * s % P, a[1] * s % P)


# twist curve: y^2 = x^3 + b2 with b2 = 3 / (9 + i)
B2 = fq2_mul_scalar(fq2_inv((9, 1)), 3)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = fq2_sqr(y)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), B2)
    return lhs == rhs


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if y1 == y2:
            return g2_double(p1)
        return None
    lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_double(pt):
    if pt is None:
        return None
    x, y = pt
    if y == (0, 0):
        return None
    lam = fq2_mul(fq2_mul_scalar(fq2_sqr(x), 3),
                  fq2_inv(fq2_mul_scalar(y, 2)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x), x)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x, x3)), y)
    return (x3, y3)


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fq2_neg(pt[1]))


def g2_mul(pt, k: int):
    k %= R
    result = None
    addend = pt
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_double(addend)
        k >>= 1
    return result


# ---------------------------------------------------------------------------
# Fq12 as polynomials of degree < 12 over Fq modulo w^12 - 18 w^6 + 82
# ---------------------------------------------------------------------------

FQ12_ONE = tuple([1] + [0] * 11)
FQ12_ZERO = tuple([0] * 12)


def fq12(coeffs) -> tuple:
    return tuple(c % P for c in coeffs)


def fq12_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def fq12_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def fq12_mul(a, b):
    d = [0] * 23
    for i in range(12):
        ai = a[i]
        if ai:
            for j in range(12):
                d[i + j] += ai * b[j]
    # reduce: w^12 = 18 w^6 - 82
    for k in range(22, 11, -1):
        v = d[k] % P
        if v:
            d[k - 6] += 18 * v
            d[k - 12] -= 82 * v
        d[k] = 0
    return tuple(v % P for v in d[:12])


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    """Inverse via the extended Euclidean algorithm over Fq[w]."""
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(a) + [0]
    high = [(-c) % P for c in FQ12_MODULUS_COEFFS] + [0]
    high[12] = (high[12] + 1) % P     # w^12 - 18w^6 + 82 as monic poly
    # represent modulus poly: w^12 - 18 w^6 + 82
    high = [82 % P, 0, 0, 0, 0, 0, (-18) % P, 0, 0, 0, 0, 0, 1]

    def deg(p):
        for i in range(len(p) - 1, -1, -1):
            if p[i]:
                return i
        return 0

    def poly_rounded_div(aa, bb):
        dega, degb = deg(aa), deg(bb)
        temp = [x for x in aa]
        out = [0] * len(aa)
        binv = pow(bb[degb], P - 2, P)
        for i in range(dega - degb, -1, -1):
            out[i] = (out[i] + temp[degb + i] * binv) % P
            for c in range(degb + 1):
                temp[c + i] = (temp[c + i] - out[i] * bb[c]) % P
        return [x % P for x in out[:deg(out) + 1]]

    while deg(low):
        r = poly_rounded_div(high, low)
        r += [0] * (13 - len(r))
        nm = [x for x in hm]
        new = [x for x in high]
        for i in range(13):
            for j in range(13 - i):
                nm[i + j] = (nm[i + j] - lm[i] * r[j]) % P
                new[i + j] = (new[i + j] - low[i] * r[j]) % P
        lm, low, hm, high = nm, new, lm, low
    li = pow(low[0], P - 2, P)
    return tuple(c * li % P for c in lm[:12])


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


def fq12_scalar(s: int):
    return tuple([s % P] + [0] * 11)


# ---------------------------------------------------------------------------
# pairing: twist G2 into E(Fq12), generic Miller loop
# ---------------------------------------------------------------------------

W2 = tuple([0, 0, 1] + [0] * 9)      # w^2
W3 = tuple([0, 0, 0, 1] + [0] * 8)   # w^3


def twist(pt):
    """G2 (Fq2 affine) -> E(Fq12) affine."""
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    # i = w^6 - 9: a + b*i -> (a - 9b) + b * w^6
    xc = [(x0 - 9 * x1) % P, x1 % P]
    yc = [(y0 - 9 * y1) % P, y1 % P]
    nx = tuple([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = tuple([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (fq12_mul(nx, W2), fq12_mul(ny, W3))


def cast_g1(pt):
    if pt is None:
        return None
    return (fq12_scalar(pt[0]), fq12_scalar(pt[1]))


def _ec12_double(pt):
    x, y = pt
    lam = fq12_mul(fq12_mul(fq12_sqr(x), fq12_scalar(3)),
                   fq12_inv(fq12_mul(y, fq12_scalar(2))))
    x3 = fq12_sub(fq12_sub(fq12_sqr(lam), x), x)
    y3 = fq12_sub(fq12_mul(lam, fq12_sub(x, x3)), y)
    return (x3, y3)


def _ec12_add(p1, p2):
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2 and y1 == y2:
        return _ec12_double(p1)
    lam = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    x3 = fq12_sub(fq12_sub(fq12_sqr(lam), x1), x2)
    y3 = fq12_sub(fq12_mul(lam, fq12_sub(x1, x3)), y1)
    return (x3, y3)


def _linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 at t (all E(Fq12) affine)."""
    (x1, y1), (x2, y2) = p1, p2
    xt, yt = t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if y1 == y2:
        m = fq12_mul(fq12_mul(fq12_sqr(x1), fq12_scalar(3)),
                     fq12_inv(fq12_mul(y1, fq12_scalar(2))))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    return fq12_sub(xt, x1)


FINAL_EXP = (P ** 12 - 1) // R


def miller_loop(q, p):
    """q, p: E(Fq12) affine points (q from twist(G2), p from cast_g1)."""
    if q is None or p is None:
        return FQ12_ONE
    rpt = q
    f = FQ12_ONE
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = fq12_mul(fq12_sqr(f), _linefunc(rpt, rpt, p))
        rpt = _ec12_double(rpt)
        if ATE_LOOP_COUNT & (1 << i):
            f = fq12_mul(f, _linefunc(rpt, q, p))
            rpt = _ec12_add(rpt, q)
    q1 = (fq12_pow(q[0], P), fq12_pow(q[1], P))
    nq2 = (fq12_pow(q1[0], P), fq12_sub(FQ12_ZERO, fq12_pow(q1[1], P)))
    f = fq12_mul(f, _linefunc(rpt, q1, p))
    rpt = _ec12_add(rpt, q1)
    f = fq12_mul(f, _linefunc(rpt, nq2, p))
    return f


def pairing(q_g2, p_g1):
    """e(P, Q) with P in G1 (affine pair), Q in G2 (Fq2 affine pair)."""
    assert g2_is_on_curve(q_g2), "Q not on twist curve"
    f = miller_loop(twist(q_g2), cast_g1(p_g1))
    return fq12_pow(f, FINAL_EXP)


def pairing_check(pairs: List[Tuple[Optional[tuple], Optional[tuple]]]) -> bool:
    """prod e(Pi, Qi) == 1 (Pi in G1, Qi in G2), via one final exp."""
    acc = FQ12_ONE
    for (p_g1, q_g2) in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        acc = fq12_mul(acc, miller_loop(twist(q_g2), cast_g1(p_g1)))
    return fq12_pow(acc, FINAL_EXP) == FQ12_ONE
