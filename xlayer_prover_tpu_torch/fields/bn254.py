"""BN254 (alt_bn128): the base field Fq, the scalar field Fr and G1 in
Jacobian coordinates, as host Python ints.

The port's copy of ``xlayer_prover_tpu/fields/bn254.py`` without its
Python Pippenger ``msm``: the Groth16 MSMs run on the card
(``ops/bn254_msm.py``), and these host operations serve the proof's final
combination and the verifier.  ``None`` is the affine point at infinity,
``INF = (0, 1, 0)`` the Jacobian one.  Fr's modulus r is the
Poseidon-BN254 modulus (``ops/poseidon_bn254.P``).

Curve: y^2 = x^3 + 3 over F_p; r is the scalar field order (= the circuit
field of the final verifier circuits).
"""

from __future__ import annotations

from typing import Optional, Tuple

# base field modulus (Fq)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# scalar field modulus (Fr)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

G1_GEN = (1, 2)


def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fr_inv(a: int) -> int:
    return pow(a, R - 2, R)


# ---------------------------------------------------------------------------
# G1 in Jacobian coordinates (Z=0 => infinity)
# ---------------------------------------------------------------------------

INF = (0, 1, 0)


def g1_from_affine(pt: Optional[Tuple[int, int]]):
    if pt is None:
        return INF
    return (pt[0] % P, pt[1] % P, 1)


def g1_to_affine(j):
    x, y, z = j
    if z == 0:
        return None
    zi = fq_inv(z)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 % P * zi % P)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 3) % P == 0


def g1_double(pt):
    x, y, z = pt
    if z == 0 or y == 0:
        return INF if z == 0 else _dbl(x, y, z)
    return _dbl(x, y, z)


def _dbl(x, y, z):
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def g1_add(p1, p2):
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return INF
        return _dbl(x1, y1, z1)
    h = (u2 - u1) % P
    i = (2 * h) * (2 * h) % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % P * h % P
    return (x3, y3, z3)


def g1_neg(pt):
    x, y, z = pt
    return (x, (P - y) % P, z)


def g1_mul(pt, k: int):
    k %= R
    acc = INF
    base = pt
    while k:
        if k & 1:
            acc = g1_add(acc, base)
        base = g1_double(base)
        k >>= 1
    return acc
