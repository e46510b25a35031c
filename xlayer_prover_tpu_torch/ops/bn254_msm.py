"""BN254 curve kernels: multi-scalar multiplication over G1 and G2, and
fixed-base batch multiplication.

The port's counterparts of the JAX package's host library
``xlayer_prover_tpu/native/msm.cpp`` (``pippenger`` :251 via ``msm_g1``
:288 and ``msm_g2`` :318; ``fixed_base`` :378 via ``fixed_base_g1`` :481
and ``fixed_base_g2`` :495), which serve its Groth16 setup and prover
(``snark/groth16.py`` ``_g1_batch``, ``_g2_batch``, ``_msm``).

Tensors hold canonical little-endian 64-bit words in int64, the ABI of
that library (``native/__init__.py``): a G1 point is (x, y), 8 words; a G2
point is (x0, x1, y0, y1), 16 words, with x = x0 + x1 u over
Fq2 = Fq[u]/(u^2 + 1); all-zero words are the point at infinity.  Scalars
are (n, 4) words of canonical Fr values (below r).

  * ``msm_g1(points, scalars)`` / ``msm_g2``: sum_i k_i P_i as a Jacobian
    triple of canonical words, (3, 4) for G1 and (3, 8) for G2 (Z = 0 at
    infinity, where the triple is (0, 1, 0)); ``to_affine_g1`` /
    ``to_affine_g2`` turn it into host Python ints.  On a CUDA tensor they
    launch the ``bn254_msm_g1`` / ``bn254_msm_g2`` kernels
    (``csrc/bn254_msm.cuh``, built as ``bn254_msm_g1.cu`` and
    ``bn254_msm_g2.cu``): Pippenger with signed c-bit digits, the entries
    ordered by one ``torch.sort`` of 32-bit keys (glue, ``msm_schedule``),
    bucket sums over chunks of equal length with their edges reduced level
    by level, running sums over segments level by level, a tree over each
    window and the windows' combination, every launch sized by
    ``msm_plan(n, c)`` so that nothing waits for the host.  On a CPU
    tensor they run the plain version ``_msm_plain``: a double-and-add over
    all points at once, then a pairwise sum.  ``_msm_model`` is the
    kernels' schedule step by step in plain PyTorch, for the tests.
  * ``fixed_base_g1(gen, scalars)`` / ``fixed_base_g2``: k_i gen for a
    batch of scalars, affine words, (n, 8) / (n, 16), zero words for
    k_i = 0.  ``gen`` is a host affine point (Python ints).  Both walk
    the 8-bit windows of a scalar over a table of d 2^(8w) gen (32 x 255
    points, built on the host once a generator and device) with one
    mixed addition a nonzero byte, then normalise to affine with one
    inversion a group of lanes (Montgomery's trick): the kernels
    ``bn254_fixed_base_g1`` / ``bn254_fixed_base_g2`` one thread a scalar
    and one inversion a block, the plain version ``_fixed_base_plain``
    all scalars at once in groups of the kernel's block width.

The plain versions compute on ``ops/bn254_mont.py`` (Fq in plain
Montgomery limbs, Fq2 as (..., 2, L) pairs); they serve the CPU tests and
the comparisons on the card, and nothing on the card's path calls them.
"""

from __future__ import annotations

import functools
import math
import random

import numpy as np
import torch

from .. import kernels
from ..fields import bn254, bn254_tower
from .bn254_mont import FQ, MONT, L, conv, from_words, to_words

P, R = bn254.P, bn254.R
SCALAR_BITS = 254           # r < 2^254
FB_WINDOWS = 32             # the fixed-base table's 8-bit windows
FB_DIGITS = 255             # its entries a window, d = 1..255

PLAIN_CHUNK = 1 << 14       # rows of the plain versions at a time
MAX_WINDOW_BITS = 20        # the widest window window_bits chooses
MIXED_PRODUCTS = 11         # field products of a mixed addition (7 M + 4 S)
FULL_PRODUCTS = 16          # of a full one (11 M + 5 S)
# the MSM kernels' schedule (csrc/bn254_msm.cuh; a CPU test reads them)
MSM_NONE = 0x7FFFFFFF       # the key of a zero digit: it sorts last
NONE_BUCKET = MSM_NONE >> 1     # its bucket, and an empty edge item's
CHUNK = 64                  # sorted entries a thread of the bucket sums adds
EDGE_CHUNK = 16             # edge items a thread of a level adds
SEGMENT = 16                # buckets of a first-level running-sum segment
SEGMENT_BITS = 4            # log2(SEGMENT)
SEGMENT_HI = 4              # items of a segment of a higher level
SEGMENT_HI_BITS = 2         # log2(SEGMENT_HI)
FAN = 4                     # items a node of the window tree adds


# ---------------------------------------------------------------------------
# Host conversions
# ---------------------------------------------------------------------------

def g1_words(points) -> np.ndarray:
    """Affine G1 points (Python ints, None = infinity) -> (n, 8) int64."""
    return to_words(v for pt in points
                    for v in ((0, 0) if pt is None else pt)).reshape(-1, 8)


def g2_words(points) -> np.ndarray:
    """Affine G2 points (((x0, x1), (y0, y1)) or None) -> (n, 16) int64."""
    return to_words(v for pt in points for v in (
        (0, 0, 0, 0) if pt is None else (*pt[0], *pt[1]))).reshape(-1, 16)


def g1_points(t) -> list:
    """(n, 8) int64 words -> affine G1 points (None for zero words)."""
    vals = from_words(t.reshape(-1, 4))
    return [None if vals[i] == 0 and vals[i + 1] == 0
            else (vals[i], vals[i + 1]) for i in range(0, len(vals), 2)]


def g2_points(t) -> list:
    """(n, 16) int64 words -> affine G2 points (None for zero words)."""
    vals = from_words(t.reshape(-1, 4))
    return [None if not any(vals[i:i + 4])
            else ((vals[i], vals[i + 1]), (vals[i + 2], vals[i + 3]))
            for i in range(0, len(vals), 4)]


def to_affine_g1(jac):
    """(3, 4) Jacobian words -> affine (x, y) Python ints, or None."""
    x, y, z = from_words(jac.reshape(3, 4))
    return bn254.g1_to_affine((x, y, z))


def to_affine_g2(jac):
    """(3, 8) Jacobian words -> affine ((x0, x1), (y0, y1)), or None."""
    x0, x1, y0, y1, z0, z1 = from_words(jac.reshape(6, 4))
    if z0 == 0 and z1 == 0:
        return None
    zi = bn254_tower.fq2_inv((z0, z1))
    zi2 = bn254_tower.fq2_sqr(zi)
    return (bn254_tower.fq2_mul((x0, x1), zi2),
            bn254_tower.fq2_mul((y0, y1), bn254_tower.fq2_mul(zi2, zi)))


# ---------------------------------------------------------------------------
# The plain version: Jacobian arithmetic over plain Montgomery limbs
# ---------------------------------------------------------------------------

class _Fq:
    """Fq on (..., L) limbs (bn254_mont.FQ) with a point's helpers."""
    dims = 1
    words = 4
    block = 640             # the fixed-base kernel's block width
                            # (FixedBaseShape, csrc/bn254_msm.cuh)
    mul, add, sub, small = FQ.mul, FQ.add, FQ.sub, FQ.small
    reduce, is_zero = FQ.reduce, FQ.is_zero
    to_mont = FQ.to_mont                # (..., 4) -> (..., L)
    from_mont = FQ.from_mont            # (..., L) -> (..., 4)

    def one(self, shape, device):
        return FQ.const(1, device).expand(*shape, L).clone()

    def inv(self, a):
        """a^(p - 2) by square and multiply (a^-1; 0 for 0)."""
        out = self.one(a.shape[:-1], a.device)
        for bit in bin(P - 2)[2:]:
            out = self.mul(out, out)
            if bit == "1":
                out = self.mul(out, a)
        return out


class _Fq2(_Fq):
    """Fq2 = Fq[u]/(u^2 + 1) on (..., 2, L) limbs: (c0, c1) = c0 + c1 u."""
    dims = 2
    words = 8
    block = 128

    def mul(self, a, b):
        """(a0 b0 - a1 b1, a0 b1 + a1 b0): the four products' columns are
        summed before one reduction each (-a1 b1 as a1 (256 p - b1'), b1'
        the reduced b1, so that any operand below 600 p will do)."""
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        nb1 = FQ.sub(torch.zeros_like(b1), FQ.reduce(b1))
        cols = conv(torch.stack([a0, a0, a1, a1], dim=-2),
                    torch.stack([b0, b1, nb1, b0], dim=-2))
        return FQ.redc(torch.stack([cols[..., 0, :] + cols[..., 2, :],
                                    cols[..., 1, :] + cols[..., 3, :]],
                                   dim=-2))

    def is_zero(self, a):
        return FQ.is_zero(a).all(-1)

    def to_mont(self, w):               # (..., 8) -> (..., 2, L)
        return FQ.to_mont(w.reshape(*w.shape[:-1], 2, 4))

    def from_mont(self, x):             # (..., 2, L) -> (..., 8)
        return FQ.from_mont(x).reshape(*x.shape[:-2], 8)

    def one(self, shape, device):
        one = torch.stack([FQ.const(1, device), FQ.const(0, device)])
        return one.expand(*shape, 2, L).clone()

    def inv(self, a):
        """(a0 - a1 u) / (a0^2 + a1^2)."""
        a0, a1 = a[..., 0, :], a[..., 1, :]
        d = _Fq().inv(FQ.add(FQ.mul(a0, a0), FQ.mul(a1, a1)))
        return torch.stack([FQ.mul(a0, d),
                            FQ.mul(FQ.sub(torch.zeros_like(a1), a1), d)],
                           dim=-2)


FQ1_OPS, FQ2_OPS = _Fq(), _Fq2()
# a block of either fixed-base kernel's cases (fixed_base_cases)
FB_CASE_BLOCK = math.lcm(FQ1_OPS.block, FQ2_OPS.block)


def _where(F, mask, a, b):
    return torch.where(mask.reshape(*mask.shape, *([1] * F.dims)), a, b)


def _pick(F, mask, p1, p2):
    """Point-wise select of (x, y, z, inf) tuples."""
    return tuple(_where(F, mask, a, b) for a, b in zip(p1[:3], p2[:3])) + (
        torch.where(mask, p1[3], p2[3]),)


def _muls(F, *pairs):
    """The products of independent (a, b) pairs as one batched product."""
    out = F.mul(torch.stack([a for a, _ in pairs]),
                torch.stack([b for _, b in pairs]))
    return out.unbind(0)


def _double(F, pt):
    """2 P in Jacobian coordinates (y^2 = x^3 + b, a = 0): dbl-2009-l with
    D = 4 X B and Y3 = E (3 D - F) - 8 C.  Coordinates stay below 600
    moduli, the differences' subtrahends below 240 (ops/bn254_mont.py).
    The groups have odd prime order r, so no point but infinity doubles
    to infinity."""
    x, y, z, inf = pt
    a, b, yz = _muls(F, (x, x), (y, y), (y, z))
    c, xb = _muls(F, (b, b), (x, b))
    d = F.small(xb, 4)
    e = F.small(a, 3)
    (f,) = _muls(F, (e, e))
    (et,) = _muls(F, (e, F.sub(F.small(d, 3), f)))
    return (F.sub(f, F.small(d, 2)), F.sub(et, F.small(c, 8)),
            F.small(yz, 2), inf)


def _add_parts(F, p1, p2):
    """add-2007-bl: (X3, Y3, Z3, H, S2 - S1), X3 = r^2 - J - 2 V and
    Y3 = r (3 V + J - r^2) - 2 S1 J; right when P1 != +-P2."""
    x1, y1, z1, _ = p1
    x2, y2, z2, _ = p2
    z1z1, z2z2, y1z2, y2z1, z1z2 = _muls(F, (z1, z1), (z2, z2), (y1, z2),
                                         (y2, z1), (z1, z2))
    u1, u2, s1, s2 = _muls(F, (x1, z2z2), (x2, z1z1), (y1z2, z2z2),
                           (y2z1, z1z1))
    h, rr = F.sub(u2, u1), F.sub(s2, s1)
    hh, r = F.small(h, 2), F.small(rr, 2)
    i, r2, zh = _muls(F, (hh, hh), (r, r), (z1z2, h))
    j, v = _muls(F, (h, i), (u1, i))
    t = F.sub(F.add(F.small(v, 3), j), r2)
    rt, s1j = _muls(F, (r, t), (s1, j))
    x3 = F.sub(F.sub(r2, j), F.small(v, 2))
    return x3, F.sub(rt, F.small(s1j, 2)), F.small(zh, 2), h, rr


def _add_distinct(F, p1, p2):
    """P1 + P2 where P1 != +-P2 unless one of them is at infinity: the
    steps of a double-and-add with a scalar below r."""
    x3, y3, z3, _h, _rr = _add_parts(F, p1, p2)
    out = (x3, y3, z3, torch.zeros_like(p1[3]))
    out = _pick(F, p2[3], p1, out)
    return _pick(F, p1[3], p2, out)


def _add(F, p1, p2):
    """P1 + P2 in Jacobian coordinates, every case: an infinite operand,
    P1 = P2 (the doubling) and P1 = -P2 (infinity)."""
    x3, y3, z3, h, rr = _add_parts(F, p1, p2)
    zero = F.is_zero(torch.stack([h, rr]))
    h0, r0 = zero[0], zero[1]
    out = (x3, y3, z3, h0 & ~r0)
    if bool((h0 & r0).any()):           # P1 = P2 somewhere: the doubling
        out = _pick(F, h0 & r0, _double(F, p1), out)
    out = _pick(F, p2[3], p1, out)
    return _pick(F, p1[3], p2, out)


def _infinity(F, n, device):
    one = F.one((n,), device)
    return (one, one, torch.zeros_like(one),
            torch.ones(n, dtype=torch.bool, device=device))


def _affine_in(F, words):
    """(n, 2 * F.words) canonical affine words -> Jacobian (Z = 1)."""
    n = words.shape[0]
    w = F.words
    inf = (words == 0).all(-1)
    return (F.to_mont(words[:, :w]), F.to_mont(words[:, w:]),
            F.one((n,), words.device), inf)


def _jacobian_out(F, pt):
    """A Jacobian point -> (3, F.words) canonical words ((0, 1, 0) at
    infinity)."""
    x, y, z, inf = pt
    out = torch.stack([F.from_mont(x), F.from_mont(y), F.from_mont(z)])
    unit = torch.zeros_like(out)
    unit[1, 0] = 1
    return torch.where(inf, unit, out)


def _bits(scalars, nbits: int):
    """(n, 4) int64 words -> (nbits, n) bool, bit j in row j."""
    j = torch.arange(nbits, device=scalars.device)
    return ((scalars[:, j // 64] >> (j % 64)) & 1).T.bool()


def _pairwise_sum(F, acc):
    """The sum of a batch of points by pairwise additions (batch of 1)."""
    while acc[0].shape[0] > 1:
        if acc[0].shape[0] % 2:
            acc = tuple(torch.cat([a, b]) for a, b in
                        zip(acc, _infinity(F, 1, acc[0].device)))
        acc = _add(F, tuple(a[0::2] for a in acc),
                   tuple(a[1::2] for a in acc))
    return acc


def _msm_plain(F, points, scalars):
    """Plain PyTorch version of the MSM kernels: every k_i P_i by one
    double-and-add (most significant bit first) over all points of a
    chunk at once, then a pairwise sum; a Jacobian triple of canonical
    words."""
    n = points.shape[0]
    dev = points.device
    sums = [_infinity(F, 1, dev)]
    for i in range(0, n, PLAIN_CHUNK):
        base = _affine_in(F, points[i:i + PLAIN_CHUNK])
        acc = _infinity(F, base[0].shape[0], dev)
        bits = _bits(scalars[i:i + PLAIN_CHUNK], SCALAR_BITS)
        for j in range(SCALAR_BITS - 1, -1, -1):
            acc = _double(F, acc)
            acc = _pick(F, bits[j], _add_distinct(F, acc, base), acc)
        sums.append(_pairwise_sum(F, acc))
    total = _pairwise_sum(F, tuple(torch.cat(c) for c in zip(*sums)))
    return _jacobian_out(F, tuple(a[0] for a in total))


@functools.lru_cache(maxsize=8)
def _powers_of_two(gen) -> tuple:
    """2^j gen for j < SCALAR_BITS, affine, host Python ints (G1 or G2)."""
    out, cur = [], gen
    for _ in range(SCALAR_BITS):
        out.append(cur)
        if isinstance(gen[0], tuple):
            cur = bn254_tower.g2_double(cur)
        else:
            cur = bn254.g1_to_affine(bn254.g1_double(bn254.g1_from_affine(
                cur)))
    return tuple(out)


def _host_batch_inv(vals, mul, inv) -> list:
    """The inverses of nonzero host field elements with one inversion
    (Montgomery's trick)."""
    pre = [vals[0]]
    for v in vals[1:]:
        pre.append(mul(pre[-1], v))
    acc = inv(pre[-1])
    out = [None] * len(vals)
    for k in range(len(vals) - 1, 0, -1):
        out[k] = mul(acc, pre[k - 1])
        acc = mul(acc, vals[k])
    out[0] = acc
    return out


@functools.lru_cache(maxsize=8)
def _window_table(gen) -> tuple:
    """The fixed-base table: entry w * FB_DIGITS + d - 1 is d 2^(8w) gen
    (w < FB_WINDOWS, 1 <= d <= FB_DIGITS), affine, host Python ints (G1
    or G2).  Each window adds its base 2^(8w) gen to its last entry (the
    tangent for d = 2, a chord after), the 32 windows' slope denominators
    inverted together at each step."""
    if isinstance(gen[0], tuple):
        tw = bn254_tower
        mul, sub, inv, scale = tw.fq2_mul, tw.fq2_sub, tw.fq2_inv, \
            tw.fq2_mul_scalar
    else:
        def mul(a, b):
            return a * b % P

        def sub(a, b):
            return (a - b) % P
        inv, scale = bn254.fq_inv, mul
    bases = [_powers_of_two(gen)[8 * w] for w in range(FB_WINDOWS)]
    rows = [[b] for b in bases]
    for d in range(2, FB_DIGITS + 1):
        last = [row[-1] for row in rows]
        if d == 2:
            num = [scale(mul(x, x), 3) for x, _ in last]
            den = [scale(y, 2) for _, y in last]
        else:
            num = [sub(b[1], q[1]) for q, b in zip(last, bases)]
            den = [sub(b[0], q[0]) for q, b in zip(last, bases)]
        for row, q, b, nu, di in zip(rows, last, bases, num,
                                     _host_batch_inv(den, mul, inv)):
            lam = mul(nu, di)
            x = sub(sub(mul(lam, lam), q[0]), b[0])
            row.append((x, sub(mul(lam, sub(q[0], x)), q[1])))
    return tuple(pt for row in rows for pt in row)


def _table_words(gen) -> np.ndarray:
    pts = _window_table(gen)
    return g2_words(pts) if isinstance(gen[0], tuple) else g1_words(pts)


def fixed_base_cases(n: int, seed: int, block: int = 0) -> list:
    """n scalars (Python ints) that hold every edge of the fixed-base
    kernels, for the tests and ``chip_smoke.py``: 0, 1, 255, 256, r - 1,
    r - 2, 2^253; every byte 0xFF below r (2^248 - 1 and
    0x2F 2^248 + 2^248 - 1); d 2^(8w) for d = 1 and 255 at every window
    w; r and 2 (0x31 2^248) - r, whose last additions meet -P and P (the
    H = 0 branches); then seeded scalars below r, with lanes
    [2 block, 3 block) zero (whole blocks at infinity) and lanes
    [3 block, 4 block) zero but lane 3 block + 77 (a block with one live
    lane).  `block` defaults to FB_CASE_BLOCK; n >= 4 block."""
    block = block or FB_CASE_BLOCK
    assert n >= 4 * block
    top = 1 << 248
    ks = [0, 1, 255, 256, R - 1, R - 2, 1 << 253, top - 1,
          0x2F * top + top - 1, R, 2 * 0x31 * top - R]
    ks += [d << (8 * w) for w in range(FB_WINDOWS) for d in (1, 255)]
    rng = random.Random(seed)
    ks += [rng.randrange(R) for _ in range(n - len(ks))]
    ks[2 * block:4 * block] = [0] * (2 * block)
    ks[3 * block + 77] = rng.randrange(1, R)
    return ks


def msm_cases(group: str, n: int, seed: int, c: int | None = None):
    """n affine host points ((a + i b) G of G1's or G2's generator, one
    host addition each) and n scalars (Python ints) that hold every edge
    of the MSM kernels, for the tests: a point at infinity (row 3), zero
    scalars (0, 1), r - 1 (2), a point repeated under one scalar (4, 5 and
    8..15), a point beside its negation under one scalar (6, 7), one point
    under the signed digits +d and -d in window 0 of c-bit windows (16,
    17; c = window_bits(n) by default), scalars whose every window holds
    the digit 2^(c - 1) (18) or -(2^(c - 1) - 1) (19), and scalar 1 on
    rows 32 .. n / 2 (a bucket of half the points, as Groth16's witnesses
    have, across many chunks of the bucket sums).  n >= 20."""
    rng = random.Random(seed)
    c = c or window_bits(n)
    if group == "g1":
        step = bn254.g1_mul(bn254.g1_from_affine(bn254.G1_GEN),
                            rng.randrange(R))
        cur = bn254.g1_mul(bn254.g1_from_affine(bn254.G1_GEN),
                           rng.randrange(R))
        pts = []
        for _ in range(n):
            pts.append(bn254.g1_to_affine(cur))
            cur = bn254.g1_add(cur, step)

        def neg(p):
            return p[0], (P - p[1]) % P
    else:
        step = bn254_tower.g2_mul(bn254_tower.G2_GEN, rng.randrange(R))
        cur = bn254_tower.g2_mul(bn254_tower.G2_GEN, rng.randrange(R))
        pts = []
        for _ in range(n):
            pts.append(cur)
            cur = bn254_tower.g2_add(cur, step)
        neg = bn254_tower.g2_neg
    sc = [rng.randrange(R) for _ in range(n)]
    pts[3] = None
    pts[5], sc[5] = pts[4], sc[4]
    pts[7], sc[7] = neg(pts[6]), sc[6]
    pts[8:16] = [pts[8]] * 8
    sc[8:16] = [sc[8]] * 8
    sc[0] = sc[1] = 0
    sc[2] = R - 1
    half = 1 << (c - 1)
    d = min(5, half - 1)
    pts[17] = pts[16]
    sc[16] = rng.randrange(R >> (c + 1)) << c | d
    sc[17] = rng.randrange(R >> (c + 1)) << c | ((1 << c) - d)
    windows = range(0, SCALAR_BITS - c, c)
    sc[18] = sum(half << w for w in windows)
    sc[19] = sum((half + 1) << w for w in windows)
    for i in range(32, n // 2):
        sc[i] = 1
    return pts, sc


def _batch_inverse(F, z):
    """z^-1 of nonzero (n, ...) values by Montgomery's trick over groups of
    F.block lanes, as the fixed-base kernel does over a block: a product
    tree up, one inversion a group, and back down (two products a node).
    Ones pad the last group and each group to a power of two."""
    n, tail = z.shape[0], z.shape[1:]
    groups = -(-n // F.block)
    level = F.one((groups, 1 << (F.block - 1).bit_length()), z.device)
    level[:, :F.block] = torch.cat(
        [z, F.one((groups * F.block - n,), z.device)]).reshape(
            groups, F.block, *tail)
    levels = []
    while level.shape[1] > 1:
        levels.append(level)
        level = F.mul(level[:, 0::2], level[:, 1::2])
    inv = F.inv(level)
    for level in reversed(levels):
        inv = torch.stack([F.mul(inv, level[:, 1::2]),
                           F.mul(inv, level[:, 0::2])], dim=2).reshape(
                               level.shape)
    return inv[:, :F.block].reshape(-1, *tail)[:n]


def _fixed_base_plain(F, gen, scalars):
    """Plain PyTorch version of the fixed-base kernels, step for step: the
    walk of the 8-bit table over all scalars of a chunk at once, then the
    affine normalisation with one inversion a group of the kernel's block
    width; (n, 2 * F.words) words, zeros for k = 0."""
    if scalars.shape[0] <= PLAIN_CHUNK:
        return _fixed_base_chunk(F, gen, scalars)
    return torch.cat([_fixed_base_chunk(F, gen, scalars[i:i + PLAIN_CHUNK])
                      for i in range(0, scalars.shape[0], PLAIN_CHUNK)])


def _fixed_base_chunk(F, gen, scalars):
    n = scalars.shape[0]
    dev = scalars.device
    tx, ty, tz, _ = _affine_in(F, torch.from_numpy(_table_words(gen)).to(dev))
    finite = torch.zeros(n, dtype=torch.bool, device=dev)
    acc = _infinity(F, n, dev)
    for w in range(FB_WINDOWS):
        d = (scalars[:, w // 8] >> (8 * (w % 8))) & 0xFF
        idx = w * FB_DIGITS + (d - 1).clamp(min=0)
        entry = (tx[idx], ty[idx], tz[idx], finite)
        acc = _pick(F, d != 0, _add(F, acc, entry), acc)
    x, y, z, inf = acc
    zi = _batch_inverse(F, _where(F, inf, F.one((n,), dev), z))
    zi2 = F.mul(zi, zi)
    out = torch.cat([F.from_mont(F.mul(x, zi2)),
                     F.from_mont(F.mul(y, F.mul(zi2, zi)))], dim=-1)
    return torch.where(inf[:, None], torch.zeros_like(out), out)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, width: int):
    if t.dim() != 2 or t.shape[1] != width or t.dtype != torch.int64:
        raise ValueError(f"{name}: (n, {width}) int64 words expected, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: a contiguous tensor expected")


def n_windows(c: int) -> int:
    """Signed c-bit windows of a scalar below 2^254: ceil(255 / c), so the
    top window takes the last carry (c = 2: 128 windows)."""
    return (SCALAR_BITS + c) // c


def window_bits(n: int) -> int:
    """The c minimising n_windows(c) (n MIXED_PRODUCTS + 2^c
    FULL_PRODUCTS): a mixed addition a digit of each of n points and two
    full additions a bucket (2^(c - 1) of them a window) for the running
    sums."""
    return min(range(2, MAX_WINDOW_BITS + 1), key=lambda c: (
        n_windows(c) * (n * MIXED_PRODUCTS + (1 << c) * FULL_PRODUCTS), c))


def _window_raw(scalars, off: int, c: int):
    """(n, 4) int64 words -> (n,) bits off .. off + c - 1 (c <= 20)."""
    word, bit = divmod(off, 64)
    if word >= 4:
        return torch.zeros_like(scalars[:, 0])
    d = scalars[:, word] >> bit
    if bit:
        d = d & ((1 << (64 - bit)) - 1)
    if bit + c > 64 and word < 3:
        d = d | (scalars[:, word + 1] << (64 - bit))
    return d & ((1 << c) - 1)


def signed_digits(scalars, c: int):
    """(n, 4) words (read below 2^254) -> (n_windows(c), n) int64 signed
    digits: window w's bits plus the carry t; t > 2^(c - 1) gives
    t - 2^c and a carry of 1, so every digit lies in
    (-2^(c - 1), 2^(c - 1)] and sum_w d_w 2^(c w) is the scalar.  The plain
    version of msm_prepare's digits (csrc/bn254_msm.cuh)."""
    s = scalars.clone()
    s[:, 3] &= (1 << (SCALAR_BITS - 192)) - 1
    half = 1 << (c - 1)
    carry = torch.zeros_like(s[:, 0])
    rows = []
    for w in range(n_windows(c)):
        t = _window_raw(s, w * c, c) + carry
        carry = (t > half).to(torch.int64)
        rows.append(t - (carry << c))
    return torch.stack(rows)


def msm_keys(points, scalars, c: int):
    """Plain version of msm_prepare's keys: (n_windows(c) n,) int32, entry
    w n + i the key 2 bucket + sign of point i's digit in window w (bucket
    w 2^(c - 1) + |d| - 1, sign 1 for d < 0), MSM_NONE for a zero digit or
    a point at infinity."""
    d = signed_digits(scalars, c)
    live = (points != 0).any(-1)
    w = torch.arange(d.shape[0], device=d.device)[:, None]
    key = ((w << (c - 1)) + d.abs() - 1) * 2 + (d < 0).to(torch.int64)
    key = torch.where((d != 0) & live, key, MSM_NONE)
    return key.reshape(-1).to(torch.int32)


def msm_schedule(keys):
    """The glue between msm_prepare and the bucket sums: one stable sort of
    the 32-bit keys (window, |digit|, sign; zero digits, MSM_NONE, last)
    -> (sorted keys, each entry's index w n + i).

    What bounds the MSM kernels is the 32-bit multiplies of their
    additions; what keeps them from that bound is additions that fall on
    the threads unevenly (a bucket of half the points, as Groth16's 0/1
    witnesses make, summed by few threads) or in long serial chains, and
    any wait for the host.  This schedule gives every thread of the
    bucket sums the same CHUNK sorted entries, whatever the buckets'
    sizes, reduces the chunks' edges level by level, and leaves nothing
    whose size depends on the data: both outputs are as long as the
    keys, n_windows(c) n, and every later launch is sized by
    msm_plan(n, c)."""
    return torch.sort(keys, stable=True)


def msm_plan(n: int, c: int) -> dict:
    """Every launch size of the MSM kernels, from n and c alone.
    ``chunks[0]``: the bucket sums' threads over the n_windows(c) n sorted
    entries, CHUNK each; ``chunks[k]``: level k's threads over the
    2 chunks[k - 1] edge items, EDGE_CHUNK each, until one is left.
    ``run_counts[j]`` items a window at running-sum level j in
    ``run_groups[j]`` segments (level 0: the 2^(c - 1) buckets in segments
    of SEGMENT; level j + 1: the totals of level j's segments 1, 2, ...,
    in segments of SEGMENT_HI);
    ``tree[k]`` items a window at the tree's level k, from the sum of
    run_groups down to 1."""
    windows = n_windows(c)
    entries = windows * n
    chunks = [-(-entries // CHUNK)]
    while chunks[-1] > 1:
        chunks.append(-(-2 * chunks[-1] // EDGE_CHUNK))
    counts, groups = [1 << (c - 1)], []
    while True:
        groups.append(-(-counts[-1] // (SEGMENT_HI if groups else SEGMENT)))
        if groups[-1] == 1:
            break
        counts.append(groups[-1] - 1)
    tree = [sum(groups)]
    while tree[-1] > 1:
        tree.append(-(-tree[-1] // FAN))
    return {"c": c, "windows": windows, "buckets": windows << (c - 1),
            "entries": entries, "chunks": chunks, "run_counts": counts,
            "run_groups": groups, "tree": tree}


# -- the step-by-step model of the kernels' schedule -------------------------

def _gather(pt, idx):
    return tuple(a[idx] for a in pt)


def _scatter(dst, idx, pt):
    for a, b in zip(dst, pt):
        a[idx] = b


def _chunk_level(F, bucket, item, length: int, buckets):
    """One level of msm_chunks over `bucket` (count,) int64 bucket ids
    (NONE_BUCKET for none), item(e) the points of entries e: all chunks at
    once, one entry of each a step.  Runs inside a chunk go to `buckets`;
    -> the edge items (bucket ids, points), or None for one chunk."""
    count = bucket.shape[0]
    chunks = -(-count // length)
    if chunks == 0:
        return None
    dev = bucket.device
    none = torch.full((1,), NONE_BUCKET, dtype=torch.int64, device=dev)
    start = torch.arange(chunks, device=dev) * length
    end = torch.clamp(start + length, max=count)
    padded = torch.cat([bucket, none.expand(chunks * length - count + 1)])
    before = torch.where(start > 0, padded[start - 1], none)
    after = padded[end]
    acc = _infinity(F, chunks, dev)
    cur, run = padded[start], start.clone()
    head_b, tail_b = none.repeat(chunks), none.repeat(chunks)
    head, tail = _infinity(F, chunks, dev), _infinity(F, chunks, dev)

    def flush(mask, e):
        nonlocal head, tail
        m = mask & (cur != NONE_BUCKET)
        from_before = (run == start) & (before == cur)
        on_after = (e == end) & (after == cur)
        to_head = m & from_before
        to_tail = m & ~from_before & on_after
        head_b[to_head] = cur[to_head]
        head = _pick(F, to_head, acc, head)
        tail_b[to_tail | (to_head & on_after)] = cur[
            to_tail | (to_head & on_after)]
        tail = _pick(F, to_tail, acc, tail)
        direct = m & ~from_before & ~on_after
        _scatter(buckets, cur[direct], _gather(acc, direct))

    for j in range(length):
        e = start + j
        valid = e < end
        b = padded[e]
        change = valid & (b != cur)
        flush(change, e)
        cur = torch.where(change, b, cur)
        run = torch.where(change, e, run)
        acc = _pick(F, change, _infinity(F, chunks, dev), acc)
        add = valid & (b != NONE_BUCKET)
        acc = _pick(F, add, _add(F, acc, item(torch.where(add, e, 0))), acc)
    flush(torch.ones_like(run, dtype=torch.bool), end)
    if chunks == 1:
        return None
    out_b = torch.stack([head_b, tail_b], 1).reshape(-1)
    out = tuple(torch.stack([h, t], 1).reshape(-1, *h.shape[1:])
                for h, t in zip(head, tail))
    return out_b, out


def _weighted_level(F, items, seg: int, bits: int):
    """One running-sum level (msm_running, msm_running_warp) over
    (windows, count) points (weights 1 .. count) in segments of `seg` =
    2^bits: the segments' sums and their totals times `seg`, each
    (windows, groups)."""
    windows, count = items[3].shape
    groups = -(-count // seg)
    pad = groups * seg - count
    dev = items[3].device
    inf = _infinity(F, windows * pad, dev)
    parts = tuple(torch.cat([a, b.reshape(windows, pad, *a.shape[2:])], 1)
                  .reshape(windows * groups, seg, *a.shape[2:])
                  for a, b in zip(items, inf))
    running = _infinity(F, windows * groups, dev)
    sums = _infinity(F, windows * groups, dev)
    for i in range(seg - 1, -1, -1):
        running = _add(F, running, tuple(a[:, i] for a in parts))
        sums = _add(F, sums, running)
    for _ in range(bits):
        running = _double(F, running)

    def shaped(pt):
        return tuple(a.reshape(windows, groups, *a.shape[1:]) for a in pt)
    return shaped(sums), shaped(running)


def _tree_level(F, items):
    """One level of msm_tree: (windows, count) points -> (windows,
    ceil(count / FAN)) sums of FAN consecutive items."""
    windows, count = items[3].shape
    groups = -(-count // FAN)
    pad = groups * FAN - count
    inf = _infinity(F, windows * pad, items[3].device)
    seg = tuple(torch.cat([a, b.reshape(windows, pad, *a.shape[2:])], 1)
                .reshape(windows * groups, FAN, *a.shape[2:])
                for a, b in zip(items, inf))
    acc = _infinity(F, windows * groups, items[3].device)
    for i in range(FAN):
        acc = _add(F, acc, tuple(a[:, i] for a in seg))
    return tuple(a.reshape(windows, groups, *a.shape[1:]) for a in acc)


def _msm_model(F, points, scalars, c: int | None = None):
    """The MSM kernels' schedule step by step in plain PyTorch, over
    ``_add`` / ``_double``: signed digits (msm_keys), the sort
    (msm_schedule), the chunks' bucket sums and their edge items level by
    level, the running sums over segments and the levels of their totals,
    the window tree and the combination; a Jacobian triple of canonical
    words.  Used by the tests and ``chip_smoke.py`` to hold the kernels'
    algorithm; the CPU path of msm_g1 / msm_g2 is ``_msm_plain``."""
    n = points.shape[0]
    dev = points.device
    c = c or window_bits(n)
    plan = msm_plan(n, c)
    windows, half = plan["windows"], 1 << (c - 1)
    keys, index = msm_schedule(msm_keys(points, scalars, c))
    keys = keys.to(torch.int64)
    base = _affine_in(F, points)
    none = keys == MSM_NONE

    def entry(e):
        k = keys[e]
        i = torch.where(none[e], 0, index[e] - (k >> c) * n)
        x, y = base[0][i], base[1][i]
        y = _where(F, (k & 1).bool(), F.sub(torch.zeros_like(y), y), y)
        return x, y, base[2][i], torch.zeros_like(none[e])

    buckets = tuple(a.clone() for a in _infinity(F, plan["buckets"], dev))
    level = _chunk_level(F, torch.where(none, NONE_BUCKET, keys >> 1), entry,
                         CHUNK, buckets)
    while level is not None:
        ids, pts = level
        level = _chunk_level(F, ids, lambda e, pts=pts: _gather(pts, e),
                             EDGE_CHUNK, buckets)
    items = tuple(a.reshape(windows, half, *a.shape[1:]) for a in buckets)
    slots = []
    for j, _ in enumerate(plan["run_groups"]):
        sums, items = _weighted_level(
            F, items, *((SEGMENT_HI, SEGMENT_HI_BITS) if j else
                        (SEGMENT, SEGMENT_BITS)))
        slots.append(sums)
        items = tuple(a[:, 1:] for a in items)
    items = tuple(torch.cat(a, 1) for a in zip(*slots))
    while items[3].shape[1] > 1:
        items = _tree_level(F, items)
    acc = _infinity(F, 1, dev)
    for w in range(windows - 1, -1, -1):
        if not bool(acc[3].all()):          # infinity doubles to itself
            for _ in range(c):
                acc = _double(F, acc)
        acc = _add(F, acc, tuple(a[w, :1] for a in items))
    return _jacobian_out(F, tuple(a[0] for a in acc))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, width: int):
    if t.dim() != 2 or t.shape[1] != width or t.dtype != torch.int64:
        raise ValueError(f"{name}: (n, {width}) int64 words expected, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: a contiguous tensor expected")


def _msm(name: str, F, points, scalars, c: int | None = None,
         stages: list | None = None):
    width = 2 * F.words
    _check(name, points, width)
    _check(name, scalars, 4)
    if points.shape[0] != scalars.shape[0] or points.device != scalars.device:
        raise ValueError(f"{name}: {points.shape[0]} points on "
                         f"{points.device}, {scalars.shape[0]} scalars on "
                         f"{scalars.device}")
    if points.device.type == "cpu":
        return _msm_plain(F, points, scalars)
    kernels.LAUNCHES[name] += 1
    return _msm_launch(name, F, points, scalars, c, stages)


def _msm_launch(name: str, F, points, scalars, c, stages):
    """The MSM kernels in the order of msm_plan(n, c): msm_prepare, the
    sort, msm_chunks (the bucket sums, then each edge level), msm_running
    (each level), msm_tree (each level), msm_combine.  `stages`, when a
    list, receives (stage, CUDA event recorded after it) pairs."""
    n = points.shape[0]
    dev = points.device
    plan = msm_plan(n, c or window_bits(n))
    c, windows = plan["c"], plan["windows"]
    jac = 3 * F.words                   # int64 words of a Jacobian point
    lib = kernels.load(name)
    stream = kernels.stream_ptr(dev)

    def launch(stage, *args):
        kernels.check(getattr(lib, f"{name}_{stage}")(*args, stream),
                      f"{name}_{stage}")

    def mark(stage):
        if stages is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stages.append((stage, ev))

    def item(t, k):                     # the address of point k of t
        return t.data_ptr() + k * jac * 8

    mark("start")
    mont = torch.empty_like(points)
    keys = torch.empty(plan["entries"], dtype=torch.int32, device=dev)
    launch("prepare", points.data_ptr(), scalars.data_ptr(), n, c, windows,
           mont.data_ptr(), keys.data_ptr())
    mark("prepare")
    keys, index = msm_schedule(keys)
    mark("sort")
    buckets = torch.zeros((plan["buckets"], jac), dtype=torch.int64,
                          device=dev)
    src, count, length = mont, plan["entries"], CHUNK
    for k, chunks in enumerate(plan["chunks"]):
        last = chunks <= 1
        out_keys = None if last else torch.empty(
            2 * chunks, dtype=torch.int32, device=dev)
        out_pts = None if last else torch.empty(
            (2 * chunks, jac), dtype=torch.int64, device=dev)
        launch("chunks", keys.data_ptr(), index.data_ptr() if k == 0 else 0,
               src.data_ptr(), n, c, count, chunks, length, int(k == 0),
               buckets.data_ptr(), 0 if last else out_keys.data_ptr(),
               0 if last else out_pts.data_ptr())
        mark("chunks" if k == 0 else "edges")
        keys, src, count, length = out_keys, out_pts, 2 * chunks, \
            EDGE_CHUNK
    groups = plan["run_groups"]
    slots = torch.empty((windows, sum(groups), jac), dtype=torch.int64,
                        device=dev)
    src, stride, offset = buckets.data_ptr(), 1 << (c - 1), 0
    hold = []                           # each level reads the one before
    for level, (count, g) in enumerate(zip(plan["run_counts"], groups)):
        totals = None if g == 1 else torch.empty(
            (windows, g, jac), dtype=torch.int64, device=dev)
        hold.append(totals)
        launch("running", src, stride, count, g, windows, level,
               item(slots, offset), sum(groups),
               0 if totals is None else totals.data_ptr())
        if totals is not None:
            src, stride = item(totals, 1), g
        offset += g
    mark("running")
    cur = slots
    for count, g in zip(plan["tree"], plan["tree"][1:]):
        nxt = torch.empty((windows, g, jac), dtype=torch.int64, device=dev)
        launch("tree", cur.data_ptr(), count, count, g, windows,
               nxt.data_ptr())
        cur = nxt
    mark("tree")
    out = torch.empty((3, F.words), dtype=torch.int64, device=dev)
    launch("combine", cur.data_ptr(), c, windows, out.data_ptr())
    mark("combine")
    return out


def msm_g1(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """sum_i k_i P_i over G1: (n, 8) affine words, (n, 4) scalars -> (3, 4)
    Jacobian words.  Wrapper of the ``bn254_msm_g1`` kernels: CPU tensors
    take the plain version."""
    return _msm("bn254_msm_g1", FQ1_OPS, points, scalars)


def msm_g2(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """sum_i k_i P_i over G2: (n, 16) affine words, (n, 4) scalars ->
    (3, 8) Jacobian words.  Wrapper of the ``bn254_msm_g2`` kernels: CPU
    tensors take the plain version."""
    return _msm("bn254_msm_g2", FQ2_OPS, points, scalars)


@functools.lru_cache(maxsize=8)
def _device_table(gen, device) -> torch.Tensor:
    """The kernels' table (``_window_table``) in Montgomery form
    (v 2^256 mod p), affine words."""
    pts = _window_table(gen)
    flat = [v for pt in pts for v in
            ((*pt[0], *pt[1]) if isinstance(gen[0], tuple) else pt)]
    return torch.from_numpy(to_words(v * MONT % P for v in flat)).to(device)


def _fixed_base(name: str, F, gen, scalars):
    _check(name, scalars, 4)
    gen = tuple(tuple(int(v) for v in c) for c in gen) \
        if isinstance(gen[0], tuple) else tuple(int(v) for v in gen)
    if scalars.device.type == "cpu":
        return _fixed_base_plain(F, gen, scalars)
    n = scalars.shape[0]
    out = torch.empty((n, 2 * F.words), dtype=torch.int64,
                      device=scalars.device)
    if n == 0:
        return out
    table = _device_table(gen, scalars.device)
    lib = kernels.load(name.replace("fixed_base", "msm"))
    kernels.LAUNCHES[name] += 1
    kernels.check(getattr(lib, f"{name}_launch")(
        table.data_ptr(), scalars.data_ptr(), out.data_ptr(), n,
        kernels.stream_ptr(scalars.device)), f"{name}_launch")
    return out


def fixed_base_g1(gen, scalars: torch.Tensor) -> torch.Tensor:
    """k_i gen over G1: `gen` affine (x, y) Python ints, (n, 4) scalars ->
    (n, 8) affine words.  Wrapper of the ``bn254_fixed_base_g1`` kernel:
    a CPU tensor takes the plain version."""
    return _fixed_base("bn254_fixed_base_g1", FQ1_OPS, gen, scalars)


def fixed_base_g2(gen, scalars: torch.Tensor) -> torch.Tensor:
    """k_i gen over G2: `gen` ((x0, x1), (y0, y1)) Python ints, (n, 4)
    scalars -> (n, 16) affine words.  Wrapper of the
    ``bn254_fixed_base_g2`` kernel: a CPU tensor takes the plain
    version."""
    return _fixed_base("bn254_fixed_base_g2", FQ2_OPS, gen, scalars)
