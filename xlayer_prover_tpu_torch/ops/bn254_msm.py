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
    ``bn254_msm_g2.cu``): Pippenger with c-bit windows, the points
    grouped by digit with ``torch.sort`` (glue), the bucket sums, the
    windows' running sums and their combination on the card.  On a CPU
    tensor they run the plain version ``_msm_plain``: a double-and-add over
    all points at once, then a pairwise sum.
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
# the kernels' launch shapes (csrc/bn254_msm.cuh)
MIN_RUN = 16                # the shortest run of points a thread sums
SEGMENTS = 256              # running-sum segments a window, at most


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


def window_bits(n: int) -> int:
    """The c minimising ceil(254 / c) (n + 2^(c + 1)): the bucket
    additions and the running sums of Pippenger with c-bit windows."""
    return min(range(2, 21), key=lambda c: (
        -(-SCALAR_BITS // c) * (n + (1 << (c + 1))), c))


def _digits(scalars, c: int, n_windows: int):
    """(n, 4) words -> (n_windows, n) int64 c-bit digits (window w holds
    bits w c .. w c + c - 1)."""
    mask = (1 << c) - 1
    rows = []
    for w in range(n_windows):
        off = w * c
        word, bit = off // 64, off % 64
        d = (scalars[:, word] >> bit) & ((1 << (64 - bit)) - 1)
        if bit + c > 64 and word < 3:
            d = d | (scalars[:, word + 1] << (64 - bit))
        rows.append(d & mask)
    return torch.stack(rows)


def msm_schedule(points, scalars):
    """The glue of the MSM kernels, on the points' device: the window
    bits c, the point of every (window, digit) entry in digit order, and
    the runs of at most `k` entries of one bucket that a thread of the
    first kernel sums (a bucket of many entries is cut into runs of about
    sqrt(its size), whose sums the second kernel adds).  Zero digits and
    points at infinity take no part.  -> dict"""
    n = points.shape[0]
    dev = points.device
    c = window_bits(n)
    n_windows = -(-SCALAR_BITS // c)
    nb = 1 << c
    digits = _digits(scalars, c, n_windows)
    digits[:, (points == 0).all(-1)] = 0
    keys = (torch.arange(n_windows, device=dev)[:, None] * nb
            + digits).reshape(-1)
    order = torch.sort(keys).indices
    counts = torch.bincount(keys, minlength=n_windows * nb)
    starts = torch.cumsum(counts, 0) - counts
    live = counts.clone()
    live[::nb] = 0                                   # digit 0: no bucket
    k = max(MIN_RUN, math.isqrt(int(live.max())) + 1)
    n_runs = (live + k - 1) // k
    first = torch.zeros(n_windows * nb + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(n_runs, 0)
    bucket = torch.repeat_interleave(
        torch.arange(n_windows * nb, device=dev), n_runs)
    j = torch.arange(bucket.shape[0], device=dev) - first[bucket]
    run_start = starts[bucket] + j * k
    run_end = torch.minimum(run_start + k, starts[bucket] + counts[bucket])
    return {"c": c, "n_windows": n_windows,
            "point": (order % max(n, 1)).to(torch.int32),
            "run_start": run_start.to(torch.int32),
            "run_end": run_end.to(torch.int32),
            "first_run": first.to(torch.int32)}


def _msm(name: str, F, points, scalars):
    width = 2 * F.words
    _check(name, points, width)
    _check(name, scalars, 4)
    if points.shape[0] != scalars.shape[0] or points.device != scalars.device:
        raise ValueError(f"{name}: {points.shape[0]} points on "
                         f"{points.device}, {scalars.shape[0]} scalars on "
                         f"{scalars.device}")
    if points.device.type == "cpu":
        return _msm_plain(F, points, scalars)
    dev = points.device
    out = torch.empty((3, F.words), dtype=torch.int64, device=dev)
    sched = msm_schedule(points, scalars)
    c, n_windows = sched["c"], sched["n_windows"]
    n_runs = sched["run_start"].shape[0]
    n_buckets = n_windows << c
    segments = min(SEGMENTS, (1 << c) - 1)
    jac = 3 * F.words                   # int64 words of a Jacobian point
    scratch = torch.empty(
        (points.shape[0] * width + (n_runs + n_buckets + n_windows
                                    * (segments + 1)) * jac,),
        dtype=torch.int64, device=dev)
    lib = kernels.load(name)
    kernels.LAUNCHES[name] += 1
    kernels.check(getattr(lib, f"{name}_launch")(
        points.data_ptr(), points.shape[0], sched["point"].data_ptr(),
        sched["run_start"].data_ptr(), sched["run_end"].data_ptr(), n_runs,
        sched["first_run"].data_ptr(), c, n_windows, segments,
        scratch.data_ptr(), out.data_ptr(), kernels.stream_ptr(dev)),
        f"{name}_launch")
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
