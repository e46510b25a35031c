"""Plain PyTorch Montgomery arithmetic modulo a 254-bit prime: BN254's
scalar field Fr (r) and base field Fq (p).

The plain versions of the BN254 kernels compute on it: Poseidon-BN254
(``ops/poseidon_bn254.py``, over Fr), the curve kernels
(``ops/bn254_msm.py``, over Fq and Fq2) and the Fr NTT (``ops/ntt_fr.py``).
The kernels' own arithmetic is ``csrc/bn254.cuh`` (8 x 32-bit words, CIOS,
R = 2^256, canonical values); nothing here models it: both compute the
same field elements, canonical on output.

An element is L = 17 int64 limbs of 16 bits, in Montgomery form with
R' = 2^272.  Limbs are kept "almost normal" (each in [0, 2^16 + 37]) and
values only bounded (a few moduli), never canonical, until the last
conversion.  A product is the limbs' convolution (34 columns, each below
2^41, summed in float64) followed by a Montgomery reduction REDC whose
steps are all parallel over the limbs: carry passes (x >> 16 added one
limb up), the quotient m = T N' mod R' as a product by a constant,
T + m p, and the division by R'.  Since p / R' < 2^-18, a product of two
values below 600 p comes out below 3.2 p, so sums and differences of a few
products need no reduction before the next product.  A product by
constants (Poseidon's MDS, S-vectors) is a float64 matmul against the
constant's Toeplitz matrix, exact because every sum stays below 2^53.

``sub(a, b)`` adds 256 p in a redundant form (every limb but the top one
at least 2^17 - 2), so it takes any b below 240 p with almost-normal
limbs and returns a - b + 256 p.  ``reduce(x)`` (a product by the
Montgomery form of 1) brings any value below 600 p back below 3.2 p.
"""

from __future__ import annotations

import functools
from itertools import repeat

import numpy as np
import torch

from ..fields.bn254 import P, R

L = 17
LIMB = 16
LMASK = (1 << LIMB) - 1
R_PLAIN = 1 << (LIMB * L)
SUB_MULTIPLE = 256          # sub() adds SUB_MULTIPLE * p
MONT = 1 << 256             # the kernels' Montgomery radix (csrc/bn254.cuh)


def to_words(values) -> np.ndarray:
    """Python ints in [0, 2^256) -> (len, 4) int64 little-endian 64-bit
    words: the tensors of the BN254 kernels (Fr and Fq values, curve
    coordinates, scalars)."""
    raw = b"".join(map(int.to_bytes, map(int, values), repeat(32),
                       repeat("little")))
    return np.frombuffer(raw, dtype=np.int64).reshape(-1, 4).copy()


def from_words(t) -> list:
    """(..., 4) 64-bit words (a tensor, or an int64 or uint64 array) ->
    the flat list of their Python ints."""
    a = np.ascontiguousarray(t.cpu().numpy() if torch.is_tensor(t) else t)
    if a.dtype not in (np.int64, np.uint64):
        raise ValueError(f"64-bit words expected, got {a.dtype}")
    raw = a.tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def limbs16(v: int, n: int = L) -> list:
    return [(v >> (LIMB * k)) & LMASK for k in range(n)]


def toeplitz(vec) -> np.ndarray:
    """(L, 2L) float64: x @ T is the convolution of x's limbs with vec."""
    out = np.zeros((L, 2 * L), dtype=np.float64)
    for a in range(L):
        out[a, a:a + L] = vec
    return out


def _redundant(v: int) -> list:
    """Limbs of v with 2^17 - 2 borrowed into every limb below the top:
    each of limbs 0..15 is at least 2^17 - 2, the value is v."""
    d = limbs16(v)
    d[0] += 1 << 17
    for k in range(1, L - 1):
        d[k] += (1 << 17) - 2
    d[L - 1] -= 2
    if d[L - 1] < 0 or sum(x << (LIMB * k) for k, x in enumerate(d)) != v:
        raise ValueError("no redundant form")
    return d


def carry(x, passes: int):
    """`passes` parallel carry passes over the last dim: each limb keeps
    its low 16 bits and hands the rest one limb up (the top limb's carry
    is dropped: the callers' bounds make it zero, or a multiple of R')."""
    for _ in range(passes):
        c = x >> LIMB
        x = x & LMASK
        x[..., 1:] += c[..., :-1]
    return x


SMALL_ROWS = 256            # conv: the outer product below this many rows


@functools.lru_cache(maxsize=None)
def _diagonals(device: torch.device) -> torch.Tensor:
    """(L L, 2L) float64 0/1: the flat outer product @ it sums each
    anti-diagonal, the convolution."""
    out = torch.zeros((L * L, 2 * L), dtype=torch.float64)
    for i in range(L):
        for j in range(L):
            out[i * L + j, i + j] = 1
    return out.to(device)


def conv(a, b):
    """(..., L) x (..., L) -> (..., 2L) limb convolution, summed in
    float64 (exact: the limbs stay below 2^18, so a column below 2^41).
    Few rows take the outer product and one matmul (fewer PyTorch calls),
    many rows L shifted products (less memory)."""
    af, bf = a.to(torch.float64), b.to(torch.float64)
    if af.numel() <= SMALL_ROWS * L:
        outer = (af.unsqueeze(-1) * bf.unsqueeze(-2)).reshape(
            *af.shape[:-1], L * L)
        return (outer @ _diagonals(a.device)).to(torch.int64)
    out = torch.zeros((*af.shape[:-1], 2 * L), dtype=torch.float64,
                      device=a.device)
    for i in range(L):
        out[..., i:i + L].addcmul_(af[..., i:i + 1], bf)
    return out.to(torch.int64)


class MontField:
    """Plain Montgomery arithmetic modulo the odd prime `p` (< 2^254) on
    16-bit limbs, R' = 2^272.  Every method is elementwise over the
    leading dims of (..., L) int64 limb tensors."""

    def __init__(self, p: int):
        if not 2 < p < 1 << 254 or p % 2 == 0:
            raise ValueError("an odd modulus below 2^254 expected")
        self.p = p
        self.n_prime = (-pow(p, -1, R_PLAIN)) % R_PLAIN
        self.r2 = R_PLAIN * R_PLAIN % p
        self.sub_limbs = _redundant(SUB_MULTIPLE * p)

    def mont(self, v: int) -> list:
        """Montgomery form of the Python int v, as 16-bit limbs."""
        return limbs16(v * R_PLAIN % self.p)

    def consts(self, device: torch.device) -> dict:
        return _consts(self, torch.device(device))

    def redc(self, T):
        """Montgomery reduction of (..., 2L) columns (each < 2^47): T / R'
        mod p as almost-normal limbs (each <= 2^16 + 37), value < T / R' +
        2.1 p.  Each carry pass shrinks a column by 16 bits; the passes
        below are the fewest that keep every float64 product exact and the
        division's carry to 0 or 1."""
        c = self.consts(T.device)
        T = carry(T, 1)                                   # limbs < 2^28.1
        m = (T[..., :L].to(torch.float64) @ c["n_t"]).to(torch.int64)
        m = carry(m, 2)                                   # m < 2.07 R'
        U = carry(T + (m.to(torch.float64) @ c["p_t"]).to(torch.int64), 2)
        # U's low L limbs (each <= 2^16 + 36) are divisible by R' and below
        # 2 R': they hold 0 or exactly R', which the division carries as 1
        out = U[..., L:].clone()
        out[..., 0] += (U[..., :L] != 0).any(-1).to(torch.int64)
        return out

    def mul(self, a, b):
        return self.redc(conv(a, b))

    def reduce(self, x):
        """The same element, its value below 3.2 p (x below 600 p)."""
        one = self.consts(x.device)["one"]
        return self.mul(x, one.expand_as(x))

    def add(self, a, b):
        return carry(a + b, 1)

    def sub(self, a, b):
        """a - b + 256 p (b below 240 p, almost-normal limbs)."""
        return carry(a + self.consts(a.device)["sub"] - b, 1)

    def small(self, a, k: int):
        """k a for a small int k >= 0."""
        return carry(a * k, 1)

    def to_mont(self, words):
        """(..., 4) int64 64-bit limbs (any 256-bit value) -> (..., L)
        Montgomery limbs of the value mod p."""
        parts = [(words[..., k // 4] >> (LIMB * (k % 4))) & LMASK
                 for k in range(16)]
        x = torch.stack(parts + [torch.zeros_like(parts[0])], dim=-1)
        r2 = self.consts(words.device)["r2"]
        return self.mul(x, r2.expand_as(x))

    def canonical_limbs(self, x):
        """(..., L) limbs of a value below 2^272 -> (..., L) exact 16-bit
        limbs of x / R' mod p, in [0, p) (the canonical element)."""
        p16 = self.consts(x.device)["p16"]
        y = self.redc(torch.nn.functional.pad(x, (0, L)))   # value < 2.1 p
        for k in range(L - 1):                              # exact carries
            y[..., k + 1] += y[..., k] >> LIMB
            y[..., k] &= LMASK
        for _ in range(2):                                  # y - p while >= p
            d = y - p16
            for k in range(L - 1):
                d[..., k + 1] += d[..., k] >> LIMB
                d[..., k] &= LMASK
            y = torch.where((d[..., L - 1] >= 0).unsqueeze(-1), d, y)
        return y

    def from_mont(self, x):
        """(..., L) Montgomery limbs -> (..., 4) canonical 64-bit limbs."""
        y = self.canonical_limbs(x)
        out = [y[..., 4 * w] | (y[..., 4 * w + 1] << 16)
               | (y[..., 4 * w + 2] << 32) | (y[..., 4 * w + 3] << 48)
               for w in range(4)]
        return torch.stack(out, dim=-1)

    def is_zero(self, x):
        """(..., L) -> (...) bool: the element is 0."""
        return (self.canonical_limbs(x) == 0).all(-1)

    def const(self, v: int, device) -> torch.Tensor:
        """(L,) Montgomery limbs of the Python int v on `device`."""
        return torch.tensor(self.mont(v), dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _consts(f: MontField, device: torch.device) -> dict:
    """The modulus's constant matrices and limbs on `device`."""
    def t64(v):
        return torch.tensor(v, dtype=torch.int64, device=device)
    return {"n_t": torch.from_numpy(toeplitz(limbs16(f.n_prime))[:, :L])
            .to(device),                                # m = T_low N' mod R'
            "p_t": torch.from_numpy(toeplitz(limbs16(f.p))).to(device),
            "r2": t64(limbs16(f.r2)), "p16": t64(limbs16(f.p)),
            "one": t64(f.mont(1)), "sub": t64(f.sub_limbs)}


FR = MontField(R)            # BN254's scalar field
FQ = MontField(P)            # BN254's base field
