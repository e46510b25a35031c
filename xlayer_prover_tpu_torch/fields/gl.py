"""Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on int64 tensors.

Counterpart of ``xlayer_prover_tpu/fields/gl.py``.  An element is its
64-bit pattern in an ``int64`` tensor (``device.py``); results are
canonical (< p as unsigned).  ``add``/``sub``/``neg`` are plain PyTorch ops
with unsigned compares.  ``mul`` is the CUDA kernel ``gl_mul``
(``csrc/gl_mul.cu``) on a CUDA tensor and its plain version
(``_mul_plain``: four 32-bit half products + the branch-free reduction)
on a CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as dev
from .. import kernels
from ..device import MASK32, SIGN, from_u64_np, to_u64_np  # noqa: F401

P = (1 << 64) - (1 << 32) + 1
P_I64 = P - (1 << 64)              # int64 pattern of p
EPSILON = 0xFFFFFFFF               # 2^32 - 1 == 2^64 mod p
_P_FLIP = P_I64 ^ SIGN             # p in sign-flipped (unsigned) order

GENERATOR = 7
SHIFT = 7
TWO_ADICITY = 32

DTYPE = torch.int64


# ---------------------------------------------------------------------------
# Host-side scalar helpers (python ints, exact)
# ---------------------------------------------------------------------------

def host_inv(a: int) -> int:
    return pow(a, P - 2, P)


@functools.lru_cache(maxsize=None)
def host_w(nbits: int) -> int:
    """2^nbits-th primitive root of unity (Goldilocks::w(nbits))."""
    assert 0 <= nbits <= TWO_ADICITY
    return pow(GENERATOR, (P - 1) >> nbits, P)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=DTYPE, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=DTYPE, device=device)


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, dev.i64(int(value) % P), dtype=DTYPE,
                      device=device)


# ---------------------------------------------------------------------------
# Field ops (elementwise; any 64-bit pattern in, canonical out)
# ---------------------------------------------------------------------------

def _cond_sub_p(x):
    return torch.where((x ^ SIGN) >= _P_FLIP, x - P_I64, x)


def add(a, b):
    s = a + b                                   # wraps mod 2^64
    s = torch.where(dev.ult(s, a), s + EPSILON, s)
    return _cond_sub_p(s)


def sub(a, b):
    d = a - b
    d = torch.where(dev.ult(a, b), d - EPSILON, d)
    return _cond_sub_p(d)


def neg(a):
    return torch.where(a == 0, a, P_I64 - a)


def _mul_wide(a, b):
    """Full 64x64 -> (lo64, hi64) from four 32-bit half products."""
    a_lo = a & MASK32
    a_hi = (a >> 32) & MASK32
    b_lo = b & MASK32
    b_hi = (b >> 32) & MASK32
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    lo = a * b                                  # wrapping low 64
    t = hl + ((ll >> 32) & MASK32)
    u = lh + (t & MASK32)
    hi = hh + ((t >> 32) & MASK32) + ((u >> 32) & MASK32)
    return lo, hi


def _reduce128(lo, hi):
    """hi * 2^64 + lo mod p, canonical (plonky2-style, branch-free)."""
    hi_hi = (hi >> 32) & MASK32
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    t0 = torch.where(dev.ult(lo, hi_hi), t0 - EPSILON, t0)
    t1 = hi_lo * EPSILON
    r = t0 + t1
    r = torch.where(dev.ult(r, t0), r + EPSILON, r)
    return _cond_sub_p(r)


def _mul_plain(a, b):
    """Plain PyTorch version of the gl_mul kernel (any device)."""
    return _reduce128(*_mul_wide(a, b))


@functools.lru_cache(maxsize=None)
def _gl_mul_max_blocks(device: torch.device) -> int:
    """Grid cap of gl_mul: 64 blocks of 256 threads per SM of the card."""
    return torch.cuda.get_device_properties(device).multi_processor_count * 64


def gl_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapper of the ``gl_mul`` kernel: `a` and `b` of one shape, or `b`
    0-d.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if a.device.type == "cpu":
        return _mul_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gl_mul: tensors on {a.device} and {b.device}")
    if a.dtype != DTYPE or b.dtype != DTYPE:
        raise TypeError("gl_mul: int64 tensors expected")
    b_scalar = b.dim() == 0
    if not b_scalar and b.shape != a.shape:
        raise ValueError(f"gl_mul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gl_mul: contiguous tensors expected")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = kernels.load("gl_mul")
    kernels.LAUNCHES["gl_mul"] += 1
    kernels.check(lib.gl_mul_launch(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), a.numel(), int(b_scalar),
                                    _gl_mul_max_blocks(a.device),
                                    kernels.stream_ptr(a.device)),
                  "gl_mul_launch")
    return out


def mul(a, b):
    """a * b mod p with broadcasting: a one-element operand goes to the
    kernel as its scalar; other shapes are broadcast first."""
    if a.shape == b.shape:
        return gl_mul(a.contiguous(), b.contiguous())
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if b.numel() == 1:
        return gl_mul(a.expand(shape).contiguous(), b.reshape(()))
    if a.numel() == 1:
        return gl_mul(b.expand(shape).contiguous(), a.reshape(()))
    a, b = torch.broadcast_tensors(a, b)
    return gl_mul(a.contiguous(), b.contiguous())


def sqr(a):
    return mul(a, a)


def mul_const(a, c: int):
    return mul(a, dev.scalar(int(c) % P, a.device))


def exp_const(a, e: int):
    """a ** e for a host-known exponent (square-and-multiply)."""
    e %= (P - 1)
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = sqr(base)
    return result


def inv(a):
    """Fermat inverse a^(p-2), a Python loop over the 64 exponent bits.
    inv(0) = 0 by convention."""
    e = P - 2
    acc = torch.ones_like(a)
    base = a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            acc = mul(acc, base)
        base = sqr(base)
    return torch.where(a == 0, a, acc)


def scan_mul(x, reverse: bool = False):
    """Inclusive prefix product along dim 0 (log-step, Hillis-Steele)."""
    n = x.shape[0]
    d = 1
    while d < n:
        if reverse:
            x = torch.cat([mul(x[:n - d], x[d:]), x[n - d:]])
        else:
            x = torch.cat([x[:d], mul(x[d:], x[:n - d])])
        d *= 2
    return x


def batch_inv(a):
    """Montgomery batch inversion along dim 0 via two log-step scans;
    zeros map to zero."""
    is_zero = a == 0
    a = torch.where(is_zero, torch.ones_like(a), a)
    pre = scan_mul(a)
    suf = scan_mul(a, reverse=True)
    inv_total = inv(pre[-1:])
    one = torch.ones_like(a[:1])
    pre_excl = torch.cat([one, pre[:-1]])
    suf_excl = torch.cat([suf[1:], one])
    out = mul(mul(pre_excl, suf_excl), inv_total)
    return torch.where(is_zero, torch.zeros_like(out), out)


def sum_axis(a, axis: int = 0):
    """Modular sum along `axis` via a halving tree."""
    a = a.movedim(axis, 0)
    n = a.shape[0]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    if m != n:
        pad = torch.zeros((m - n,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        a = torch.cat([a, pad])
    while m > 1:
        m //= 2
        a = add(a[:m], a[m:2 * m])
    return a[0]


def powers_device(base: int, n: int, device, start: int = 1):
    """[start * base^k for k < n] built on the device by doubling."""
    assert n >= 1
    cur = full((1,), start, device)
    length = 1
    b_pow = int(base) % P
    while length < n:
        step = min(length, n - length)
        cur = torch.cat([cur, mul_const(cur[:step], b_pow)])
        b_pow = (b_pow * b_pow) % P
        length += step
    return cur
