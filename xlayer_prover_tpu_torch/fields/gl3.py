"""Cubic extension of Goldilocks: F_p[x] / (x^3 - x - 1).

Counterpart of ``xlayer_prover_tpu/fields/gl3.py``.  An element is a
triple ``(c0, c1, c2)`` of int64 tensors of one shape (see ``fields.gl``);
every product goes through ``gl.mul``, so through the ``gl_mul`` kernel on
a CUDA tensor.  Inversion uses the Frobenius/norm method with host
matrices for a -> a^p and a -> a^(p^2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gl

P = gl.P


# ---------------------------------------------------------------------------
# Host-side exact helpers: polynomial arithmetic mod x^3 - x - 1
# ---------------------------------------------------------------------------

def _host_mul3(a, b):
    d = [0] * 5
    for i in range(3):
        for j in range(3):
            d[i + j] = (d[i + j] + a[i] * b[j]) % P
    # x^3 = x + 1 ; x^4 = x^2 + x
    return [(d[0] + d[3]) % P, (d[1] + d[3] + d[4]) % P, (d[2] + d[4]) % P]


def _host_pow3(a, e: int):
    r = [1, 0, 0]
    base = list(a)
    while e:
        if e & 1:
            r = _host_mul3(r, base)
        base = _host_mul3(base, base)
        e >>= 1
    return r


def _host_inv3(a):
    """Inverse via norm: a^-1 = a^(p+p^2) / N(a); 0 maps to 0."""
    f1, f2 = _frobenius_matrices()

    def apply(mat, v):
        out = [0, 0, 0]
        for i in range(3):
            for k in range(3):
                out[k] = (out[k] + v[i] * mat[i][k]) % P
        return out

    t = _host_mul3(apply(f1, a), apply(f2, a))
    n_inv = pow(_host_mul3(a, t)[0], P - 2, P)
    return [(c * n_inv) % P for c in t]


@functools.lru_cache(maxsize=None)
def _frobenius_matrices():
    """Rows i of F1/F2 = coefficients of x^(i*p) / x^(i*p^2) mod (x^3-x-1)."""
    xp = _host_pow3([0, 1, 0], P)
    xp2 = _host_pow3([0, 1, 0], P * P)
    f1 = [[1, 0, 0], xp, _host_mul3(xp, xp)]
    f2 = [[1, 0, 0], xp2, _host_mul3(xp2, xp2)]
    return f1, f2


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def zeros(shape, device):
    return tuple(gl.zeros(shape, device) for _ in range(3))


def ones(shape, device):
    return (gl.ones(shape, device), gl.zeros(shape, device),
            gl.zeros(shape, device))


def from_base(a):
    z = torch.zeros_like(a)
    return (a, z, z)


def from_ints(c0: int, c1: int, c2: int, device, shape=()):
    return (gl.full(shape, c0, device), gl.full(shape, c1, device),
            gl.full(shape, c2, device))


def from_u64_np(arr, device):
    arr = np.asarray(arr, dtype=np.uint64)
    assert arr.shape[-1] == 3
    return tuple(gl.from_u64_np(arr[..., k], device) for k in range(3))


def to_u64_np(a):
    return np.stack([gl.to_u64_np(c) for c in a], axis=-1)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def add(a, b):
    return tuple(gl.add(x, y) for x, y in zip(a, b))


def sub(a, b):
    return tuple(gl.sub(x, y) for x, y in zip(a, b))


def neg(a):
    return tuple(gl.neg(x) for x in a)


def add_base(a, b):
    return (gl.add(a[0], b), a[1], a[2])


def sub_base(a, b):
    return (gl.sub(a[0], b), a[1], a[2])


def base_sub(b, a):
    """b - a with b in the base field, a in the extension."""
    return (gl.sub(b, a[0]), gl.neg(a[1]), gl.neg(a[2]))


def mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    d0 = gl.mul(a0, b0)
    d1 = gl.add(gl.mul(a0, b1), gl.mul(a1, b0))
    d2 = gl.add(gl.add(gl.mul(a0, b2), gl.mul(a1, b1)), gl.mul(a2, b0))
    d3 = gl.add(gl.mul(a1, b2), gl.mul(a2, b1))
    d4 = gl.mul(a2, b2)
    # x^3 = x + 1 ; x^4 = x^2 + x
    return (gl.add(d0, d3), gl.add(d1, gl.add(d3, d4)), gl.add(d2, d4))


def mul_base(a, b):
    return tuple(gl.mul(c, b) for c in a)


def _apply_frob(a, mat):
    out = []
    for k in range(3):
        acc = None
        for i in range(3):
            c = mat[i][k]
            if c == 0:
                continue
            term = a[i] if c == 1 else gl.mul_const(a[i], c)
            acc = term if acc is None else gl.add(acc, term)
        out.append(acc if acc is not None else torch.zeros_like(a[0]))
    return tuple(out)


def inv(a):
    """a^(-1) via norm: inv(a) = a^p * a^(p^2) / N(a), N(a) base field."""
    f1, f2 = _frobenius_matrices()
    ap = _apply_frob(a, f1)
    ap2 = _apply_frob(a, f2)
    t = mul(ap, ap2)
    n = mul(a, t)
    return mul_base(t, gl.inv(n[0]))


def scan_mul(x, reverse: bool = False):
    """Inclusive prefix product of a triple along dim 0 (log-step)."""
    n = x[0].shape[0]
    d = 1
    while d < n:
        if reverse:
            head = mul(tuple(c[:n - d] for c in x), tuple(c[d:] for c in x))
            x = tuple(torch.cat([h, c[n - d:]]) for h, c in zip(head, x))
        else:
            tail = mul(tuple(c[d:] for c in x), tuple(c[:n - d] for c in x))
            x = tuple(torch.cat([c[:d], t]) for c, t in zip(x, tail))
        d *= 2
    return x


def batch_inv(a):
    """Montgomery batch inversion along dim 0 via two log-step scans;
    zero elements map to zero."""
    is_zero = (a[0] == 0) & (a[1] == 0) & (a[2] == 0)
    a = select(is_zero, ones(a[0].shape, a[0].device), a)
    pre = scan_mul(a)
    suf = scan_mul(a, reverse=True)
    inv_total = inv(tuple(c[-1:] for c in pre))
    one = ones((1,), a[0].device)
    pre_excl = tuple(torch.cat([o, c[:-1]]) for o, c in zip(one, pre))
    suf_excl = tuple(torch.cat([c[1:], o]) for o, c in zip(one, suf))
    out = mul(mul(pre_excl, suf_excl), inv_total)
    return tuple(torch.where(is_zero, torch.zeros_like(c), c) for c in out)


def select(pred, a, b):
    return tuple(torch.where(pred, x, y) for x, y in zip(a, b))


def sum_axis(a, axis: int = 0):
    return tuple(gl.sum_axis(c, axis=axis) for c in a)


def powers_device(x, n: int):
    """[x^k for k < n] for a gl3 scalar x (triple of 0-d tensors)."""
    assert n >= 1
    cur = ones((1,), x[0].device)
    mult = tuple(c.reshape(()) for c in x)
    length = 1
    while length < n:
        step = min(length, n - length)
        scaled = mul(tuple(c[:step] for c in cur), mult)
        cur = tuple(torch.cat([c, s]) for c, s in zip(cur, scaled))
        mult = mul(mult, mult)
        length += step
    return cur


# ---------------------------------------------------------------------------
# Structural helpers
# ---------------------------------------------------------------------------

def take(a, idx, axis: int = 0):
    return tuple(torch.index_select(c, axis, idx) for c in a)


def stack_cols(a):
    """(c0, c1, c2) of shape S -> one tensor of shape S + (3,)."""
    return torch.stack(list(a), dim=-1)


def from_cols(arr):
    """Inverse of stack_cols (contiguous columns)."""
    return tuple(arr[..., k].contiguous() for k in range(3))
