"""Goldilocks NTT / INTT / low-degree extension on int64 tensors.

Counterpart of ``xlayer_prover_tpu/ops/ntt.py``.  Polynomials are (N, C)
column batches.  The transform is radix-2 decimation in frequency: stage s
pairs rows j and j + N/2^(s+1) of each block, ``top = a + b`` and
``bot = (a - b) * w^(j * 2^s)`` (the product through ``gl.mul``, so the
``gl_mul`` kernel on the GPU); one gather by the bit-reversal index puts
the result in natural order.

Twiddle and bit-reversal tables are device tensors cached per
``(nbits, inverse, device)``, built once on the host with exact numpy
arithmetic.

Conventions (the reference prover's):
  * ``ntt``: evaluations[i] = poly(w^i), natural order, w = gl.host_w(log2 N).
  * ``intt``: inverse transform (scales by N^-1).
  * ``extend_pol``: INTT on N, multiply coeff k by shift^k (shift = 7), then
    NTT on N_ext: evaluations on the shifted coset of the larger domain.
  * ``extend_pol_blocks``: ``extend_pol`` of a section too wide for the
    device, a column block at a time, into a host tensor (the counterpart
    of the JAX ``extend_pol_np``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as dev
from ..fields import gl

P = gl.P


def _np_modmul(a: np.ndarray, b) -> np.ndarray:
    """Exact (a * b) % P on uint64 numpy arrays (wrapping split
    arithmetic, as gl._mul_wide/_reduce128)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    eps = np.uint64(0xFFFFFFFF)
    thirty_two = np.uint64(32)
    a_lo = a & mask
    a_hi = a >> thirty_two
    b_lo = b & mask
    b_hi = b >> thirty_two
    with np.errstate(over="ignore"):
        ll = a_lo * b_lo
        lh = a_lo * b_hi
        hl = a_hi * b_lo
        hh = a_hi * b_hi
        lo = a * b
        t = hl + (ll >> thirty_two)
        u = lh + (t & mask)
        hi = hh + (t >> thirty_two) + (u >> thirty_two)
        hi_hi = hi >> thirty_two
        hi_lo = hi & mask
        t0 = lo - hi_hi
        t0 = np.where(lo < hi_hi, t0 - eps, t0)
        t1 = hi_lo * eps
        r = t0 + t1
        r = np.where(r < t0, r + eps, r)
    return np.where(r >= np.uint64(P), r - np.uint64(P), r)


def _np_pow_table(base: int, count: int) -> np.ndarray:
    """[base^k for k < count] as uint64, exact, log(count) numpy passes."""
    out = np.ones(1, dtype=np.uint64)
    step = np.uint64(base % P)
    while out.size < count:
        take = min(out.size, count - out.size)
        out = np.concatenate([out, _np_modmul(out[:take], step)])
        step = _np_modmul(step, step)
    return out


@functools.lru_cache(maxsize=None)
def _twiddles(nbits: int, inverse: bool, device: torch.device):
    """[w^j for j < N/2] on `device`; stage s reads every 2^s-th entry."""
    w = gl.host_w(nbits)
    if inverse:
        w = gl.host_inv(w)
    return gl.from_u64_np(_np_pow_table(w, max((1 << nbits) // 2, 1)),
                          device)


@functools.lru_cache(maxsize=None)
def _bitrev(nbits: int, device: torch.device):
    idx = np.arange(1 << nbits)
    rev = np.zeros(1 << nbits, dtype=np.int64)
    for b in range(nbits):
        rev |= ((idx >> b) & 1) << (nbits - 1 - b)
    return torch.from_numpy(rev).to(device)


@functools.lru_cache(maxsize=None)
def _shift_powers(nbits: int, shift: int, device: torch.device):
    return gl.from_u64_np(_np_pow_table(shift, 1 << nbits), device)


def _transform(a, nbits: int, inverse: bool):
    """Radix-2 DIF over dim 0 of an (N,) or (N, C) tensor; natural order
    out."""
    n = 1 << nbits
    if a.shape[0] != n:
        raise ValueError(f"transform: {a.shape[0]} rows, expected {n}")
    squeeze = a.dim() == 1
    x = a[:, None] if squeeze else a
    c = x.shape[1]
    tw = _twiddles(nbits, inverse, x.device)
    for s in range(nbits):
        h = n >> (s + 1)
        blocks = 1 << s
        v = x.reshape(blocks, 2, h, c)
        ev, od = v[:, 0], v[:, 1]
        top = gl.add(ev, od)
        tws = tw[::blocks][:h].reshape(1, h, 1).expand(blocks, h, c)
        bot = gl.mul(gl.sub(ev, od), tws)
        x = torch.stack([top, bot], dim=1).reshape(n, c)
    x = x.index_select(0, _bitrev(nbits, x.device))
    if inverse:
        x = gl.mul_const(x, gl.host_inv(n))
    return x[:, 0] if squeeze else x


def _nbits_of(a, nbits):
    n = a.shape[0]
    nbits = nbits if nbits is not None else n.bit_length() - 1
    if (1 << nbits) != n:
        raise ValueError(f"transform size {n} is not 2^{nbits}")
    return nbits


def ntt(a, nbits: int | None = None):
    return _transform(a, _nbits_of(a, nbits), False)


def intt(a, nbits: int | None = None):
    return _transform(a, _nbits_of(a, nbits), True)


def coset_shift_coeffs(coeffs, shift: int = gl.SHIFT):
    """Multiply coefficient k by shift^k."""
    nbits = _nbits_of(coeffs, None)
    tbl = _shift_powers(nbits, shift % P, coeffs.device)
    if coeffs.dim() == 2:
        tbl = tbl[:, None]
    return gl.mul(coeffs, tbl)


def extend_pol(a, nbits_ext: int, shift: int = gl.SHIFT):
    """LDE: values on the size-N domain -> values on the shift-coset of
    the N_ext domain; row i of the output is poly(shift * w_ext^i)."""
    n = a.shape[0]
    nbits = _nbits_of(a, None)
    if nbits_ext < nbits:
        raise ValueError("extend_pol: nbits_ext < nbits")
    coeffs = coset_shift_coeffs(intt(a, nbits), shift)
    pad = torch.zeros(((1 << nbits_ext) - n,) + tuple(a.shape[1:]),
                      dtype=a.dtype, device=a.device)
    return ntt(torch.cat([coeffs, pad]), nbits_ext)


def extend_pol_blocks(a, nbits_ext: int, block_cols: int, device,
                      on_block=None, shift: int = gl.SHIFT):
    """Streamed LDE: the (N, C) section `a` (a numpy uint64 array, a host
    tensor or a tensor on `device`) extended `block_cols` columns at a
    time on `device` into an (N_ext, C) host tensor (``dev.host_empty``:
    page-locked beside a GPU); the device holds one block and its
    extension at a time.  Each extended block is handed to
    ``on_block(c0, block)`` on the device before it is copied back, so
    the caller can hash it while it is there (each block crosses the bus
    once each way).  Equal to ``extend_pol`` column for column."""
    device = torch.device(device)
    n_ext = 1 << nbits_ext
    width = a.shape[1]
    out = dev.host_empty((n_ext, width), device)
    stage = None
    if device.type == "cuda" and width:
        stage = torch.empty(n_ext * min(block_cols, width), dtype=gl.DTYPE,
                            pin_memory=True)
    for c0 in range(0, width, block_cols):
        w = min(block_cols, width - c0)
        if isinstance(a, np.ndarray):
            blk = gl.from_u64_np(a[:, c0:c0 + w], device)
        else:
            blk = a[:, c0:c0 + w].to(device).contiguous()
        ext = extend_pol(blk, nbits_ext, shift)
        del blk
        if on_block is not None:
            on_block(c0, ext)
        if stage is None:
            out[:, c0:c0 + w] = ext
        else:
            host = stage[:n_ext * w].view(n_ext, w)
            dev.copy(host, ext)
            dev.copy(out[:, c0:c0 + w], host)
        del ext
    return out
