"""Radix-2 NTT over BN254 Fr, and the pointwise a b - c of Groth16's h.

The port's counterpart of the Python-int transforms of the JAX package's
Groth16 prover (``xlayer_prover_tpu/snark/groth16.py`` ``_ntt_fr`` :42 and
the pointwise step of ``_h_coefficients`` :231).

  * ``ntt(vals, inverse)``: the transform of an (n, 4) int64 tensor of
    canonical little-endian 64-bit words (n a power of two), in natural
    order, with the root ``5^((r - 1) >> log2 n)``
    (``root_of_unity``); the inverse uses the inverse root and scales by
    n^-1.  An exact transform with this root gives the values of
    ``_ntt_fr``.  On a CUDA tensor it launches the ``fr_ntt`` kernel
    (``csrc/fr_ntt.cu``: ``len(_passes(log2 n))`` device launches, 2 at
    2^20 and 2^21); on a CPU tensor it runs ``_ntt_plain``.
  * ``mul_sub(a, b, c)``: a b - c elementwise, canonical.  On a CUDA
    tensor it launches ``fr_mul_sub``; on a CPU tensor ``_mul_sub_plain``.
  * ``expand_twiddles(lo, hi)``: the products lo[j] hi[i] / 2^256 at
    i len(lo) + j, the ``fr_ntt_twiddles`` kernel (``_expand_twiddles_plain``
    on a CPU tensor).

The kernel's twiddles w^k (k < n/2) are in Montgomery form (w^k 2^256 mod
r), whose product with a canonical value is canonical.  They are built on
the card once per (log2 n, direction, device): the host computes at most
three short tables in Python ints (``_host_twiddle_parts``: w^j for
j < 2^a, w^(2^a i) for i < 2^b, ..., each at most 2^11 entries) and
``expand_twiddles`` multiplies them out, one Montgomery product an entry.
The plain version keeps its own table, built by doubling in plain
Montgomery limbs (``_plain_twiddles``); ``_powers`` (Python ints, the
host table the kernel read before) is what the tests hold both against.

``_ntt_model`` runs the kernel's schedule step by step on Python ints: its
passes, index maps, bit reversal, shared-memory swizzle, radix-4 groups,
the twiddle index each butterfly reads and the table expansion; the CPU
tests hold it against ``_ntt_plain`` and the JAX package at small tiles.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..fields.bn254 import R
from .bn254_mont import FR, L, MONT, from_words, to_words

FR_GENERATOR = 5
FR_TWO_ADICITY = 28
# the kernel's schedule (csrc/fr_ntt.cu; a CPU test reads them there)
TILE_BITS = 11                  # a block holds 2^11 values
VALUES = 4                      # a thread owns 4: radix-4 groups
GROUP_BITS = VALUES.bit_length() - 1
THREADS = (1 << TILE_BITS) // VALUES
MAX_PASSES = -(-FR_TWO_ADICITY // TILE_BITS)
SWIZZLE = (31, 21, 25, 1, 2)    # shared-memory bank swizzle masks
TWIDDLE_PART_BITS = 11          # host twiddle tables: at most 2^11 each
_RINV = pow(MONT, -1, R)


def root_of_unity(bits: int) -> int:
    if not 0 <= bits <= FR_TWO_ADICITY:
        raise ValueError(f"no 2^{bits}-th root of unity in Fr")
    return pow(FR_GENERATOR, (R - 1) >> bits, R)


@functools.lru_cache(maxsize=8)
def _powers(bits: int, inverse: bool) -> tuple:
    """w^i for i < max(1, 2^bits / 2), w the (inverse) 2^bits-th root."""
    w = root_of_unity(bits)
    if inverse:
        w = pow(w, R - 2, R)
    out, cur = [], 1
    for _ in range(max(1, (1 << bits) >> 1)):
        out.append(cur)
        cur = cur * w % R
    return tuple(out)


def _twiddle_parts(bits: int) -> list:
    """log2 of the host tables whose products make the 2^(bits - 1)
    twiddles: bits - 1 split evenly into at least two parts of at most
    TWIDDLE_PART_BITS (one part below 2^2 twiddles)."""
    m = max(0, bits - 1)
    count = 1 if m <= 1 else max(2, -(-m // TWIDDLE_PART_BITS))
    return [m // count + (k < m % count) for k in range(count)]


@functools.lru_cache(maxsize=8)
def _host_twiddle_parts(bits: int, inverse: bool) -> tuple:
    """The host tables, Montgomery form: part t holds w^(2^A i) 2^256 mod r
    for i < 2^a_t, A the sum of the parts before it."""
    w = root_of_unity(bits)
    if inverse:
        w = pow(w, R - 2, R)
    parts, shift = [], 0
    for a in _twiddle_parts(bits):
        step, cur, part = pow(w, 1 << shift, R), MONT % R, []
        for _ in range(1 << a):
            part.append(cur)
            cur = cur * step % R
        parts.append(tuple(part))
        shift += a
    return tuple(parts)


def _mont(a: int, b: int) -> int:
    """The kernels' Montgomery product a b / 2^256 mod r, canonical."""
    return a * b * _RINV % R


def _expand_twiddles_model(parts) -> list:
    """The table the fr_ntt_twiddles launches build from the host parts:
    entry i 2^A + j = table[j] part[i] / 2^256."""
    table = list(parts[0])
    for hi in parts[1:]:
        table = [_mont(t, h) for h in hi for t in table]
    return table


def _expand_twiddles_plain(lo: torch.Tensor, hi: torch.Tensor):
    """Plain PyTorch version of the fr_ntt_twiddles kernel."""
    a = FR.to_mont(lo).repeat(hi.shape[0], 1)
    b = FR.to_mont(hi).repeat_interleave(lo.shape[0], 0)
    ab = FR.mul(a, b)
    return FR.from_mont(FR.mul(ab, FR.const(_RINV, lo.device).expand_as(ab)))


def expand_twiddles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(len(lo) len(hi), 4) words: lo[j] hi[i] / 2^256 mod r at
    i len(lo) + j, for canonical words, lengths powers of two.  Wrapper
    of the ``fr_ntt_twiddles`` kernel: CPU tensors take the plain
    version."""
    for t in (lo, hi):
        _check("expand_twiddles", t)
    if lo.device != hi.device:
        raise ValueError("expand_twiddles: tensors on different devices")
    a, b = _log2(lo.shape[0]), _log2(hi.shape[0])
    if lo.device.type == "cpu":
        return _expand_twiddles_plain(lo, hi)
    out = torch.empty((lo.shape[0] * hi.shape[0], 4), dtype=torch.int64,
                      device=lo.device)
    lib = kernels.load("fr_ntt")
    kernels.LAUNCHES["fr_ntt_twiddles"] += 1
    kernels.check(lib.fr_ntt_twiddles_launch(
        lo.data_ptr(), a, hi.data_ptr(), b, out.data_ptr(),
        kernels.stream_ptr(lo.device)), "fr_ntt_twiddles_launch")
    return out


@functools.lru_cache(maxsize=8)
def _kernel_twiddles(bits: int, inverse: bool, device) -> torch.Tensor:
    """The kernel's table of w^k 2^256 mod r (k < max(1, 2^bits / 2)),
    expanded on `device` from the host parts."""
    parts = [torch.from_numpy(to_words(p)).to(device)
             for p in _host_twiddle_parts(bits, inverse)]
    table = parts[0]
    for hi in parts[1:]:
        table = expand_twiddles(table, hi)
    return table


@functools.lru_cache(maxsize=8)
def _kernel_scale(bits: int, device) -> torch.Tensor:
    """n^-1 in Montgomery form: the inverse transform's last stage scale."""
    return torch.from_numpy(to_words([pow(1 << bits, R - 2, R) * MONT % R]
                                     )).to(device)


@functools.lru_cache(maxsize=8)
def _plain_twiddles(bits: int, inverse: bool, device) -> torch.Tensor:
    """w^i (i < max(1, 2^bits / 2)) as plain Montgomery limbs on `device`,
    by doubling: the first 2^t powers times w^(2^t) are the next 2^t."""
    w = root_of_unity(bits)
    if inverse:
        w = pow(w, R - 2, R)
    table = FR.const(1, device).reshape(1, L)
    while table.shape[0] < max(1, (1 << bits) >> 1):
        step = FR.const(w, device).expand_as(table)
        table = torch.cat([table, FR.mul(table, step)])
        w = w * w % R
    return table


@functools.lru_cache(maxsize=8)
def _bitrev(bits: int, device) -> torch.Tensor:
    idx = np.arange(1 << bits, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return torch.from_numpy(rev).to(device)


def _log2(n: int) -> int:
    bits = n.bit_length() - 1
    if n < 1 or 1 << bits != n:
        raise ValueError(f"NTT size {n} is not a power of two")
    if bits > FR_TWO_ADICITY:
        raise ValueError(f"NTT size 2^{bits} exceeds Fr's 2-adicity")
    return bits


def _ntt_plain(vals: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Plain PyTorch version of the fr_ntt kernel: the same bit reversal
    and radix-2 stages over plain Montgomery limbs."""
    n = vals.shape[0]
    bits = _log2(n)
    dev = vals.device
    x = FR.to_mont(vals)[_bitrev(bits, dev)]
    tw = _plain_twiddles(bits, inverse, dev)
    half = 1
    while half < n:
        blocks = n // (2 * half)
        x = x.reshape(blocks, 2, half, L)
        w = tw[::blocks][:half].expand(blocks, half, L)
        u, v = x[:, 0], FR.mul(x[:, 1], w)
        x = torch.stack([FR.reduce(FR.add(u, v)), FR.reduce(FR.sub(u, v))],
                        dim=1).reshape(n, L)
        half *= 2
    if inverse:
        x = FR.mul(x, FR.const(pow(n, R - 2, R), dev).expand_as(x))
    return FR.from_mont(x)


def _passes(bits: int, tile_bits: int = TILE_BITS) -> list:
    """The kernel's passes over 2^bits values, one launch each: (L, S, c),
    stages L .. L + S - 1 over blocks of 2^c columns of 2^S rows;
    ceil(bits / tile_bits) passes, their S as even as can be, the larger
    first."""
    if bits == 0:
        return [(0, 0, 0)]
    count = -(-bits // tile_bits)
    tb = min(tile_bits, bits)
    out, first = [], 0
    for p in range(count):
        s = bits // count + (p < bits % count)
        out.append((first, s, tb - s))
        first += s
    return out


def _bitrev_int(x: int, nbits: int) -> int:
    return int(format(x, f"0{nbits}b")[::-1], 2) if nbits else 0


def _slot(e: int) -> int:
    """The shared-memory slot of tile element e (the bank swizzle)."""
    h, m = e >> 5, 0
    for b, mask in enumerate(SWIZZLE):
        if (h >> b) & 1:
            m ^= mask
    return e ^ m


def _group_model(sh, tile, threads, c, first_stage, bits, col0, s0, r, tw,
                 from0):
    """One radix-2^r group of stages s0 .. s0 + r - 1 over a block's tile,
    thread by thread as csrc/fr_ntt.cu ``ntt_group`` runs it: each
    thread's VALUES slots read, butterflied and written back (``from0``,
    the first pass's first group: no product where the twiddle is 1); the
    slots of one group must cover the tile once."""
    groups, width = VALUES >> r, 1 << r
    seen = set()
    for t in range(threads):
        es, ok, k0 = [0] * VALUES, [False] * groups, [0] * groups
        for g in range(groups):
            o = t + threads * g
            ok[g] = o < (tile >> r)
            cc, rest = o & ((1 << c) - 1), o >> c
            lo, hi = rest & ((1 << s0) - 1), rest >> s0
            k0[g] = (lo << first_stage) | ((col0 + cc)
                                           & ((1 << first_stage) - 1))
            for i in range(width):
                es[g * width + i] = cc + ((lo + (i << s0)
                                           + (hi << (s0 + r))) << c)
        x = [sh[_slot(es[q])] if ok[q // width] else 0
             for q in range(VALUES)]
        for d in range(r):
            shift = bits - 1 - first_stage - s0 - d
            for q in range(VALUES):
                if (q >> d) & 1 or not ok[q // width]:
                    continue
                i = (q % width) & ((1 << d) - 1)
                k = k0[q // width] + (i << (s0 + first_stage))
                v = (x[q + (1 << d)] if from0 and i == 0
                     else _mont(x[q + (1 << d)], tw[k << shift]))
                x[q], x[q + (1 << d)] = (x[q] + v) % R, (x[q] - v) % R
        for q in range(VALUES):
            if ok[q // width]:
                s = _slot(es[q])
                if s in seen or not 0 <= s < tile:
                    raise AssertionError(f"slot {s} taken twice or out of "
                                         "the tile")
                seen.add(s)
                sh[s] = x[q]
    if len(seen) != tile:
        raise AssertionError("a group left slots of the tile untouched")


def _ntt_model(vals: torch.Tensor, inverse: bool,
               tile_bits: int = TILE_BITS) -> torch.Tensor:
    """The fr_ntt kernel's schedule on Python ints, at any tile size: the
    passes of ``_passes(bits, tile_bits)``, each block loading its tile
    (the first pass from the bit-reversed positions), the radix-4 groups
    (``_group_model``), the n^-1 scale on the last pass's stores, the
    twiddles from ``_expand_twiddles_model``.  Returns (n, 4) words."""
    x = from_words(vals.cpu())
    n = len(x)
    bits = _log2(n)
    tw = _expand_twiddles_model(_host_twiddle_parts(bits, inverse))
    scale = pow(n, R - 2, R) * MONT % R
    passes = _passes(bits, tile_bits)
    out = [None] * n
    for p, (first_stage, s, c) in enumerate(passes):
        first, last = p == 0, p == len(passes) - 1
        src = x if first else out
        tile = 1 << (s + c)
        threads = max(1, tile // VALUES)

        def at(col, row):             # a later pass's position
            return (((col >> first_stage) << (first_stage + s))
                    + (row << first_stage)
                    + (col & ((1 << first_stage) - 1)))
        for block in range(n >> (s + c)):
            col0 = block << c
            sh = [None] * tile
            for f in range(tile):        # thread f % threads loads f
                col, row = col0 + (f & ((1 << c) - 1)), f >> c
                src_at = ((_bitrev_int(row, s) << (bits - s)) + col
                          if first else at(col, row))
                sh[_slot(f)] = src[src_at]
            s0 = 0
            while s0 < s:
                r = min(GROUP_BITS, s - s0)
                _group_model(sh, tile, threads, c, first_stage, bits, col0,
                             s0, r, tw, first and s0 == 0)
                s0 += r
            for f in range(tile):
                cc, row = ((f >> s, f & ((1 << s) - 1)) if first
                           else (f & ((1 << c) - 1), f >> c))
                v = sh[_slot(cc + (row << c))]
                if last and inverse:
                    v = _mont(v, scale)
                col = col0 + cc
                dst = ((_bitrev_int(col, bits - s) << s) + row if first
                       else at(col, row))
                out[dst] = v
    return torch.from_numpy(to_words(out))


def _mul_sub_plain(a, b, c):
    """Plain PyTorch version of the fr_mul_sub kernel."""
    ab = FR.mul(FR.to_mont(a), FR.to_mont(b))
    return FR.from_mont(FR.sub(ab, FR.to_mont(c)))


def _check(name: str, *ts):
    n = ts[0].shape[0]
    for t in ts:
        if t.dim() != 2 or t.shape != (n, 4) or t.dtype != torch.int64:
            raise ValueError(f"{name}: (n, 4) int64 words expected, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on different devices")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensors expected")


def ntt(vals: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The NTT (or, with `inverse`, the INTT, scaled by n^-1) of (n, 4)
    int64 canonical Fr words.  Wrapper of the ``fr_ntt`` kernel: a CPU
    tensor takes the plain version."""
    _check("ntt", vals)
    bits = _log2(vals.shape[0])
    if vals.device.type == "cpu":
        return _ntt_plain(vals, inverse)
    n = vals.shape[0]
    out = torch.empty_like(vals)
    tw = _kernel_twiddles(bits, inverse, vals.device)
    scale = _kernel_scale(bits, vals.device).data_ptr() if inverse else None
    lib = kernels.load("fr_ntt")
    kernels.LAUNCHES["fr_ntt"] += 1
    kernels.check(lib.fr_ntt_launch(
        vals.data_ptr(), out.data_ptr(), n, bits, tw.data_ptr(),
        scale, int(inverse), kernels.stream_ptr(vals.device)),
        "fr_ntt_launch")
    return out


def device_launches() -> int:
    """The device launches the ``fr_ntt`` library has made in this
    process (every kernel of ``csrc/fr_ntt.cu``, counted in C at each
    launch): the difference around a call is that call's launches."""
    return kernels.load("fr_ntt").fr_ntt_device_launches()


def mul_sub(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b - c mod r over (n, 4) int64 canonical Fr words.  Wrapper of the
    ``fr_mul_sub`` kernel: CPU tensors take the plain version."""
    _check("mul_sub", a, b, c)
    if a.device.type == "cpu":
        return _mul_sub_plain(a, b, c)
    out = torch.empty_like(a)
    n = a.shape[0]
    if n == 0:
        return out
    lib = kernels.load("fr_ntt")
    kernels.LAUNCHES["fr_mul_sub"] += 1
    kernels.check(lib.fr_mul_sub_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), n,
        kernels.stream_ptr(a.device)), "fr_mul_sub_launch")
    return out
