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
    (``csrc/fr_ntt.cu``); on a CPU tensor it runs ``_ntt_plain``.
  * ``mul_sub(a, b, c)``: a b - c elementwise, canonical.  On a CUDA
    tensor it launches ``fr_mul_sub``; on a CPU tensor ``_mul_sub_plain``.

The twiddles w^i (i < n/2) are built on the host once per (log2 n,
direction, device): in Montgomery form (w^i 2^256 mod r) for the kernel,
whose product of a canonical value by them is canonical, and as plain
Montgomery limbs (``ops/bn254_mont.py``) for the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..fields.bn254 import R
from .bn254_mont import FR, L, MONT, to_words

FR_GENERATOR = 5
FR_TWO_ADICITY = 28


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


@functools.lru_cache(maxsize=8)
def _kernel_twiddles(bits: int, inverse: bool, device) -> torch.Tensor:
    return torch.from_numpy(to_words(
        v * MONT % R for v in _powers(bits, inverse))).to(device)


@functools.lru_cache(maxsize=8)
def _kernel_scale(bits: int, device) -> torch.Tensor:
    """n^-1 in Montgomery form: the inverse transform's last stage scale."""
    return torch.from_numpy(to_words([pow(1 << bits, R - 2, R) * MONT % R]
                                     )).to(device)


@functools.lru_cache(maxsize=8)
def _plain_twiddles(bits: int, inverse: bool, device) -> torch.Tensor:
    return FR.to_mont(torch.from_numpy(to_words(
        _powers(bits, inverse))).to(device))


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
