"""Device choice and the uint64 <-> int64 bit-casts.

PyTorch has no usable ``uint64`` arithmetic, so a Goldilocks element is
carried as its 64-bit pattern in an ``int64`` tensor: a logical shift is
``(x >> k) & mask`` and an unsigned compare flips the sign bit first
(``x ^ SIGN``).  numpy ``uint64`` <-> torch ``int64`` is a ``.view``.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

SIGN = -(1 << 63)           # int64 pattern of 2^63: xor flips unsigned order
MASK32 = 0xFFFFFFFF


def resolve(device=None) -> torch.device:
    """``None`` means the GPU.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return dev


def i64(v: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bit pattern."""
    v = int(v) & ((1 << 64) - 1)
    return v - (1 << 64) if v >> 63 else v


def from_u64_np(arr, device=None) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor on `device` (bit-identical)."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(resolve(device))


def to_u64_np(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array (bit-identical, on the host)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def scalar(v: int, device) -> torch.Tensor:
    """0-d int64 tensor holding the pattern of the Python int `v`."""
    return torch.tensor(i64(v), dtype=torch.int64, device=device)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ SIGN) < (b ^ SIGN)


def smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line, e.g.
    ``smi("name,power.limit")``."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]
