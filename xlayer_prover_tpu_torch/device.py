"""Device choice and the uint64 <-> int64 bit-casts.

PyTorch has no usable ``uint64`` arithmetic, so a Goldilocks element is
carried as its 64-bit pattern in an ``int64`` tensor: a logical shift is
``(x >> k) & mask`` and an unsigned compare flips the sign bit first
(``x ^ SIGN``).  numpy ``uint64`` <-> torch ``int64`` is a ``.view``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
import time
import weakref

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


# bytes and seconds of the copies between host sections and the device
# (host -> device, device -> host), of the strided host copies that place
# a column block in its section (``copy`` adds to these three), of
# page-locking the host sections (on the pinning thread) and of the waits
# for it before a copy (on the caller's)
COPIES = {"h2d": [0, 0.0], "d2h": [0, 0.0], "host": [0, 0.0],
          "pin": [0, 0.0], "pin_wait": [0, 0.0]}
_pinner = []                # the one thread that page-locks host sections
_pins: dict = {}            # storage address -> Future of its locking
_runtime = []               # (cudaHostRegister, cudaHostUnregister)
_unpinned_said = []


def reset_copies():
    for v in COPIES.values():
        v[0], v[1] = 0, 0.0


def _host_register():
    """(cudaHostRegister, cudaHostUnregister) of the CUDA runtime PyTorch
    has loaded, called through ctypes, which lets go of the interpreter
    lock during the call, so locking at ~1.5 GB/s stalls no other thread.
    RuntimeError where that runtime cannot be loaded."""
    if not _runtime:
        name = f"libcudart.so.{torch.version.cuda.split('.')[0]}"
        try:
            lib = ctypes.CDLL(name)
            reg, unreg = lib.cudaHostRegister, lib.cudaHostUnregister
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"page-locking host sections needs "
                               f"cudaHostRegister from {name}: {e}") from e
        reg.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint]
        unreg.argtypes = [ctypes.c_void_p]
        reg.restype = unreg.restype = ctypes.c_int
        _runtime.extend((reg, unreg))
    return _runtime


def _register(ptr: int, size: int) -> bool:
    t0 = time.perf_counter()
    err = _host_register()[0](ptr, size, 0)
    COPIES["pin"][0] += size
    COPIES["pin"][1] += time.perf_counter() - t0
    if err == 0:
        return True
    if not _unpinned_said:
        _unpinned_said.append(True)
        print(f"host memory could not be page-locked (cudaHostRegister "
              f"error {err}): the host sections stay pageable",
              file=sys.stderr, flush=True)
    return False


def _release(ptr: int, fut):
    if _pins.get(ptr) is fut:
        del _pins[ptr]
    if fut.result():
        _host_register()[1](ptr)


def host_empty(shape, device) -> torch.Tensor:
    """An uninitialised int64 host tensor for a section kept off `device`.

    For a GPU `device` its pages are locked (``cudaHostRegister``, undone
    when the tensor is freed), so that copies to the device run as DMA at
    the bus's rate; PyTorch's own pinned allocator would round the size up
    to a power of two.  Locking runs at ~1.5 GB/s on the H100's host, so
    it runs on a thread of its own while the tensor is filled (writes need
    no lock); ``copy`` waits for it before the tensor's first upload.  Where
    the host cannot lock the pages the run says so on stderr, once, and
    the tensor stays pageable: the same plan, slower copies.  A CPU
    `device` gets a plain tensor."""
    t = torch.empty(shape, dtype=torch.int64)
    if torch.device(device).type != "cuda" or t.numel() == 0:
        return t
    _host_register()
    if not _pinner:
        _pinner.append(concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="host-pin"))
    ptr = t.data_ptr()
    fut = _pinner[0].submit(_register, ptr, t.numel() * t.element_size())
    _pins[ptr] = fut
    weakref.finalize(t, _release, ptr, fut)
    return t


def copy(dst: torch.Tensor, src: torch.Tensor):
    """dst.copy_(src), its bytes and seconds added to ``COPIES`` by
    direction (after a synchronise, so the seconds are the copy's own); an
    upload from a host section first waits for its page-locking."""
    kind = "h2d" if dst.is_cuda and not src.is_cuda else \
        "d2h" if src.is_cuda and not dst.is_cuda else \
        "host" if not dst.is_cuda else None
    if kind is None:
        dst.copy_(src)
        return
    fut = _pins.get(src.untyped_storage().data_ptr()) if kind == "h2d" \
        else None
    if fut is not None and not fut.done():
        t0 = time.perf_counter()
        fut.result()
        COPIES["pin_wait"][0] += 1
        COPIES["pin_wait"][1] += time.perf_counter() - t0
    if kind != "host":
        torch.cuda.synchronize(dst.device if dst.is_cuda else src.device)
    t0 = time.perf_counter()
    dst.copy_(src)
    if kind != "host":
        torch.cuda.synchronize(dst.device if dst.is_cuda else src.device)
    COPIES[kind][0] += dst.numel() * dst.element_size()
    COPIES[kind][1] += time.perf_counter() - t0
