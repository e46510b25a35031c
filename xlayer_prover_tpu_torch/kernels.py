"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` at the repository root,
at first use, and loads with ``ctypes``.  Nothing here runs at import:
the CPU tests import every module and never build.  ``build_all`` starts
one ``nvcc`` per source, all at once.

``LAUNCHES`` counts launches per kernel; each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# library name -> (source, [C entry points with their ctypes signature])
_P = ctypes.c_void_p
_LIBS = {
    "gl_mul": ("gl_mul.cu", {
        "gl_mul_launch": [_P, _P, _P, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int64, _P],
    }),
    "poseidon_gl": ("poseidon_gl.cu", {
        "poseidon_set_constants": [_P, ctypes.c_int64],
        "poseidon_permute_launch": [_P, _P, ctypes.c_int64, _P],
        "poseidon_linear_hash_launch": [_P, _P, _P, ctypes.c_int64,
                                        ctypes.c_int, ctypes.c_int64, _P],
    }),
    "poseidon_bn254": ("poseidon_bn254.cu", {
        "poseidon_bn254_permute_launch": [_P, _P, ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_int, _P, _P],
        "poseidon_bn254_leaf_hash_launch": [
            _P, _P, ctypes.c_int64, ctypes.c_int, _P, ctypes.c_int, _P,
            ctypes.c_int, ctypes.c_int, _P],
        "poseidon_bn254_resident_warps": [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int64, ctypes.c_int],
        "poseidon_bn254_few_states": [],
    }),
    **{f"bn254_msm_{g}": (f"bn254_msm_{g}.cu", {
        f"bn254_msm_{g}_prepare": [_P, _P, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, _P, _P, _P],
        f"bn254_msm_{g}_chunks": [
            _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
        f"bn254_msm_{g}_running": [
            _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _P, ctypes.c_int64, _P, _P],
        f"bn254_msm_{g}_tree": [_P, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, _P, _P],
        f"bn254_msm_{g}_combine": [_P, ctypes.c_int, ctypes.c_int, _P, _P],
        f"bn254_fixed_base_{g}_launch": [_P, _P, _P, ctypes.c_int64, _P],
    }) for g in ("g1", "g2")},
    "fr_ntt": ("fr_ntt.cu", {
        "fr_ntt_launch": [_P, _P, ctypes.c_int64, ctypes.c_int, _P, _P,
                          ctypes.c_int, _P],
        "fr_ntt_twiddles_launch": [_P, ctypes.c_int, _P, ctypes.c_int, _P,
                                   _P],
        "fr_mul_sub_launch": [_P, _P, _P, _P, ctypes.c_int64, _P],
        "fr_ntt_device_launches": [],
    }),
    "fr_poly": ("fr_poly.cu", {
        "fr_eval_launch": [_P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           _P, ctypes.c_int64, _P, _P],
        "fr_eval_occupancy": [],
        "fr_pow_tables_launch": [_P, _P, ctypes.c_int, ctypes.c_int64, _P,
                                 _P, _P],
        "fr_pow_values_launch": [_P, _P, ctypes.c_int, ctypes.c_int64,
                                 ctypes.c_int64, _P, _P],
        "fr_scan_lookback_launch": [_P, ctypes.c_int64, _P, ctypes.c_int,
                                    ctypes.c_int, _P, ctypes.c_int64, _P,
                                    _P],
        "fr_div_lookback_launch": [_P, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, _P, _P, ctypes.c_int64, _P,
                                   _P],
        "fr_div_chain_launch": [_P, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int, _P, _P, _P, _P],
        "fr_pointwise_launch": [ctypes.c_int, _P, _P, ctypes.c_int, _P,
                                ctypes.c_int, _P, _P, ctypes.c_int,
                                ctypes.c_int64, _P, _P, ctypes.c_int64, _P],
    }),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# ptxas at -O1 fits G2's fixed-base kernel into the 168 registers of 12
# warps an SM without spills; at its default -O3 the schedule spills
LIB_FLAGS = {"bn254_msm_g2": ["-Xptxas", "-O1"]}

LAUNCHES = {"gl_mul": 0, "poseidon_permute": 0, "poseidon_linear_hash": 0,
            "poseidon_bn254_permute": 0, "poseidon_bn254_leaf_hash": 0,
            "bn254_msm_g1": 0, "bn254_msm_g2": 0, "bn254_fixed_base_g1": 0,
            "bn254_fixed_base_g2": 0, "fr_ntt": 0, "fr_ntt_twiddles": 0,
            "fr_mul_sub": 0, "fr_eval": 0, "fr_div_binomial": 0,
            "fr_scan_mul": 0, "fr_pointwise": 0}
_loaded: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the GPU")
    return cand


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header (``csrc/*.cuh``)."""
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    deps = [os.path.join(CSRC, _LIBS[name][0])] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return max(os.path.getmtime(d) for d in deps) > os.path.getmtime(out)


def build_all(names=None) -> dict:
    """Compile every stale library in parallel; returns name -> ptxas log.

    Raises RuntimeError with nvcc's output if any build fails."""
    names = list(_LIBS) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *LIB_FLAGS.get(name, []), "-o", tmp,
               os.path.join(CSRC, _LIBS[name][0])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib_path(name))   # atomic for concurrent loaders
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(lib_path(name))
    for fn, argtypes in _LIBS[name][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"CUDA error {err} from {what}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
