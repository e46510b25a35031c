"""Poseidon permutation over Goldilocks + linear hash + Merkle node hash.

Counterpart of ``xlayer_prover_tpu/ops/poseidon_gl.py``:

  * ``permute``: the t=12 permutation over a batch of states.  On a CUDA
    tensor it launches the ``poseidon_permute`` kernel
    (``csrc/poseidon_gl.cu``); on a CPU tensor it runs the plain version
    ``_permute_plain``, the round loop of the JAX ``permute_u64``.
  * ``linear_hash``: rows of any width -> 4-element digests (RATE-8
    chunks chained through the capacity), as MerkleTreeGL's leaf hash.
  * ``hash_node``: internal node, permute(left4 || right4 || 0^4)[0:4].
  * ``host_permute`` / ``host_linear_hash``: pure Python-int versions for
    the transcript and the verifier.

Round layout: ARK -> S-box (x^7; lane 0 only in the 22 partial rounds) ->
MDS with out_j = sum_i s_i * M[i][j].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..fields import gl
from . import poseidon_constants as pc

WIDTH = pc.WIDTH
RATE = pc.RATE
CAPACITY = pc.CAPACITY
HASH_SIZE = 4
N_ROUNDS = pc.FULL_ROUNDS + pc.PARTIAL_ROUNDS


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    consts, mds = pc.get_params()
    c = gl.from_u64_np(np.array(consts, dtype=np.uint64).reshape(
        N_ROUNDS, WIDTH), device)
    m = gl.from_u64_np(np.array(mds, dtype=np.uint64), device)
    return c, m


def _is_full(r: int) -> bool:
    half = pc.FULL_ROUNDS // 2
    return r < half or r >= half + pc.PARTIAL_ROUNDS


def _sbox_plain(x):
    mul = gl._mul_plain
    x2 = mul(x, x)
    x4 = mul(x2, x2)
    return mul(mul(x4, x2), x)


def _mds_plain(state, m):
    """state (..., 12): out_j = sum_i s_i M[i][j], broadcast + tree sum."""
    prod = gl._mul_plain(state[..., :, None], m)        # (..., i, j)
    pad = torch.zeros(prod.shape[:-2] + (4, WIDTH), dtype=prod.dtype,
                      device=prod.device)
    acc = torch.cat([prod, pad], dim=-2)                # i-axis 12 -> 16
    k = 16
    while k > 1:
        k //= 2
        acc = gl.add(acc[..., :k, :], acc[..., k:, :])
    return acc[..., 0, :]


def _permute_plain(state):
    """Plain PyTorch version of the poseidon_permute kernel (any device)."""
    c, m = _tables(state.device)
    for r in range(N_ROUNDS):
        st = gl.add(state, c[r])
        if _is_full(r):
            st = _sbox_plain(st)
        else:
            st = torch.cat([_sbox_plain(st[..., :1]), st[..., 1:]], dim=-1)
        state = _mds_plain(st, m)
    return state


_constants_set: set = set()


def _poseidon_lib(device: torch.device):
    """The loaded kernel library, with its constants set on `device`."""
    lib = kernels.load("poseidon_gl")
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _constants_set:
        consts, mds = pc.get_params()
        if max(v for row in mds for v in row) >= 1 << 16:
            raise ValueError("poseidon_permute needs MDS entries < 2^16")
        rc = np.ascontiguousarray(np.array(consts, dtype=np.uint64))
        mm = np.ascontiguousarray(np.array(mds, dtype=np.uint32).ravel())
        with torch.cuda.device(device):
            kernels.check(lib.poseidon_set_constants(rc.ctypes.data,
                                                     mm.ctypes.data),
                          "poseidon_set_constants")
        _constants_set.add(key)
    return lib


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation of (..., 12) int64 states.  Wrapper of the
    ``poseidon_permute`` kernel: a CPU tensor takes the plain version."""
    if state.device.type == "cpu":
        return _permute_plain(state)
    if state.device.type != "cuda":
        raise ValueError(f"permute: tensor on {state.device}")
    if state.dtype != gl.DTYPE:
        raise TypeError("permute: int64 tensor expected")
    if state.dim() == 0 or state.shape[-1] != WIDTH:
        raise ValueError(f"permute: shape (..., {WIDTH}) expected, got "
                         f"{tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("permute: contiguous tensor expected")
    out = torch.empty_like(state)
    n = state.numel() // WIDTH
    if n == 0:
        return out
    lib = _poseidon_lib(state.device)
    kernels.LAUNCHES["poseidon_permute"] += 1
    kernels.check(lib.poseidon_permute_launch(
        state.data_ptr(), out.data_ptr(), n, kernels.stream_ptr(state.device)),
        "poseidon_permute_launch")
    return out


def hash_n_to_4(inputs):
    return permute(inputs)[..., :HASH_SIZE].contiguous()


def linear_hash(rows, width: int):
    """Hash (batch, width) rows to (batch, 4) digests.

    width <= 4 returns the zero-padded row; otherwise RATE-chunks are
    absorbed with the previous digest as capacity (zero-seeded)."""
    batch = rows.shape[0]
    if rows.shape[1] != width:
        raise ValueError(f"linear_hash: width {rows.shape[1]} != {width}")
    if width <= CAPACITY:
        return torch.cat([rows, gl.zeros((batch, CAPACITY - width),
                                         rows.device)], dim=1)
    digest = gl.zeros((batch, CAPACITY), rows.device)
    for start in range(0, width, RATE):
        n = min(RATE, width - start)
        parts = [rows[:, start:start + n]]
        if n < RATE:
            parts.append(gl.zeros((batch, RATE - n), rows.device))
        digest = hash_n_to_4(torch.cat(parts + [digest], dim=1))
    return digest


def hash_node(left, right):
    """Internal Merkle node: permute(left4 || right4 || 0^4)[0:4]."""
    zero_cap = gl.zeros((left.shape[0], CAPACITY), left.device)
    return hash_n_to_4(torch.cat([left, right, zero_cap], dim=1))


# ---------------------------------------------------------------------------
# Host-exact Poseidon (python ints) for the transcript and the verifier
# ---------------------------------------------------------------------------

def host_permute(state):
    P = gl.P
    consts, mds = pc.get_params()
    t = WIDTH
    state = [s % P for s in state]
    for r in range(N_ROUNDS):
        state = [(x + consts[r * t + i]) % P for i, x in enumerate(state)]
        if _is_full(r):
            state = [pow(x, 7, P) for x in state]
        else:
            state[0] = pow(state[0], 7, P)
        state = [sum(state[i] * mds[i][j] for i in range(t)) % P
                 for j in range(t)]
    return state


def host_linear_hash(row):
    if len(row) <= CAPACITY:
        return list(row) + [0] * (CAPACITY - len(row))
    digest = [0, 0, 0, 0]
    for start in range(0, len(row), RATE):
        chunk = list(row[start:start + RATE])
        chunk = chunk + [0] * (RATE - len(chunk))
        digest = host_permute(chunk + digest)[:4]
    return digest
