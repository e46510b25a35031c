"""Poseidon permutation over Goldilocks + linear hash + Merkle node hash.

Counterpart of ``xlayer_prover_tpu/ops/poseidon_gl.py``:

  * ``permute``: the t=12 permutation over a batch of states.  On a CUDA
    tensor it launches the ``poseidon_permute`` kernel
    (``csrc/poseidon_gl.cu``); on a CPU tensor it runs the plain version
    ``_permute_plain``, the round loop of the JAX ``permute_u64``.
  * ``linear_hash``: rows of any width -> 4-element digests (RATE-8
    chunks chained through the capacity, which a caller may carry in
    from the row's earlier column blocks), as MerkleTreeGL's leaf hash.  On
    a CUDA tensor it launches the ``poseidon_linear_hash`` kernel; on a
    CPU tensor it runs ``_linear_hash_plain``.
    An internal Merkle node, permute(left4 || right4 || 0^4)[0:4], is the
    linear hash of the width-8 row left4 || right4 (``merkle.merkelize``).
  * ``_permute_sparse_plain``: a plain model of the kernels' arithmetic
    (sparse partial rounds, lazy sums, non-canonical intermediates) over
    the packed constant table ``kernel_constants`` that they read.
  * ``host_permute`` / ``host_linear_hash``: pure Python-int versions for
    the transcript and the verifier.

Round layout: ARK -> S-box (x^7; lane 0 only in the 22 partial rounds) ->
MDS with out_j = sum_i s_i * M[i][j].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as dev
from .. import kernels
from ..fields import gl
from . import poseidon_constants as pc

WIDTH = pc.WIDTH
RATE = pc.RATE
CAPACITY = pc.CAPACITY
HASH_SIZE = 4
N_ROUNDS = pc.FULL_ROUNDS + pc.PARTIAL_ROUNDS
_MDS_SMALL = 1 << 16        # the MDS sums of the kernels and _mds_plain
                            # need entries below


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    consts, mds = pc.get_params()
    if max(v for row in mds for v in row) >= _MDS_SMALL:
        raise ValueError("the plain Poseidon needs MDS entries < 2^16")
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
    """state (..., 12): out_j = sum_i s_i M[i][j] mod p.  The entries of M
    are below 2^16 (``_tables`` checks), so the 32-bit halves of s times M
    sum exactly in int64 (below 2^56): lo + hi 2^32, folded once with
    2^64 = 2^32 - 1 (mod p)."""
    lo = ((state & gl.MASK32)[..., :, None] * m).sum(-2)
    hi = (((state >> 32) & gl.MASK32)[..., :, None] * m).sum(-2)
    x = ((hi >> 32) & gl.MASK32) * gl.EPSILON + lo
    r = x + (hi << 32)
    r = torch.where(dev.ult(r, x), r + gl.EPSILON, r)
    return gl._cond_sub_p(r)


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


# ---------------------------------------------------------------------------
# The kernels' sparse-form algorithm (csrc/poseidon_gl.cu), as a plain model
# ---------------------------------------------------------------------------

# The kernels' constant table, in the order of csrc/poseidon_gl.cu's
# PoseidonConstants: name -> shape in 32-bit words (little-endian halves
# for the 64-bit constants).  A dot-product term of a constant w is six
# words: the 22-bit limbs of w, then those of w' = 2^32 w mod p.  A partial
# round is v[11] (64-bit), the limbs of the next lane-0 constant (+ one
# pad word), then the terms of w_hat[0..10] and of m00.  The MDS entries
# are doubles (the full rounds sum on the FP64 pipe).
LIMB_BITS = 22
_TERM = 6
KERNEL_LAYOUT = (
    ("full_c", (pc.FULL_ROUNDS, WIDTH, 2)),
    ("first_c", (WIDTH, 4)),
    ("pre", (WIDTH, WIDTH, _TERM)),
    ("partial", (pc.PARTIAL_ROUNDS, 2 * (WIDTH - 1) + 4 + WIDTH * _TERM)),
    ("mds", (WIDTH, WIDTH, 2)))


def _limbs(w: int) -> list:
    mask = (1 << LIMB_BITS) - 1
    return [w & mask, (w >> LIMB_BITS) & mask, w >> (2 * LIMB_BITS)]


def _term(w: int) -> list:
    return _limbs(w) + _limbs((w << 32) % gl.P)


def _u32(w: int) -> list:
    return [w & 0xFFFFFFFF, w >> 32]


@functools.lru_cache(maxsize=None)
def kernel_constants() -> np.ndarray:
    """The packed uint32 table the kernels read (KERNEL_LAYOUT order)."""
    sf = pc.sparse_form()
    _, mds = pc.get_params()
    if max(v for row in mds for v in row) >= _MDS_SMALL:
        raise ValueError("the Poseidon kernels need MDS entries < 2^16")
    next_c0 = list(sf.lane0_c[1:]) + [0]
    partial = []
    for c0, (m00, v, w_hat) in zip(next_c0, sf.sparse):
        row = [x for vj in v for x in _u32(vj)] + _limbs(c0) + [0]
        partial.append(row + [x for w in list(w_hat) + [m00]
                              for x in _term(w)])
    parts = {
        "full_c": [[_u32(c) for c in row] for row in sf.full_c],
        "first_c": [_limbs(c) + [0] for c in sf.first_c],
        "pre": [[_term(sf.pre[i][j]) for i in range(WIDTH)]
                for j in range(WIDTH)],
        "partial": partial,
        "mds": np.array(mds, dtype=np.float64).view(np.uint32).reshape(
            WIDTH, WIDTH, 2)}
    table = []
    for name, shape in KERNEL_LAYOUT:
        arr = np.array(parts[name], dtype=np.uint32)
        if arr.shape != shape:
            raise ValueError(f"kernel constants: {name} has shape "
                             f"{arr.shape}, the kernels read {shape}")
        table.append(arr.ravel())
    return np.concatenate(table)


@functools.lru_cache(maxsize=None)
def _kernel_tables(device: torch.device) -> dict:
    """kernel_constants() unpacked by KERNEL_LAYOUT, as int64 tensors of
    the 32-bit words."""
    flat = torch.from_numpy(kernel_constants().astype(np.int64)).to(device)
    out, at = {}, 0
    for name, shape in KERNEL_LAYOUT:
        size = int(np.prod(shape))
        out[name] = flat[at:at + size].reshape(shape)
        at += size
    return out


M32 = gl.MASK32
EPS = gl.EPSILON


def _mul128(a, b):
    """64x64 -> (lo, hi), the exact 128-bit product of gl.cuh gl_mul128,
    from four 32x32 -> 64 partial products (every intermediate < 2^64)."""
    a0, a1 = a & M32, (a >> 32) & M32
    b0, b1 = b & M32, (b >> 32) & M32
    p00 = a0 * b0
    m = a0 * b1 + ((p00 >> 32) & M32)
    m2 = a1 * b0 + (m & M32)
    lo = (m2 << 32) | (p00 & M32)
    hi = a1 * b1 + ((m >> 32) & M32) + ((m2 >> 32) & M32)
    return lo, hi


def _reduce128_nc(lo, hi):
    """hi * 2^64 + lo mod p, any 64-bit result (gl.cuh gl_reduce128_nc)."""
    hi_hi = (hi >> 32) & M32
    hi_lo = hi & M32
    t0 = lo - hi_hi
    t0 = torch.where(dev.ult(lo, hi_hi), t0 - EPS, t0)
    t1 = (hi_lo << 32) - hi_lo
    r = t0 + t1
    return torch.where(dev.ult(r, t1), r + EPS, r)


def _mul_nc(a, b):
    return _reduce128_nc(*_mul128(a, b))


def _add_nc(a, c):
    """a + c mod p for any 64-bit a and c < p (gl.cuh gl_add_nc)."""
    s = a + c
    return torch.where(dev.ult(s, c), s + EPS, s)


def _sbox_nc(x):
    x2 = _mul_nc(x, x)
    x3 = _mul_nc(x2, x)
    x4 = _mul_nc(x2, x2)
    return _mul_nc(x4, x3)


def _fold_cols(c0, c1, c2):
    """c0 + c1 2^22 + c2 2^44 mod p for columns below 2^60 (kernel:
    cols_reduce): its 128-bit words, then _reduce128_nc."""
    a, b = c1 << LIMB_BITS, c2 << (2 * LIMB_BITS)
    lo1 = c0 + a
    lo = lo1 + b
    hi = ((c1 >> (64 - LIMB_BITS)) + (c2 >> (64 - 2 * LIMB_BITS))
          + dev.ult(lo1, a).long() + dev.ult(lo, b).long())
    return _reduce128_nc(lo, hi)


def _dot_cols(xs, terms, init):
    """init + sum x_i w_i (kernel: Cols, cols_mac, cols_reduce): the
    32-bit halves of x_i times the 22-bit limbs of w_i and w_i', summed in
    three columns below 2^60, then folded."""
    cols = []
    for k in range(3):
        c = init[k] + sum((x & M32) * t[k] + ((x >> 32) & M32) * t[3 + k]
                          for x, t in zip(xs, terms))
        if not bool(((c >> 60) == 0).all()):
            raise AssertionError("limb column above 2^60")
        cols.append(c)
    return _fold_cols(*cols)


def _full_round(s, mds, c):
    """sbox(s) . M + c for M < 2^16 (kernel: full_round, fold_small): the
    32-bit halves of each S-box output times the M entries, summed in two
    columns that c's halves start, below 2^52 so that the kernel's doubles
    hold them exactly, then one fold."""
    s = [_sbox_nc(x) for x in s]
    lo = (c & M32) + sum((x & M32)[..., None] * mds[i]
                         for i, x in enumerate(s))
    hi = ((c >> 32) & M32) + sum(((x >> 32) & M32)[..., None] * mds[i]
                                 for i, x in enumerate(s))
    if not bool(((lo >> 52) == 0).all() and ((hi >> 52) == 0).all()):
        raise AssertionError("small-MDS sums above 2^52")
    x = ((hi >> 32) & M32) * EPS + lo
    r = x + (hi << 32)
    r = torch.where(dev.ult(r, x), r + EPS, r)
    return list(r.unbind(-1))


def _permute_sparse_plain(state):
    """Plain PyTorch model of the kernels' permutation: the sparse partial
    rounds, the lazy limb-column sums and the non-canonical
    intermediates of csrc/poseidon_gl.cu, step for step, over the packed
    table kernel_constants().  Equal to _permute_plain on every 64-bit
    input."""
    k = _kernel_tables(state.device)
    full_c = k["full_c"][..., 0] | (k["full_c"][..., 1] << 32)
    mds = (k["mds"][..., 0] | (k["mds"][..., 1] << 32)).view(
        torch.float64).long()
    s = [_add_nc(x, c) for x, c in zip(state.unbind(-1), full_c[0])]
    half = pc.FULL_ROUNDS // 2
    for r in range(half - 1):
        s = _full_round(s, mds, full_c[r + 1])
    s = [_sbox_nc(x) for x in s]
    s = [_dot_cols(s, k["pre"][j], k["first_c"][j]) for j in range(WIDTH)]
    nv = 2 * (WIDTH - 1)
    for row in k["partial"]:
        v = row[0:nv:2] | (row[1:nv:2] << 32)
        c0, terms = row[nv:nv + 3], row[nv + 4:].reshape(WIDTH, _TERM)
        s0 = _sbox_nc(s[0])
        rest = []
        for x, vj in zip(s[1:], v):
            lo, hi = _mul128(s0, vj)
            lo = lo + x
            rest.append(_reduce128_nc(lo, hi + dev.ult(lo, x).long()))
        s = [_dot_cols(s[1:] + [s0], terms, c0)] + rest
    s = [_add_nc(x, c) for x, c in zip(s, full_c[half])]
    for r in range(half, pc.FULL_ROUNDS - 1):
        s = _full_round(s, mds, full_c[r + 1])
    s = _full_round(s, mds, torch.zeros_like(full_c[0]))
    return gl._cond_sub_p(torch.stack(s, dim=-1))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_constants_set: set = set()


def _poseidon_lib(device: torch.device):
    """The loaded kernel library, with kernel_constants() uploaded to its
    constant table on `device` (once per device)."""
    lib = kernels.load("poseidon_gl")
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _constants_set:
        table = np.ascontiguousarray(kernel_constants())
        with torch.cuda.device(device):
            kernels.check(lib.poseidon_set_constants(table.ctypes.data,
                                                     table.size),
                          "poseidon_set_constants")
        _constants_set.add(key)
    return lib


def _check_cuda(name: str, t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {t.device}")
    if t.dtype != gl.DTYPE:
        raise TypeError(f"{name}: int64 tensor expected")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor expected")


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation of (..., 12) int64 states.  Wrapper of the
    ``poseidon_permute`` kernel: a CPU tensor takes the plain version."""
    if state.device.type == "cpu":
        return _permute_plain(state)
    _check_cuda("permute", state)
    if state.dim() == 0 or state.shape[-1] != WIDTH:
        raise ValueError(f"permute: shape (..., {WIDTH}) expected, got "
                         f"{tuple(state.shape)}")
    out = torch.empty_like(state)
    n = state.numel() // WIDTH
    if n == 0:
        return out
    lib = _poseidon_lib(state.device)
    kernels.LAUNCHES["poseidon_permute"] += 1
    kernels.check(lib.poseidon_permute_launch(
        state.data_ptr(), out.data_ptr(), n,
        kernels.stream_ptr(state.device)), "poseidon_permute_launch")
    return out


def _linear_hash_plain(rows, width: int, capacity=None):
    """Plain PyTorch version of the poseidon_linear_hash kernel: RATE-8
    chunks (the last zero-padded) absorbed through _permute_plain with
    the previous digest as capacity, seeded by `capacity` (zero if
    None)."""
    batch = rows.shape[0]
    digest = gl.zeros((batch, CAPACITY), rows.device) if capacity is None \
        else capacity
    for start in range(0, width, RATE):
        n = min(RATE, width - start)
        parts = [rows[:, start:start + n]]
        if n < RATE:
            parts.append(gl.zeros((batch, RATE - n), rows.device))
        state = torch.cat(parts + [digest], dim=1)
        digest = _permute_plain(state)[:, :HASH_SIZE]
    return digest.contiguous()


def linear_hash(rows, width: int, capacity=None):
    """Hash (batch, width) rows to (batch, 4) digests.

    RATE chunks are absorbed with the previous digest as capacity, the
    first with `capacity` ((batch, 4), the digest of the row's earlier
    RATE-aligned columns) or zero.  A one-shot row (no `capacity`) of
    width <= 4 returns the zero-padded row (no kernel).  `rows` may be a
    column block of a wider tensor (unit column stride): the kernel reads
    it in place.  Wrapper of the ``poseidon_linear_hash`` kernel: a CPU
    tensor takes the plain version."""
    if rows.dim() != 2 or rows.shape[1] != width:
        raise ValueError(f"linear_hash: (n, {width}) rows expected, got "
                         f"{tuple(rows.shape)}")
    batch = rows.shape[0]
    if capacity is not None and (tuple(capacity.shape) != (batch, CAPACITY)
                                 or capacity.device != rows.device):
        raise ValueError(f"linear_hash: capacity ({batch}, {CAPACITY}) on "
                         f"{rows.device} expected, got "
                         f"{tuple(capacity.shape)} on {capacity.device}")
    if capacity is None and width <= CAPACITY:
        return torch.cat([rows, gl.zeros((batch, CAPACITY - width),
                                         rows.device)], dim=1)
    if rows.device.type == "cpu":
        return _linear_hash_plain(rows, width, capacity)
    if rows.dtype != gl.DTYPE or (width > 1 and rows.stride(1) != 1):
        raise ValueError("linear_hash: int64 rows of unit column stride "
                         "expected")
    if rows.device.type != "cuda":
        raise ValueError(f"linear_hash: tensor on {rows.device}")
    if capacity is not None:
        _check_cuda("linear_hash capacity", capacity)
    out = torch.empty((batch, HASH_SIZE), dtype=rows.dtype,
                      device=rows.device)
    if batch == 0:
        return out
    lib = _poseidon_lib(rows.device)
    kernels.LAUNCHES["poseidon_linear_hash"] += 1
    kernels.check(lib.poseidon_linear_hash_launch(
        rows.data_ptr(), None if capacity is None else capacity.data_ptr(),
        out.data_ptr(), batch, width, rows.stride(0),
        kernels.stream_ptr(rows.device)), "poseidon_linear_hash_launch")
    return out


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
