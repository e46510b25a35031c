"""Poseidon over BN254 Fr (the circomlib "optimized" variant).

Counterpart of ``xlayer_prover_tpu/ops/poseidon_bn254.py``: t = len(state)
in [2, 17], 8 full rounds, ``N_ROUNDS_P[t - 2]`` partial rounds, x^5
S-box, the partial rounds in the compressed (P-matrix + sparse S-vector)
form.  It serves the BN128 commitment scheme of the recursiveF stage
(``stark/commitment.py``: arity-16 Merkle trees and TranscriptBN128).

  * ``permute(states, t)``: a batch of permutations over an (n, t, 4)
    int64 tensor of canonical little-endian 64-bit limbs (any 256-bit
    input is reduced mod P first).  On a CUDA tensor it launches the
    ``poseidon_bn254_permute`` kernel (``csrc/poseidon_bn254.cu``); on a
    CPU tensor it runs the plain version ``_permute_plain``.
  * ``leaf_hash(rows, width)``: every row of a (n, width) matrix of
    Goldilocks words to its Fr digest, as ``leaf_hash_bn128``.  On a CUDA
    tensor it launches ``poseidon_bn254_leaf_hash``; on a CPU tensor it
    runs ``_leaf_hash_plain``.
  * ``host_permute`` / ``hash_n`` / ``leaf_hash_host``: Python-int
    versions for the transcript and the verifier.
  * ``kernel_table(t)``: the constants of width t in Montgomery form
    (R = 2^256) as 32-bit words, the table the kernels read.
  * ``_permute_model`` / ``_leaf_hash_model``: the kernels' schedule step
    by step on Python ints (a state split over a group of lanes, lazy
    reduced dot products, the square), for the tests.

The constants are a copy of the JAX package's
``ops/data/poseidon_bn254_constants.json`` (gzipped here, checked against
the sha256 of the JSON when read).
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import json
import os

import numpy as np
import torch

from .. import kernels
from . import bn254_mont

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

N_ROUNDS_F = 8
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
ARITY = 16                  # children of a tree node, Fr of a sponge chunk
GL_PER_FR = 3               # Goldilocks words packed into one Fr

_DATA = os.path.join(os.path.dirname(__file__), "data",
                     "poseidon_bn254_constants.json.gz")
_DATA_SHA256 = \
    "2121854192b5df42a61365700075cb3a394ec9b1ac79f6e03f9cf972b06424e6"

# the kernels' Montgomery arithmetic (csrc/bn254.cuh): R = 2^256, 8 words
MONT_R = bn254_mont.MONT
MONT_N0INV = (-pow(P, -1, 1 << 32)) % (1 << 32)
MONT_R2 = MONT_R * MONT_R % P
MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1
# lanes a state in the kernels (csrc/poseidon_bn254.cu; a CPU test reads
# them there): 4 for a batch, 8 for one too small to give every scheduler
# of the card a warp at 4, 1 for t <= SMALL_T
GROUP = 4
GROUP_FEW = 8
SMALL_T = 5


@functools.lru_cache(maxsize=None)
def _constants():
    """(C, M, P-matrix, S) per width t (index t - 2), Python ints."""
    with gzip.open(_DATA, "rb") as f:
        raw = f.read()
    got = hashlib.sha256(raw).hexdigest()
    if got != _DATA_SHA256:
        raise RuntimeError(f"{_DATA}: sha256 {got} != {_DATA_SHA256}")
    d = json.loads(raw)
    if d["N_ROUNDS_P"] != N_ROUNDS_P:
        raise RuntimeError(f"{_DATA}: partial-round counts differ")
    return d["C"], d["M"], d["P"], d["S"]


def _params(t: int):
    if not 2 <= t <= 17:
        raise ValueError(f"Poseidon-BN254 width {t} is not in [2, 17]")
    C, M, Pm, S = _constants()
    return C[t - 2], M[t - 2], Pm[t - 2], S[t - 2], N_ROUNDS_P[t - 2]


# ---------------------------------------------------------------------------
# Host (Python ints): the transcript and the verifier
# ---------------------------------------------------------------------------

def host_permute(state):
    """Full Poseidon permutation of Python ints; t = len(state)."""
    t = len(state)
    c, m, pmat, s, nrp = _params(t)
    st = [int(v) % P for v in state]

    def e5(x):
        return pow(x, 5, P)

    def mix(vals, mat):
        return [sum(mat[j][i] * vals[j] for j in range(t)) % P
                for i in range(t)]

    st = [(st[i] + c[i]) % P for i in range(t)]
    for r in range(N_ROUNDS_F // 2 - 1):
        st = [(e5(st[i]) + c[(r + 1) * t + i]) % P for i in range(t)]
        st = mix(st, m)
    st = [(e5(st[i]) + c[(N_ROUNDS_F // 2) * t + i]) % P for i in range(t)]
    st = mix(st, pmat)
    for r in range(nrp):
        st[0] = (e5(st[0]) + c[(N_ROUNDS_F // 2 + 1) * t + r]) % P
        s0 = sum(s[(t * 2 - 1) * r + j] * st[j] for j in range(t)) % P
        for j in range(1, t):
            st[j] = (st[j] + st[0] * s[(t * 2 - 1) * r + t + j - 1]) % P
        st[0] = s0
    for r in range(N_ROUNDS_F // 2 - 1):
        st = [(e5(st[i]) + c[(N_ROUNDS_F // 2 + 1) * t + nrp + r * t + i])
              % P for i in range(t)]
        st = mix(st, m)
    st = [e5(x) for x in st]
    return mix(st, m)


def hash_n(inputs):
    """poseidon(inputs): capacity 0 prepended, first output returned
    (Poseidon_opt::hash(state, result) semantics)."""
    return host_permute([0] + [int(v) % P for v in inputs])[0]


def pack_row(row):
    """Goldilocks words -> Fr elements, three words (192 bits < P) each."""
    out = []
    for start in range(0, len(row), GL_PER_FR):
        v = 0
        for k, g in enumerate(row[start:start + GL_PER_FR]):
            v |= int(g) << (64 * k)
        out.append(v % P)
    return out


def leaf_hash_host(row) -> int:
    """merkleTreeBN128 linearHash of one row of Goldilocks words: a row of
    width <= 4 is its 256-bit packing mod P; a wider row is packed three
    words an Fr and absorbed 16 Fr a permutation (t = 17) with the digest
    first, the last chunk of b < 16 Fr unpadded at t = b + 1."""
    if len(row) <= 4:
        v = 0
        for k, g in enumerate(row):
            v |= int(g) << (64 * k)
        return v % P
    packed = pack_row(row)
    digest = 0
    for pos in range(0, len(packed), ARITY):
        digest = host_permute([digest] + packed[pos:pos + ARITY])[0]
    return digest


# ---------------------------------------------------------------------------
# The kernels' constant table
# ---------------------------------------------------------------------------

def table_layout(t: int):
    """(offsets, total) of the kernels' table of width t, in constants of
    eight 32-bit words: round constants c (8t + nrp), the MDS matrix m
    (t x t, m[j][i] at j t + i), the pre-sparse matrix p (t x t) and the
    sparse vectors s ((2t - 1) nrp)."""
    nrp = N_ROUNDS_P[t - 2]
    sizes = (("c", N_ROUNDS_F * t + nrp), ("m", t * t), ("p", t * t),
             ("s", (2 * t - 1) * nrp))
    offs, pos = {}, 0
    for name, n in sizes:
        offs[name] = pos
        pos += n
    return offs, pos


@functools.lru_cache(maxsize=None)
def kernel_table(t: int) -> np.ndarray:
    """The constants of width t in Montgomery form (v 2^256 mod P), eight
    little-endian 32-bit words each, in ``table_layout`` order."""
    c, m, pmat, s, _nrp = _params(t)
    vals = list(c) + [m[j][i] for j in range(t) for i in range(t)] + \
        [pmat[j][i] for j in range(t) for i in range(t)] + list(s)
    if len(vals) != table_layout(t)[1]:
        raise RuntimeError(f"Poseidon-BN254 t={t}: table size")
    words = [((v * MONT_R % P) >> (32 * k)) & 0xFFFFFFFF
             for v in vals for k in range(8)]
    return np.array(words, dtype=np.uint32)


# ---------------------------------------------------------------------------
# The kernels' schedule, step by step on Python ints
# ---------------------------------------------------------------------------
#
# csrc/poseidon_bn254.cu over bn254.cuh's wide arithmetic: values in
# Montgomery form (R = 2^256), canonical between steps (the S-box's x^2
# and x^4 below 2P); a dot product's
# terms summed exactly below 2^512 and reduced once.  Each step asserts
# the bound that its code relies on.

def _words(v: int) -> list:
    return [(v >> (32 * k)) & MASK32 for k in range(8)]


def _mul_wide(a: int, b: int) -> int:
    """fr_mul_wide: a b by rows a b_i; the rows 0..i fit i + 9 words."""
    p = 0
    for i, bi in enumerate(_words(b)):
        p += (a * bi) << (32 * i)
        assert p >> (32 * (i + 9)) == 0
    return p


def _sqr_wide(a: int) -> int:
    """fr_sqr_wide: the products a_i a_j (i < j) by rows, row i finding
    word i + 8 zero, doubled; then the squares a_i^2."""
    w = _words(a)
    off = 0
    for i in range(7):
        assert off >> (32 * (i + 8)) == 0
        off += sum(w[i] * w[j] << (32 * (i + j)) for j in range(i + 1, 8))
    assert off >> 480 == 0
    return 2 * off + sum(w[i] * w[i] << (64 * i) for i in range(8))


def _canon(y: int) -> int:
    """fr_canon: any 256-bit y -> y mod P: y - q P with q from the top
    words, then one conditional subtraction."""
    assert 0 <= y < 1 << 256
    d = y - (y >> 224) // ((P >> 224) + 1) * P
    assert 0 <= d < 2 * P
    return d - P if d >= P else d


def _redc_lazy(s: int, add: int = 0) -> int:
    """fr_redc_lazy_add: S_hi + add + the CIOS reduction of S_lo (at most P),
    S / R + add mod P but not made canonical."""
    assert 0 <= s < 1 << 512 and 0 <= add < P
    u = s & (MONT_R - 1)
    for _ in range(8):
        u = (u + (u & MASK32) * MONT_N0INV % (1 << 32) * P) >> 32
    assert u <= P
    return (s >> 256) + add + u


def _redc_wide(s: int, add: int = 0) -> int:
    """fr_redc_wide_add: S / R + add mod P for S < 2^512 and a canonical
    add, made canonical."""
    return _canon(_redc_lazy(s, add))


def _sbox(x: int, c: int) -> int:
    """x^5 + c: two squares and a product, c the last reduction's addend.
    x^2 and x^4 stay below 2P unreduced (a square of a value below 2P has
    S_hi < 0.76 P)."""
    x2 = _redc_lazy(_sqr_wide(x))
    assert x2 < 2 * P
    x4 = _redc_lazy(_sqr_wide(x2))
    assert x4 < 2 * P
    return _redc_wide(_mul_wide(x4, x), c)


def _group_sum(accs: list) -> list:
    """The butterfly of __shfl_xor_sync over the group's lanes."""
    d = 1
    while d < len(accs):
        accs = [a + accs[lane ^ d] for lane, a in enumerate(accs)]
        assert all(a < 1 << 512 for a in accs)
        d <<= 1
    return accs


def _permute_group(lanes: list, t: int, tab) -> None:
    """permute_group: the permutation of a group's state, in place.
    ``lanes[l]`` = [x0, slot 0, ..., slot K - 1] of group lane l (state
    lane 1 + l + G i in slot i, 0 past t); ``tab(i)`` is constant i of
    ``kernel_table(t)`` (Montgomery form)."""
    g = len(lanes)
    k = len(lanes[0]) - 1
    nrp = N_ROUNDS_P[t - 2]
    m0 = N_ROUNDS_F * t + nrp
    p0, s0 = m0 + t * t, m0 + 2 * t * t
    half = N_ROUNDS_F // 2

    def elem(lane, i):
        return 1 + lane + g * i

    def read(lane, i):
        return min(elem(lane, i), t - 1)

    def full_round(cbase, mo):
        for lane, st in enumerate(lanes):
            st[0] = _sbox(st[0], tab(cbase) if cbase >= 0 else 0)
            for i in range(k):
                e = elem(lane, i)
                y = _sbox(st[1 + i], tab(cbase + read(lane, i))
                          if cbase >= 0 else 0)
                st[1 + i] = y if e < t else 0
        row0 = []
        rows = []
        for lane, st in enumerate(lanes):
            acc = _mul_wide(st[0], tab(mo) if lane == 0 else 0)
            acc += sum(_mul_wide(st[1 + i], tab(mo + read(lane, i) * t))
                       for i in range(k))
            row0.append(acc)
            own = [_mul_wide(st[0], tab(mo + read(lane, i)))
                   for i in range(k)]
            for o in range(g):
                for i2 in range(k):
                    j = elem(o, i2)
                    if j < t:
                        v = lanes[o][1 + i2]          # __shfl_sync
                        for i in range(k):
                            own[i] += _mul_wide(
                                v, tab(mo + j * t + read(lane, i)))
            rows.append(own)
        row0 = _group_sum(row0)
        for lane, st in enumerate(lanes):
            st[0] = _redc_wide(row0[lane])
            for i in range(k):
                st[1 + i] = _redc_wide(rows[lane][i]) \
                    if elem(lane, i) < t else 0

    for r in range(half - 1):
        full_round((r + 1) * t, m0)
    full_round(half * t, p0)
    pc0 = (half + 1) * t
    for r in range(nrp):
        srow = s0 + (2 * t - 1) * r
        accs, ys = [], []
        for lane, st in enumerate(lanes):
            acc = sum(_mul_wide(st[1 + i], tab(srow + read(lane, i)))
                      for i in range(k))       # before the S-box is done
            y = _sbox(st[0], tab(pc0 + r))
            acc += _mul_wide(y, tab(srow) if lane == 0 else 0)
            accs.append(acc)
            ys.append(y)
        accs = _group_sum(accs)
        for lane, st in enumerate(lanes):
            st[0] = _redc_wide(accs[lane])
            for i in range(k):
                upd = _redc_wide(_mul_wide(
                    ys[lane], tab(srow + t + read(lane, i) - 1)), st[1 + i])
                st[1 + i] = upd if elem(lane, i) < t else 0
    fc0 = pc0 + nrp
    for r in range(half - 1):
        full_round(fc0 + r * t, m0)
    full_round(-1, m0)
    assert all(st[0] == lanes[0][0] for st in lanes)


@functools.lru_cache(maxsize=None)
def _table_ints(t: int) -> tuple:
    w = kernel_table(t).astype(object).reshape(-1, 8)
    return tuple(sum(int(v) << (32 * k) for k, v in enumerate(row))
                 for row in w)


def _split(values: list, t: int, g: int) -> list:
    """The group's lanes of a Montgomery-form state of width t: x0 on
    every lane, state lane e >= 1 in slot (e - 1) // g of lane (e - 1) % g
    (0 past t)."""
    k = -(-(t - 1) // g)
    return [[values[0]] + [values[e] if (e := 1 + lane + g * i) < t else 0
                           for i in range(k)] for lane in range(g)]


def _join(lanes: list, t: int) -> list:
    g = len(lanes)
    return [lanes[0][0]] + [lanes[(e - 1) % g][1 + (e - 1) // g]
                            for e in range(1, t)]


def _absorb_model(digest: int, chunk: list, g: int) -> int:
    t = len(chunk) + 1
    tab = _table_ints(t).__getitem__
    vals = [(v + tab(e)) % P for e, v in enumerate([digest] + chunk)]
    lanes = _split(vals, t, g)
    _permute_group(lanes, t, tab)
    return lanes[0][0]


def _permute_model(state, g: int = GROUP) -> list:
    """poseidon_bn254_permute's schedule on one state of Python ints (any
    256-bit values; t = len(state)) over a group of g lanes; canonical
    outputs, equal to ``host_permute``."""
    t = len(state)
    _params(t)
    tab = _table_ints(t).__getitem__
    vals = [(int(v) * MONT_R + tab(e)) % P for e, v in enumerate(state)]
    lanes = _split(vals, t, g)
    _permute_group(lanes, t, tab)
    return [v * pow(MONT_R, -1, P) % P for v in _join(lanes, t)]


def _leaf_hash_model(row, g: int = GROUP) -> int:
    """poseidon_bn254_leaf_hash's schedule on one row of Goldilocks words:
    16 packed Fr a t = 17 chunk, the tail at t = b + 1, the digest in x0."""
    if len(row) <= 4:
        return leaf_hash_host(row)
    packed = [v * MONT_R % P for v in pack_row(row)]
    n_full = (len(packed) - 1) // ARITY
    digest = 0
    for ch in range(n_full + 1):
        digest = _absorb_model(digest, packed[ch * ARITY:(ch + 1) * ARITY],
                               g)
    return digest * pow(MONT_R, -1, P) % P


# ---------------------------------------------------------------------------
# The plain PyTorch version: Montgomery arithmetic on 16-bit limbs
# ---------------------------------------------------------------------------
#
# Fr values in Montgomery form over L = 17 limbs of 16 bits, R' = 2^272
# (ops/bn254_mont.py).  Nothing here models the kernels' 8 x 32-bit CIOS:
# both compute the same field elements, canonical on output.

_FR = bn254_mont.FR
L = bn254_mont.L
_redc, _mul, _mont = _FR.redc, _FR.mul, _FR.mont
_to_plain, _from_plain = _FR.to_mont, _FR.from_mont
_toeplitz = bn254_mont.toeplitz


def _pow5(x):
    x2 = _mul(x, x)
    return _mul(_mul(x2, x2), x)


@functools.lru_cache(maxsize=None)
def _plain_tables(t: int, device: torch.device) -> dict:
    """Width t's constants for the plain version on `device`: round
    constants as limbs, and every product by constants as a Toeplitz
    matrix (flat limbs @ matrix = the convolutions, summed).

    The partial rounds are unrolled over the lanes 1..t-1: with a_j those
    lanes after the pre-sparse matrix and x_r the S-box output of round r,
    lane j in round r is a_j + sum_{q<r} x_q v_qj, so round r's new lane 0
    is sum_j s_rj a_j + sum_{q<=r} x_q k_rq with k_rr = s_r0 and
    k_rq = sum_{j>=1} s_rj v_qj, and the lanes are summed once at the end:
    ``a_dot`` (the a_j terms of every round), ``k`` (block q, r: k_rq) and
    ``v_end`` (block q, j - 1: v_qj)."""
    c, m, pmat, s, nrp = _params(t)

    def mat(mm):            # out_i = sum_j mm[j][i] st_j
        out = np.zeros((t * L, t * 2 * L), dtype=np.float64)
        for j in range(t):
            for i in range(t):
                out[j * L:(j + 1) * L, i * 2 * L:(i + 1) * 2 * L] = \
                    _toeplitz(_mont(mm[j][i]))
        return out

    w = 2 * t - 1
    srow = [s[w * r:w * r + t] for r in range(nrp)]          # s_r0 .. s_r,t-1
    vrow = [s[w * r + t:w * (r + 1)] for r in range(nrp)]    # v_r1 .. v_r,t-1
    a_dot = np.zeros(((t - 1) * L, nrp * 2 * L), dtype=np.float64)
    k = np.zeros((nrp * L, nrp * 2 * L), dtype=np.float64)
    v_end = np.zeros((nrp * L, (t - 1) * 2 * L), dtype=np.float64)
    for r in range(nrp):
        cols = slice(r * 2 * L, (r + 1) * 2 * L)
        for j in range(1, t):
            a_dot[(j - 1) * L:j * L, cols] = _toeplitz(_mont(srow[r][j]))
            v_end[r * L:(r + 1) * L, (j - 1) * 2 * L:j * 2 * L] = \
                _toeplitz(_mont(vrow[r][j - 1]))
        k[r * L:(r + 1) * L, cols] = _toeplitz(_mont(srow[r][0]))
        for q in range(r):
            kq = sum(srow[r][j] * vrow[q][j - 1] for j in range(1, t)) % P
            k[q * L:(q + 1) * L, cols] = _toeplitz(_mont(kq))

    def dev(a, dtype=torch.float64):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return {"c": dev(np.array([_mont(v) for v in c]), torch.int64),
            "m": dev(mat(m)), "p": dev(mat(pmat)), "a_dot": dev(a_dot),
            "k": dev(k), "v_end": dev(v_end), "nrp": nrp}


def _permute_chunk(states, t: int):
    tb = _plain_tables(t, states.device)
    n = states.shape[0]
    c, nrp = tb["c"], tb["nrp"]
    half = N_ROUNDS_F // 2

    def mix(st, mat):       # out_i = sum_j mat[j][i] st_j
        return _redc((st.reshape(n, t * L).to(torch.float64) @ mat)
                     .to(torch.int64).reshape(n, t, 2 * L))

    st = _to_plain(states) + c[:t]
    for r in range(half - 1):
        st = mix(_pow5(st) + c[(r + 1) * t:(r + 2) * t], tb["m"])
    st = mix(_pow5(st) + c[half * t:(half + 1) * t], tb["p"])
    base = (half + 1) * t
    a = st[:, 1:]
    sums = (a.reshape(n, (t - 1) * L).to(torch.float64) @ tb["a_dot"]) \
        .reshape(n, nrp, 2 * L)
    xs = torch.zeros((n, nrp * L), dtype=torch.float64, device=st.device)
    s0 = st[:, 0]
    for r in range(nrp):
        xs[:, r * L:(r + 1) * L] = _pow5(s0) + c[base + r]
        col = tb["k"][:(r + 1) * L, r * 2 * L:(r + 1) * 2 * L]
        s0 = _redc((sums[:, r] + xs[:, :(r + 1) * L] @ col)
                   .to(torch.int64))
    # a_j + sum_r x_r v_rj: a_j rides in the columns above R'
    T = (xs @ tb["v_end"]).to(torch.int64).reshape(n, t - 1, 2 * L)
    T[..., L:] += a
    st = torch.cat([s0.unsqueeze(1), _redc(T)], dim=1)
    base += nrp
    for r in range(half - 1):
        st = mix(_pow5(st) + c[base + r * t:base + (r + 1) * t], tb["m"])
    st = mix(_pow5(st), tb["m"])
    return _from_plain(st)


def _chunk_rows(device: torch.device) -> int:
    return 1 << 15 if device.type == "cuda" else 1 << 11


def _permute_plain(states, t: int):
    """Plain PyTorch version of the poseidon_bn254_permute kernel: (n, t,
    4) int64 limbs (any 256-bit values) -> canonical limbs, any device."""
    n = states.shape[0]
    if n == 0:
        return states.clone()
    step = _chunk_rows(states.device)
    return torch.cat([_permute_chunk(states[i:i + step], t)
                      for i in range(0, n, step)])


def _leaf_hash_plain(rows, width: int):
    """Plain PyTorch version of the poseidon_bn254_leaf_hash kernel."""
    n = rows.shape[0]
    dev = rows.device
    if n == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=dev)
    if width <= 4:           # the row's 256-bit packing mod P
        x = torch.cat([rows, torch.zeros((n, 4 - width), dtype=torch.int64,
                                         device=dev)], dim=1)
        return _from_plain(_to_plain(x))
    n_fr = -(-width // GL_PER_FR)
    pad = n_fr * GL_PER_FR - width
    words = torch.cat([rows, torch.zeros((n, pad), dtype=torch.int64,
                                         device=dev)], dim=1)
    packed = torch.cat([words.reshape(n, n_fr, GL_PER_FR),
                        torch.zeros((n, n_fr, 1), dtype=torch.int64,
                                    device=dev)], dim=2)     # (n, n_fr, 4)
    digest = torch.zeros((n, 1, 4), dtype=torch.int64, device=dev)
    for pos in range(0, n_fr, ARITY):
        chunk = packed[:, pos:pos + ARITY]
        state = torch.cat([digest, chunk], dim=1)
        digest = _permute_plain(state, state.shape[1])[:, :1]
    return digest[:, 0].contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _device_table(t: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_table(t).view(np.int32)).to(device)


def _check_cuda(name: str, x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: int64 tensor expected")
    if not x.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor expected")


def permute(states: torch.Tensor, t: int) -> torch.Tensor:
    """Poseidon-BN254 permutations of (n, t, 4) int64 limb states.
    Wrapper of the ``poseidon_bn254_permute`` kernel: a CPU tensor takes
    the plain version."""
    if states.dim() != 3 or states.shape[1:] != (t, 4):
        raise ValueError(f"permute: (n, {t}, 4) states expected, got "
                         f"{tuple(states.shape)}")
    _params(t)
    if states.device.type == "cpu":
        return _permute_plain(states, t)
    _check_cuda("poseidon_bn254 permute", states)
    out = torch.empty_like(states)
    n = states.shape[0]
    if n == 0:
        return out
    lib = kernels.load("poseidon_bn254")
    table = _device_table(t, states.device)
    kernels.LAUNCHES["poseidon_bn254_permute"] += 1
    kernels.check(lib.poseidon_bn254_permute_launch(
        states.data_ptr(), out.data_ptr(), n, t, N_ROUNDS_P[t - 2],
        table.data_ptr(), kernels.stream_ptr(states.device)),
        "poseidon_bn254_permute_launch")
    return out


def leaf_hash(rows: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) int64 Goldilocks rows -> (n, 4) int64 limbs of their Fr
    digests (``leaf_hash_host`` semantics).  Wrapper of the
    ``poseidon_bn254_leaf_hash`` kernel: a CPU tensor takes the plain
    version."""
    if rows.dim() != 2 or rows.shape[1] != width:
        raise ValueError(f"leaf_hash: (n, {width}) rows expected, got "
                         f"{tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return _leaf_hash_plain(rows, width)
    _check_cuda("poseidon_bn254 leaf_hash", rows)
    n = rows.shape[0]
    out = torch.empty((n, 4), dtype=torch.int64, device=rows.device)
    if n == 0:
        return out
    n_fr = -(-width // GL_PER_FR)
    t_tail = (n_fr - 1) % ARITY + 2 if width > 4 else 17
    lib = kernels.load("poseidon_bn254")
    kernels.LAUNCHES["poseidon_bn254_leaf_hash"] += 1
    kernels.check(lib.poseidon_bn254_leaf_hash_launch(
        rows.data_ptr(), out.data_ptr(), n, width,
        _device_table(17, rows.device).data_ptr(), N_ROUNDS_P[15],
        _device_table(t_tail, rows.device).data_ptr(), t_tail,
        N_ROUNDS_P[t_tail - 2], kernels.stream_ptr(rows.device)),
        "poseidon_bn254_leaf_hash_launch")
    return out
