"""Poseidon-Goldilocks parameters (t=12, R_F=8, R_P=22).

Counterpart of ``xlayer_prover_tpu/ops/poseidon_constants.py``, holding
its own copy of the official parameter file,
``data/poseidon_goldilocks_official.json``: {"C": [360 round constants],
"M": [[12x12 MDS]]}, M in the row-vector convention
out_j = sum_i s_i * M[i][j].
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

from ..fields import gl

P = gl.P

WIDTH = 12          # t: 8 rate + 4 capacity
RATE = 8
CAPACITY = 4
FULL_ROUNDS = 8     # R_F (4 at start, 4 at end)
PARTIAL_ROUNDS = 22  # R_P
N_ROUND_CONSTANTS = WIDTH * (FULL_ROUNDS + PARTIAL_ROUNDS)  # 360

_OFFICIAL_FILE = os.path.join(os.path.dirname(__file__), "data",
                              "poseidon_goldilocks_official.json")


@functools.lru_cache(maxsize=None)
def get_params():
    """(C[360], M[12][12]) as python ints, from the official file."""
    with open(_OFFICIAL_FILE) as f:
        data = json.load(f)
    consts = [int(c) % P for c in data["C"]][:N_ROUND_CONSTANTS]
    mds = [[int(v) % P for v in row] for row in data["M"]]
    if len(consts) != N_ROUND_CONSTANTS or len(mds) != WIDTH:
        raise ValueError(f"malformed Poseidon parameters in {_OFFICIAL_FILE}")
    return consts, mds


# ---------------------------------------------------------------------------
# Sparse partial rounds (Poseidon paper, App. B)
# ---------------------------------------------------------------------------

def _mat_mul(a, b):
    return [[sum(a[i][k] * b[k][j] for k in range(len(b))) % P
             for j in range(len(b[0]))] for i in range(len(a))]


def _vec_mat(s, m):
    return [sum(s[i] * m[i][j] for i in range(len(s))) % P
            for j in range(len(m[0]))]


def _mat_inv(a):
    """Inverse mod P by Gauss-Jordan elimination."""
    n = len(a)
    aug = [row[:] + [int(i == j) for j in range(n)] for i, row in enumerate(a)]
    for c in range(n):
        piv = next(r for r in range(c, n) if aug[r][c])
        aug[c], aug[piv] = aug[piv], aug[c]
        iv = pow(aug[c][c], P - 2, P)
        aug[c] = [x * iv % P for x in aug[c]]
        for r in range(n):
            if r != c and aug[r][c]:
                f = aug[r][c]
                aug[r] = [(x - f * y) % P for x, y in zip(aug[r], aug[c])]
    return [row[n:] for row in aug]


@dataclasses.dataclass(frozen=True)
class SparseForm:
    """The permutation with each partial-round MDS factored into one sparse
    matrix, the same function as the dense round loop.  Row-vector order,
    out_j = sum_i s_i * m[i][j]:

      full rounds 1-3 and 5-8: s <- sbox(s + full_c[r]) . M
      full round 4:            s <- sbox(s + full_c[3]) . pre + first_c
      partial round k:         s_0 <- sbox(s_0 + lane0_c[k])  (lane0_c[0] = 0)
                               out_0 = s_0 m00 + sum_i s_{i+1} w_hat[i]
                               out_j = s_j + s_0 v[j-1]       (j >= 1)
    with sparse[k] = (m00, v, w_hat)."""
    full_c: tuple     # 8 x 12
    pre: tuple        # 12 x 12
    first_c: tuple    # 12
    lane0_c: tuple    # 22
    sparse: tuple     # 22 x (m00, v[11], w_hat[11])


@functools.lru_cache(maxsize=None)
def sparse_form() -> SparseForm:
    """Derive the sparse form from the official constants.

    A partial round touches lane 0 only before its MDS, so (1) the lane
    1-11 constants of partial rounds 2-22 move forward through M into the
    next round's constants, and (2) from the last partial round back, each
    matrix A (first M) splits as A = diag(1, A_hat) . [[a00, v], [w_hat, I]]
    with w_hat = A_hat^-1 w; the dense left factor commutes with the lane-0
    S-box and merges into the previous round's M (A <- M . diag(1, A_hat)),
    and the last one into full round 4's matrix `pre`."""
    consts, mds = get_params()
    half = FULL_ROUNDS // 2
    c = [list(consts[r * WIDTH:(r + 1) * WIDTH])
         for r in range(FULL_ROUNDS + PARTIAL_ROUNDS)]
    for r in range(half + 1, half + PARTIAL_ROUNDS):
        moved = _vec_mat([0] + c[r][1:], mds)
        c[r + 1] = [(x + y) % P for x, y in zip(c[r + 1], moved)]
        c[r] = [c[r][0]] + [0] * (WIDTH - 1)
    sparse = [None] * PARTIAL_ROUNDS
    a = mds
    for k in range(PARTIAL_ROUNDS - 1, -1, -1):
        w = [a[i][0] for i in range(1, WIDTH)]
        a_hat = [row[1:] for row in a[1:]]
        a_inv = _mat_inv(a_hat)
        w_hat = [sum(a_inv[i][j] * w[j] for j in range(WIDTH - 1)) % P
                 for i in range(WIDTH - 1)]
        sparse[k] = (a[0][0], tuple(a[0][1:]), tuple(w_hat))
        left = [[1] + [0] * (WIDTH - 1)] + [[0] + row for row in a_hat]
        a = _mat_mul(mds, left)
    return SparseForm(
        full_c=tuple(tuple(c[r]) for r in list(range(half)) + list(
            range(half + PARTIAL_ROUNDS, FULL_ROUNDS + PARTIAL_ROUNDS))),
        pre=tuple(map(tuple, a)),
        first_c=tuple(_vec_mat(c[half], left)),
        lane0_c=tuple([0] + [c[half + k][0] for k in range(1, PARTIAL_ROUNDS)]),
        sparse=tuple(sparse))
