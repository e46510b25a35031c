"""PoseidonG SM: provable permutation-instance circuit + trace expander.

Equivalent of the reference PoseidonG SM (src/sm/poseidon_g/
poseidon_g_executor.cpp): every Poseidon invocation becomes a 31-row block
(input state + state after each of the 30 rounds) whose round function is
enforced by constraints: with committed S-box ladder columns
t2 = s^2, t4 = t2^2, t6 = t4*t2 (s = state + round constant), the
x^7 S-box is s*t6 and the MDS multiply keeps every constraint at
degree <= 4 — the same ladder the recursion gate AIR uses
(recursion/gate_air.py).  The expander fills blocks from the executor's
recorded Poseidon requests (storage key derivations + SMT value hashes,
Required.poseidon) and cross-checks against the host permutation.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/poseidon_g_sm.py``:
the host permutation is ``ops/poseidon_gl.host_permute``, the S-box ladder
columns are Goldilocks products of the port's ``fields/gl.py`` on CPU
tensors, the fixed columns and the padding blocks are filled a column at a
time, and the padding blocks' round states are computed once.  The
helpers that only the JAX package's tests use (``trace_rows``,
``collect_from_context``) are not carried over.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np

from ...fields import gl
from ...ops import poseidon_constants as pc
from ...ops.poseidon_gl import host_permute
from ...stark.air import AirBuilder, Const

ROWS_PER_PERM = 31


@dataclasses.dataclass
class PoseidonGLayout:
    fixed: dict
    witness: dict


def build(builder: AirBuilder, n_bits: int) -> PoseidonGLayout:
    """Add the PoseidonG column group + round constraints to the AIR."""
    consts, mds = pc.get_params()
    fixed = {"PROW": builder.fixed("PG_PROW"),
             "PFULL": builder.fixed("PG_PFULL"),
             "PFIRST": builder.fixed("PG_PFIRST")}
    for j in range(12):
        fixed[f"PC{j}"] = builder.fixed(f"PG_PC{j}")
    w = {}
    for j in range(12):
        w[f"ps{j}"] = builder.witness(f"pg_ps{j}")
    for name in ("t2", "t4", "t6"):
        for j in range(12):
            w[f"{name}{j}"] = builder.witness(f"pg_{name}{j}")

    one = Const(1)
    sbx = {}
    for j in range(12):
        s_j = w[f"ps{j}"] + fixed[f"PC{j}"]
        builder.constrain(w[f"t2{j}"] - s_j * s_j)
        builder.constrain(w[f"t4{j}"] - w[f"t2{j}"] * w[f"t2{j}"])
        builder.constrain(w[f"t6{j}"] - w[f"t4{j}"] * w[f"t2{j}"])
        st6 = s_j * w[f"t6{j}"]
        if j == 0:
            sbx[j] = st6
        else:
            sbx[j] = fixed["PFULL"] * st6 + (one - fixed["PFULL"]) * s_j
    for j in range(12):
        acc = None
        for k in range(12):
            term = sbx[k] * Const(mds[k][j])
            acc = term if acc is None else acc + term
        builder.constrain(fixed["PROW"] * (w[f"ps{j}"].shifted() - acc))
    return PoseidonGLayout(fixed=fixed, witness=w)


def _fixed_cols(n: int):
    """(PROW, PFULL, PFIRST, PC (n, 12)) of the block layout: a block is
    31 rows from row 0 on, its first 30 carry a round's constants."""
    consts, _ = pc.get_params()
    r = np.arange(n)
    in_blk = r % ROWS_PER_PERM
    inside = r < (n // ROWS_PER_PERM) * ROWS_PER_PERM
    prow = inside & (in_blk < ROWS_PER_PERM - 1)
    pfull = prow & ((in_blk < 4) | (in_blk >= 26))
    pfirst = inside & (in_blk == 0)
    table = np.array(consts, dtype=np.uint64).reshape(-1, 12)
    pc_cols = np.where(prow[:, None],
                       table[np.minimum(in_blk, ROWS_PER_PERM - 2)],
                       np.uint64(0))
    return prow, pfull, pfirst, pc_cols


def fill_fixed(layout: PoseidonGLayout, const_np: np.ndarray):
    prow, pfull, pfirst, pc_cols = _fixed_cols(const_np.shape[0])
    const_np[:, layout.fixed["PROW"].index] = prow
    const_np[:, layout.fixed["PFULL"].index] = pfull
    const_np[:, layout.fixed["PFIRST"].index] = pfirst
    for j in range(12):
        const_np[:, layout.fixed[f"PC{j}"].index] = pc_cols[:, j]


@functools.lru_cache(maxsize=1)
def _zero_rounds() -> np.ndarray:
    """(31, 12) round states of the zero-input permutation (the padding
    blocks; the reference pads the same way,
    poseidon_g_executor.cpp:255-305)."""
    return np.array(_round_states([0] * 12), dtype=np.uint64)


def expand_into(layout: PoseidonGLayout, requests: List[list],
                cm1_np: np.ndarray):
    """Fill committed columns from Poseidon requests; returns instances."""
    n = cm1_np.shape[0]
    assert len(requests) * ROWS_PER_PERM <= n, "too many poseidon requests"
    instances = expand(requests)
    w = layout.witness
    n_blocks = n // ROWS_PER_PERM
    states = np.zeros((n, 12), dtype=np.uint64)
    blocks = states[:n_blocks * ROWS_PER_PERM].reshape(n_blocks,
                                                       ROWS_PER_PERM, 12)
    blocks[:] = _zero_rounds()
    for bi, inst in enumerate(instances):
        blocks[bi] = np.array(inst.rounds, dtype=np.uint64)
    # aux ladder on EVERY row (global constraints; PC = 0 on pad rows)
    _, _, _, pc_cols = _fixed_cols(n)
    s = gl.add(gl.from_u64_np(states, "cpu"), gl.from_u64_np(pc_cols, "cpu"))
    t2 = gl.mul(s, s)
    t4 = gl.mul(t2, t2)
    t6 = gl.mul(t4, t2)
    ladder = {"t2": gl.to_u64_np(t2), "t4": gl.to_u64_np(t4),
              "t6": gl.to_u64_np(t6)}
    for j in range(12):
        cm1_np[:, w[f"ps{j}"].index] = states[:, j]
        for name, vals in ladder.items():
            cm1_np[:, w[f"{name}{j}"].index] = vals[:, j]
    return instances


@dataclasses.dataclass
class PoseidonInstance:
    input12: list
    output12: list
    rounds: list      # 31 x 12 states (input + after each round)


def _round_states(state):
    """All intermediate states of the canonical permutation (host-exact)."""
    P = 0xFFFFFFFF00000001
    consts, mds = pc.get_params()
    t = pc.WIDTH
    half = pc.FULL_ROUNDS // 2
    states = [list(state)]
    s = [v % P for v in state]
    r = 0

    def ark(x, r):
        return [(v + consts[r * t + i]) % P for i, v in enumerate(x)]

    def m(x):
        return [sum(x[i] * mds[i][j] for i in range(t)) % P for j in range(t)]

    for phase, count, full in (("f1", half, True),
                               ("p", pc.PARTIAL_ROUNDS, False),
                               ("f2", half, True)):
        for _ in range(count):
            s = ark(s, r)
            if full:
                s = [pow(v, 7, P) for v in s]
            else:
                s[0] = pow(s[0], 7, P)
            s = m(s)
            states.append(list(s))
            r += 1
    return states


def expand(requests: List[list]) -> List[PoseidonInstance]:
    """requests: list of 12-element inputs. Returns instances with full
    round decompositions; outputs cross-checked against the host
    permutation."""
    out = []
    for req in requests:
        assert len(req) == 12
        rounds = _round_states(req)
        output = rounds[-1]
        assert output == host_permute(list(req)), "host permute mismatch"
        out.append(PoseidonInstance(input12=list(req), output12=output,
                                    rounds=rounds))
    return out
