"""Toy circuit family: Fibonacci AIR with plookup + permutation arguments.

The bring-up circuit for the proving engine (the analogue of the reference's
standalone STARK harness, test/prover/main.cpp:6-30): small enough to verify
host-side, but exercising every protocol feature — transition constraints,
public-input boundary constraints, a plookup (range check of a nibble
column into a fixed table), and a permutation argument (rotated copy).
The port's own copy of ``xlayer_prover_tpu/models/toy/fib.py``.
"""

from __future__ import annotations

import numpy as np

from ...fields import gl
from ...stark.air import AirBuilder, Const

P = gl.P


def build_air(n_bits: int = 6, n_queries: int = 8, with_lookup: bool = True,
              with_permutation: bool = True):
    b = AirBuilder("toy-fib", n_bits, n_queries=n_queries, fri_fold_bits=2)
    islast = b.fixed("ISLAST")
    a = b.witness("a")
    bb = b.witness("b")
    pub_a0 = b.public(a, 0)
    pub_b0 = b.public(bb, 0)
    pub_res = b.public_value()

    not_last = Const(1) - islast
    b.constrain(not_last * (a.shifted() - bb))
    b.constrain(not_last * (bb.shifted() - a - bb))
    b.constrain(islast * (bb - pub_res))

    if with_lookup:
        table = b.fixed("NIBBLES")
        v = b.witness("v")
        b.plookup([v], [table])
    if with_permutation:
        c = b.witness("c")
        d = b.witness("d")
        b.permutation([c], [d])

    air = b.compile()
    return air


def gen_trace(air, a0: int = 1, b0: int = 1, seed: int = 0):
    """Returns (const_np, cm1_np, publics)."""
    n = air.n
    rng = np.random.default_rng(seed)
    const_np = np.zeros((n, air.const_width), dtype=np.uint64)
    const_np[n - 1, 0] = 1  # ISLAST
    cm1 = np.zeros((n, air.cm1_width), dtype=np.uint64)
    a, bb = a0 % P, b0 % P
    for i in range(n):
        cm1[i, 0] = a
        cm1[i, 1] = bb
        a, bb = bb, (a + bb) % P
    publics = [a0 % P, b0 % P, int(cm1[n - 1, 1])]

    col = 2
    if air.const_width > 1:  # NIBBLES table
        const_np[:, 1] = np.arange(n, dtype=np.uint64) % 16
        cm1[:, col] = rng.integers(0, 16, size=n, dtype=np.uint64)
        col += 1
    if air.cm1_width > col:  # permutation pair
        c = rng.integers(0, P, size=n, dtype=np.uint64)
        cm1[:, col] = c
        cm1[:, col + 1] = np.roll(c, 7)
        col += 2
    return const_np, cm1, publics
