"""Composite zkEVM-style circuit: Main dispatch + Binary SM + Memory SM in
ONE AIR with cross-SM plookups.

This is the reference's core architectural pattern in miniature: all state
machines commit columns into a single STARK (751 pols over one domain in
the full zkevm; commit_pols.hpp), and the Main SM's operations are bound to
the secondary SMs by plookup/permutation arguments over the shared domain.

Here the "main" group is a dispatch table: each active row claims one
256-bit binary operation (opcode, a, b, c as 8 x 32-bit limbs) and a
selected plookup sends the 26-column tuple into the Binary SM's op-exposure
rows (the accumulator columns at each op's LAST row).  The Memory SM rides
along in the same AIR with its own consistency argument — demonstrating
multi-SM composition exactly as the full zkEVM circuit will assemble.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/composite.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...stark.air import AirBuilder
from . import binary_sm, memory_sm


@dataclasses.dataclass
class CompositeLayout:
    binary: binary_sm.BinaryLayout
    memory: memory_sm.MemoryLayout
    main: dict     # name -> Col


def build(n_bits: int = 11, chunk_bits: int = 4, n_queries: int = 4):
    b = AirBuilder("zkevm-composite", n_bits, n_queries=n_queries,
                   fri_fold_bits=3)
    bin_layout = binary_sm.build(b, n_bits, chunk_bits)
    mem_layout = memory_sm.build(b, n_bits)

    main = {"sel_bin": b.witness("main_sel_bin"),
            "op": b.witness("main_bin_op")}
    for v in ("a", "b", "c"):
        for j in range(8):
            main[f"{v}{j}"] = b.witness(f"main_{v}{j}")

    # cross-SM lookup: main's claimed (op, a, b, c) tuples must appear among
    # the Binary SM's completed ops (LAST-row exposure)
    f_cols = [main["op"]] + [main[f"{v}{j}"] for v in ("a", "b", "c")
                             for j in range(8)]
    t_cols = [bin_layout.witness["op"]] + \
        [bin_layout.witness[f"{v}{j}"] for v in ("a", "b", "c")
         for j in range(8)]
    b.plookup(f_cols, t_cols, f_sel=main["sel_bin"],
              t_sel=bin_layout.fixed["LAST"])

    air = b.compile()
    return air, CompositeLayout(binary=bin_layout, memory=mem_layout,
                                main=main)


def gen_trace(air, layout: CompositeLayout, bin_actions, mem_actions,
              rng=None):
    """Fill const + cm1 for the composite; main rows claim the binary
    results computed by the expander."""
    n = air.n
    const_np = np.zeros((n, air.const_width), dtype=np.uint64)
    binary_sm.fill_fixed(layout.binary, const_np)
    memory_sm.fill_fixed(layout.memory, const_np)

    cm1 = np.zeros((n, air.cm1_width), dtype=np.uint64)
    results = binary_sm.expand_trace(layout.binary, bin_actions, cm1)
    memory_sm.expand_trace(layout.memory, mem_actions, cm1)

    for k, ((opname, a, b), (c, _carry)) in enumerate(zip(bin_actions,
                                                          results)):
        cm1[k, layout.main["sel_bin"].index] = 1
        cm1[k, layout.main["op"].index] = binary_sm.OPCODES[opname]
        for j in range(8):
            cm1[k, layout.main[f"a{j}"].index] = (a >> (32 * j)) & 0xFFFFFFFF
            cm1[k, layout.main[f"b{j}"].index] = (b >> (32 * j)) & 0xFFFFFFFF
            cm1[k, layout.main[f"c{j}"].index] = (c >> (32 * j)) & 0xFFFFFFFF
    return const_np, cm1, results
