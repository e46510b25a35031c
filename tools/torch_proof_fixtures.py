"""Proofs of the JAX package that the PyTorch port's CPU tests hold the
port's proofs against, byte for byte (``StarkProof.to_json()``).

    python tools/torch_proof_fixtures.py              # rewrite all
    python tools/torch_proof_fixtures.py binary_sm_n10_q4

writes ``tests/data/<name>.proof.json``.  The JAX prover takes minutes on
the CPU for these cases, so the fast tests read the files and the slow
tests (``-m slow``) prove each case with the JAX package again and compare.
The JAX package does not change, so a file goes stale only if its case
does.

Each case builder takes the package whose modules build it (the JAX
package or the port), so both build the same trace from one definition.
"""

from __future__ import annotations

import importlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def binary_sm_case(pkg: str, n_bits: int = 10):
    """The Binary SM as its own AIR (n_bits 10, chunk_bits 2, 4 queries)
    with seven seeded 256-bit actions.  -> (air, layout, const, cm1,
    publics)"""
    sm = importlib.import_module(f"{pkg}.models.zkevm.binary_sm")
    air_mod = importlib.import_module(f"{pkg}.stark.air")
    b = air_mod.AirBuilder("binary-sm", n_bits, n_queries=4, fri_fold_bits=3)
    layout = sm.build(b, n_bits, 2)
    air = b.compile()
    const_np = np.zeros((air.n, air.const_width), dtype=np.uint64)
    sm.fill_fixed(layout, const_np)
    cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
    rng = np.random.default_rng(77)
    acts = []
    for op in ["ADD", "SUB", "AND", "XOR", "OR", "LT", "EQ"]:
        a = int(rng.integers(0, 1 << 62)) << 190 | int(rng.integers(0, 1 << 62))
        b_ = int(rng.integers(0, 1 << 62)) << 100 | int(rng.integers(0, 1 << 62))
        acts.append((op, a, b_))
    sm.expand_trace(layout, acts[:air.n // layout.rows_per_op], cm1)
    return air, layout, const_np, cm1, []


COMPOSITE_MEM = [("W", 3, 10, 0), ("R", 3, 10, 1), ("W", 8, 5, 2),
                 ("R", 8, 5, 4)]


def composite_case(pkg: str, seed: int = 20260816):
    """The miniature composite (Main dispatch + Binary + Memory, n_bits
    11, chunk_bits 2, 4 queries): an ADD and an XOR of two seeded 60-bit
    operands, two writes and two reads.  -> (air, layout, const, cm1,
    publics)"""
    composite = importlib.import_module(f"{pkg}.models.zkevm.composite")
    air, layout = composite.build(n_bits=11, chunk_bits=2, n_queries=4)
    rng = np.random.default_rng(seed)
    a = int(rng.integers(0, 1 << 60))
    b = int(rng.integers(0, 1 << 60))
    const_np, cm1, _ = composite.gen_trace(
        air, layout, [("ADD", a, b), ("XOR", a, b)], COMPOSITE_MEM)
    return air, layout, const_np, cm1, []


def zkevm_mini_case(pkg: str):
    """The mini-ROM executed into the zkEVM composite AIR at the geometry of
    the JAX package's zkEVM proof test (n_bits 13, chunk_bits 2, limb_bits
    8, 4 queries).  -> (air, layout, const, cm1, publics)"""
    from xlayer_prover_tpu_torch.models.zkevm import mini_rom
    if pkg == "xlayer_prover_tpu":
        from tests.test_zkevm_proof import mini_rom as jmini_rom
        from xlayer_prover_tpu.executor.executor import Executor
        from xlayer_prover_tpu.state.hashdb import HashDB
        ex = Executor(jmini_rom(), **mini_rom.GEOMETRIES[13])
        res = ex.execute(HashDB())
    else:
        ex, res = mini_rom.execute(13)
    return ex.air, ex.layout, res.const_np, res.cm1_np, res.publics


CASES = {"binary_sm_n10_q4": binary_sm_case,
         "composite_n11_q4": composite_case,
         "zkevm_mini_n13_q4": zkevm_mini_case}


def path(name: str) -> str:
    return os.path.join(DATA, f"{name}.proof.json")


def read(name: str) -> str:
    with open(path(name)) as f:
        return f.read()


def jax_proof(name: str) -> str:
    """The JAX package's proof of case `name` on the CPU, as JSON."""
    from xlayer_prover_tpu.stark import prover
    air, _layout, const_np, cm1, publics = CASES[name]("xlayer_prover_tpu")
    setup = prover.Setup.build(air, const_np)
    return prover.gen_proof(setup, cm1, publics).to_json()


def main(names) -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(DATA, exist_ok=True)
    for name in names or list(CASES):
        text = jax_proof(name)
        with open(path(name), "w") as f:
            f.write(text)
        print(f"wrote {path(name)} ({len(text)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
