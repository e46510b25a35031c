"""Port parity: the zkEVM Binary SM AIR (n_bits 10, chunk_bits 2) proven by
xlayer_prover_tpu_torch on the CPU is byte-equal (``StarkProof.to_json()``)
to the JAX package's proof and verifies under both verifiers; a flipped
trace cell is refused by the port's prover.  The JAX proof is the
committed ``tests/data/binary_sm_n10_q4.proof.json``; the slow test proves
the case with the JAX package again and compares
(``tools/torch_proof_fixtures.py`` rewrites the file)."""

import numpy as np
import pytest

from xlayer_prover_tpu.models.zkevm import binary_sm as jbinary
from xlayer_prover_tpu.stark import verifier as jverifier
from xlayer_prover_tpu.stark.air import AirBuilder as JAirBuilder
from xlayer_prover_tpu_torch.models.zkevm import binary_sm
from xlayer_prover_tpu_torch.stark import prover, verifier
from xlayer_prover_tpu_torch.stark.air import AirBuilder

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

CASE = "binary_sm_n10_q4"


def test_binary_sm_proof_byte_equal_and_verifies():
    air, layout, const_np, cm1, _ = fixtures.binary_sm_case(
        "xlayer_prover_tpu_torch")
    jair, _jl, jconst, jcm1, _ = fixtures.binary_sm_case("xlayer_prover_tpu")
    assert np.array_equal(jconst, const_np) and np.array_equal(jcm1, cm1)
    assert (air.cm3_width, air.q_deg, len(air.ev_map)) == \
        (jair.cm3_width, jair.q_deg, len(jair.ev_map))
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1, [])
    # the transcript opens with the verkey: equal proofs, equal verkeys
    assert proof.to_json() == fixtures.read(CASE)
    assert jverifier.verify(jair, setup.verkey, proof)
    assert verifier.verify(air, setup.verkey, proof)

    bad = cm1.copy()
    bad[5, layout.witness["c_chunk"].index] ^= np.uint64(1)
    with pytest.raises(prover.LookupMissingError):
        prover.gen_proof(setup, bad, [])


@pytest.mark.slow
def test_binary_sm_fixture_is_the_jax_proof():
    assert fixtures.jax_proof(CASE) == fixtures.read(CASE)


def _layout(air):
    return (air.n_bits, air.n_bits_ext, air.fri_steps, air.q_deg,
            air.const_width, air.cm1_width, air.cm2_width, air.cm3_width,
            len(air.constraints), [c.index for c, _e in air.im_defs],
            [(e.section, e.index, e.dim, e.shift) for e in air.ev_map])


@pytest.mark.parametrize("n_bits,chunk_bits", [(10, 2), (16, 4), (20, 4)])
def test_binary_air_layout_matches_jax(n_bits, chunk_bits):
    """The copied AIR IR and Binary SM builder commit the same columns,
    im_defs and evaluation map as the JAX package's."""
    b = AirBuilder("binary-sm", n_bits, n_queries=8, fri_fold_bits=3)
    binary_sm.build(b, n_bits, chunk_bits)
    jb = JAirBuilder("binary-sm", n_bits, n_queries=8, fri_fold_bits=3)
    jbinary.build(jb, n_bits, chunk_bits)
    assert _layout(b.compile()) == _layout(jb.compile())


def test_seeded_case_matches_jax_trace():
    """The smoke run's seeded Binary SM case: its actions give the trace
    the JAX package's expander gives, and the right 256-bit results."""
    air, layout, const_np, cm1, actions, results = binary_sm.seeded_case(
        10, 4, 5, chunk_bits=2)
    assert [op for op, _a, _b in actions] == ["ADD", "SUB", "AND", "OR"]
    jb = JAirBuilder("binary-sm", 10, n_queries=8, fri_fold_bits=3)
    jlayout = jbinary.build(jb, 10, 2)
    jair = jb.compile()
    assert _layout(air) == _layout(jair)
    jcm1 = np.zeros_like(cm1)
    assert jbinary.expand_trace(jlayout, actions, jcm1) == results
    assert np.array_equal(jcm1, cm1)
    mask = (1 << 256) - 1
    (_, a, b), (_, a1, b1) = actions[0], actions[1]
    assert results[0][0] == (a + b) & mask
    assert results[1][0] == (a1 - b1) & mask
