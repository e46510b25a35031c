"""Port parity: the mini-ROM executed into the zkEVM composite AIR (Main +
Binary, Memory, Arith, PoseidonG, PaddingPG, MemAlign, ArithEC; n_bits 13,
chunk_bits 2, limb_bits 8, 4 queries) and proven by xlayer_prover_tpu_torch
on the CPU is byte-equal to the JAX package's proof, committed as
``tests/data/zkevm_mini_n13_q4.proof.json``, and verifies under both
verifiers.  Both tests are slow: the port's CPU proof hashes ~2.5 M
Poseidon permutations through the plain PyTorch version of the kernels,
and the JAX package's proof takes minutes.  ``chip_smoke.py`` holds the
card's proof of the same case against the same file."""

import pytest

from xlayer_prover_tpu.stark import verifier as jverifier
from xlayer_prover_tpu_torch.stark import prover, verifier

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

CASE = "zkevm_mini_n13_q4"


@pytest.mark.slow
def test_zkevm_mini_proof_byte_equal_and_verifies():
    air, _layout, const_np, cm1, publics = fixtures.zkevm_mini_case(
        "xlayer_prover_tpu_torch")
    jair, *_ = fixtures.zkevm_mini_case("xlayer_prover_tpu")
    assert len(air.permutations) == 1 and len(air.plookups) == 50
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1, publics)
    assert proof.to_json() == fixtures.read(CASE)
    assert jverifier.verify(jair, setup.verkey, proof)
    assert verifier.verify(air, setup.verkey, proof)


@pytest.mark.slow
def test_zkevm_mini_fixture_is_the_jax_proof():
    assert fixtures.jax_proof(CASE) == fixtures.read(CASE)
