"""Port parity: proofs whose section plan streams (``stark/prover.py``:
the extended sections in host memory, the LDE and the leaf digests a
column block at a time, the quotient and round 5 over row windows) are
byte-equal (``StarkProof.to_json()``) to the committed JAX proofs and to
the port's resident proofs, and verify.  Each runs on the CPU under a
budget (``hbm_bytes``) small enough that the plan streams with several
column blocks and row windows; a Setup saved with host-resident
constants loads back and proves the same bytes.  The devnet cascade
plans only the inputs of the batches it proves."""

import types

import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures
from xlayer_prover_tpu.stark import verifier as jverifier
from xlayer_prover_tpu_torch import cascade
from xlayer_prover_tpu_torch.stark import prover, verifier
from xlayer_prover_tpu_torch.utils import devnet


def _streaming_budget(air, min_windows: int = 4) -> int:
    """The largest budget (in steps of 10%) under which the plan streams
    with at least `min_windows` row windows and more than one LDE column
    block of cm1."""
    budget = prover.section_plan(air, "cpu").plan["total_bytes"] * 2
    while True:
        sp = prover.section_plan(air, "cpu", budget)
        if sp.stream and air.n_ext // prover.window_rows(air, sp)[0] \
                >= min_windows and sp.block_cols < air.cm1_width:
            return budget
        budget = budget * 9 // 10


def _streamed(case, setup_hook=None):
    air, _layout, const_np, cm1, publics = case
    budget = _streaming_budget(air)
    setup = prover.Setup.build(air, const_np, device="cpu", hbm_bytes=budget)
    assert not setup.const_ext.is_cuda and setup.hbm_bytes == budget
    if setup_hook is not None:
        setup = setup_hook(setup, budget)
    stats = {}
    proof = prover.gen_proof(setup, cm1, publics, stats=stats)
    assert stats["stream"] and stats["windows"] >= 4 \
        and stats["round5_windows"] >= 2
    assert stats["block_cols"] % 8 == 0 and stats["block_cols"] < \
        air.cm1_width
    return air, setup, proof


@pytest.mark.parametrize("name,make", [
    ("binary_sm_n10_q4", fixtures.binary_sm_case),
    ("composite_n11_q4", fixtures.composite_case)])
def test_streamed_proof_byte_equal_to_jax_and_resident(name, make):
    case = make("xlayer_prover_tpu_torch")
    air, setup, proof = _streamed(case)
    assert proof.to_json() == fixtures.read(name)
    assert verifier.verify(air, setup.verkey, proof)
    resident = prover.Setup.build(air, case[2], device="cpu")
    assert resident.verkey == setup.verkey
    assert prover.gen_proof(resident, case[3], case[4]).to_json() == \
        proof.to_json()
    jair = make("xlayer_prover_tpu")[0]
    assert jverifier.verify(jair, setup.verkey, proof)


def test_streamed_setup_save_and_load(tmp_path):
    path = str(tmp_path / "const.npz")

    def reload(setup, budget):
        setup.save(path)
        loaded = prover.Setup.load(path, setup.air, device="cpu",
                                   hbm_bytes=budget)
        assert not loaded.const_ext.is_cuda
        assert torch.equal(loaded.const_ext, setup.const_ext)
        assert loaded.verkey == setup.verkey
        return loaded

    air, setup, proof = _streamed(
        fixtures.binary_sm_case("xlayer_prover_tpu_torch"), reload)
    assert proof.to_json() == fixtures.read("binary_sm_n10_q4")
    resident = prover.Setup.load(path, air, device="cpu")
    assert resident.hbm_bytes is None
    with np.load(path) as z:
        assert np.array_equal(z["const_ext"],
                              resident.const_ext.numpy().view(np.uint64))


@pytest.mark.slow
def test_streamed_mini_rom_proof_byte_equal_to_jax():
    """The mini-ROM composite at n_bits 13 streamed (~10 min here)."""
    air, setup, proof = _streamed(
        fixtures.zkevm_mini_case("xlayer_prover_tpu_torch"))
    assert proof.to_json() == fixtures.read("zkevm_mini_n13_q4")
    assert verifier.verify(air, setup.verkey, proof)


@pytest.mark.parametrize("on_file,planned", [
    ((), 4), ((0, 2, 3), 2), ((1, 2, 3), 1), ((0, 1, 2, 3), 1)])
def test_cascade_plans_inputs_up_to_its_last_batch_to_prove(
        tmp_path, monkeypatch, on_file, planned):
    """Batch proofs on file are read back, so the inputs are planned (one
    execution a batch before the last) only up to the last batch whose
    proof is missing."""
    calls = []
    monkeypatch.setattr(devnet, "build_devnet_inputs", lambda engine, n:
                        calls.append(n) or [f"input{k}" for k in range(n)])
    cas = cascade.DevnetCascade(state_dir=str(tmp_path),
                                out=str(tmp_path / "record.json"),
                                engine=types.SimpleNamespace(device="cpu"))
    for k in on_file:
        with open(cas.path(cascade.batch_stage(k)), "w") as f:
            f.write("{}")
    assert cas.inputs() == [f"input{k}" for k in range(planned)]
    assert cas.inputs() is cas.inputs() and calls == [planned]
