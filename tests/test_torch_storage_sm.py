"""Port parity: the Storage SM and ClimbKey SM of xlayer_prover_tpu_torch
against the JAX package's: the bundled micro-ROM, the replay of the
all-modes SMT script through it (``executor/storage_executor.py``), the
Storage + ClimbKey + PoseidonG AIR (n_bits 11) and its proof, which is
byte-equal to the JAX package's, committed as
``tests/data/storage_n11_q8.proof.json`` (the slow test proves it with the
JAX package again).  A trace with a forged OLD_ROOT register is refused.
Exact equality."""

import dataclasses

import numpy as np
import pytest

from xlayer_prover_tpu.executor import storage_executor as jstorage_executor
from xlayer_prover_tpu.executor import storage_rom as jstorage_rom
from xlayer_prover_tpu.stark import verifier as jverifier
from xlayer_prover_tpu_torch.executor import storage_executor, storage_rom
from xlayer_prover_tpu_torch.models.zkevm import climb_key_sm
from xlayer_prover_tpu_torch.stark import prover, verifier
from xlayer_prover_tpu_torch.stark.air import AirBuilder

from tests.test_storage_executor import _script as jax_script
from tests.test_torch_zkevm_air import air_ir
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

CASE = "storage_n11_q8"
PORT, JAX = "xlayer_prover_tpu_torch", "xlayer_prover_tpu"


@pytest.fixture(scope="module")
def case():
    return fixtures.storage_case(PORT)


def test_storage_rom_bundle_matches_jax():
    rom = storage_rom.StorageRom.load_default()
    jrom = jstorage_rom.StorageRom.load_default()
    assert len(rom) == len(jrom) > 0 and rom.labels == jrom.labels
    assert [dataclasses.asdict(x) for x in rom.lines] == \
        [dataclasses.asdict(x) for x in jrom.lines]


def test_replay_all_modes_matches_jax():
    """The script's SMT results equal the JAX package's (its modes those
    of tests/test_storage_executor.py), and so do the replay's rows,
    PoseidonG requests and ClimbKey requests, to the micro-ROM's end and
    padded to 2^11 rows."""
    actions = fixtures.smt_script(PORT)
    jactions, jmodes = jax_script()
    assert [a.result.mode for a in actions if a.is_set] == jmodes
    for a, ja in zip(actions, jactions, strict=True):
        assert dataclasses.asdict(a.result) == dataclasses.asdict(ja.result)
    rom = storage_rom.StorageRom.load_default()
    jrom = jstorage_rom.StorageRom.load_default()
    for n_rows in (None, 1 << 11):
        got = storage_executor.StorageExecutor(rom).execute(
            actions, n_rows=n_rows)
        want = jstorage_executor.StorageExecutor(jrom).execute(
            jactions, n_rows=n_rows)
        assert got == want
    assert len(got[1]) > 0 and len(got[2]) > 0


def test_storage_air_matches_jax(case):
    air, (sl, cl, pl), const_np, cm1, _ = case
    jair, (jsl, jcl, jpl), jconst, jcm1, _ = fixtures.storage_case(JAX)
    groups = {"storage": (sl, jsl), "climb_key": (cl, jcl),
              "poseidon": (pl, jpl)}
    ir = air_ir(air, {k: v[0] for k, v in groups.items()})
    jir = air_ir(jair, {k: v[1] for k, v in groups.items()})
    for key in ir:
        assert ir[key] == jir[key], key
    assert np.array_equal(const_np, jconst)
    assert np.array_equal(cm1, jcm1)


def test_storage_proof_byte_equal_and_verifies(case):
    air, _layout, const_np, cm1, _ = case
    jair, *_ = fixtures.storage_case(JAX)
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1, [])
    assert proof.to_json() == fixtures.read(CASE)
    assert jverifier.verify(jair, setup.verkey, proof)
    assert verifier.verify(air, setup.verkey, proof)


def test_storage_tampered_root_refused(case):
    """OLD_ROOT0 forged on its first nonzero row breaks the setter
    constraints: the verifier refuses the proof."""
    air, (sl, _cl, _pl), const_np, cm1, _ = case
    bad = cm1.copy()
    col = sl.witness["OLD_ROOT0"].index
    row = int(np.nonzero(bad[:, col])[0][0])
    bad[row, col] = (int(bad[row, col]) + 1) % prover.P
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, bad, [])
    with pytest.raises(verifier.VerifyError):
        verifier.verify(air, setup.verkey, proof)


def test_climb_key_refuses_overflow():
    """The ClimbKey expander refuses an input above PRE_CLIMB_UP_LIMIT."""
    b = AirBuilder("ck", 6, n_queries=4)
    cl = climb_key_sm.build(b, 6)
    air = b.compile()
    cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
    with pytest.raises(AssertionError):
        climb_key_sm.expand_into(cl, [((climb_key_sm.LIMIT + 1, 0, 0, 0),
                                       0, 1)], cm1)


@pytest.mark.slow
def test_storage_fixture_is_the_jax_proof():
    assert fixtures.jax_proof(CASE) == fixtures.read(CASE)
