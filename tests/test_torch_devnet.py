"""Port parity: devnet batch 0 (a signed EIP-155 transfer through the
fork_9 ROM against an SMT state, the Storage and ClimbKey SMs in the
circuit) at the 2^16 geometry through both packages' ``BatchProver``.
The port's input, its committed trace (519 columns), constant columns
and publics equal the JAX package's, the post-state holds the transfer,
and the composite AIR with the storage ROM equals the JAX package's.  The
slow test proves the batch with the port on the CPU: the proof is
byte-equal to the committed ``a7_state_devnet/batch_proof_0vdev0_nb16_q4
.json`` and verifies.  Exact equality."""

import dataclasses

import numpy as np
import pytest

from xlayer_prover_tpu.executor import ec_precalc as jec_precalc
from xlayer_prover_tpu.executor import rom as jrom
from xlayer_prover_tpu.executor import rom_functions as jrom_functions
from xlayer_prover_tpu.stark import verifier as jverifier
from xlayer_prover_tpu_torch.executor import ec_precalc, rom, rom_functions
from xlayer_prover_tpu_torch.executor.input import BatchInput
from xlayer_prover_tpu_torch.state.keys import balance_key, nonce_key
from xlayer_prover_tpu_torch.state.smt import Smt
from xlayer_prover_tpu_torch.stark import prover, verifier
from xlayer_prover_tpu_torch.utils import devnet

from tests.test_torch_zkevm_air import _ir
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

CASE = "devnet_batch0_n16_q4"
PORT, JAX = "xlayer_prover_tpu_torch", "xlayer_prover_tpu"
GAS_PRICE, VALUE = 10 ** 9, 1000


@pytest.fixture(scope="module")
def engines():
    return (fixtures.devnet_prover(PORT),
            fixtures.devnet_prover(JAX))


@pytest.fixture(scope="module")
def runs(engines):
    engine, jengine = engines
    inp = devnet.build_devnet_inputs(engine, 1)[0]
    return (engine.execute_only(inp, batch_uuid="devnet"),
            jengine.execute_only(fixtures.devnet_input(JAX),
                                 batch_uuid="devnet"))


def test_fork9_rom_bundle_matches_jax():
    r, jr = rom.Rom.load_fork(9), jrom.Rom.load_fork(9)
    assert len(r) == len(jr) == 13268 and r.labels == jr.labels
    assert [dataclasses.astuple(x) for x in r.program] == \
        [dataclasses.astuple(x) for x in jr.program]
    assert set(rom_functions.FUNCTIONS) == set(jrom_functions.FUNCTIONS)


@pytest.mark.parametrize("seed", [5, 6])
def test_ec_precalc_matches_jax(seed):
    """The ECRecover ladder memo of seeded signatures equals the JAX
    package's, and each memo entry is the direct affine math."""
    rng = np.random.default_rng(seed)
    priv = int.from_bytes(rng.bytes(32), "big") % ec_precalc.N
    digest = rng.bytes(32)
    r, s, parity = devnet._sign(digest, priv,
                                int.from_bytes(rng.bytes(32), "big"))
    z = int.from_bytes(digest, "big")
    memo = ec_precalc.precalc(z, r, s, 27 + parity)
    assert memo and memo == jec_precalc.precalc(z, r, s, 27 + parity)
    for k, (x3, y3) in list(memo.items())[:20]:
        direct = rom_functions._ec_dbl(*k[1:]) if k[0] == "dbl" else \
            rom_functions._ec_add(*k[1:])
        assert direct == (x3, y3)
    assert ec_precalc.precalc(z, 0, s, 27) is None


def test_devnet_input_matches_jax(engines):
    engine, _ = engines
    inp = devnet.build_devnet_inputs(engine, 1)[0]
    want = fixtures.devnet_input(JAX)
    assert dataclasses.asdict(inp) == dataclasses.asdict(want)
    assert dataclasses.asdict(inp) == \
        dataclasses.asdict(fixtures.devnet_input(PORT))
    j = {"oldStateRoot": hex(inp.old_state_root), "chainID": 1001,
         "batchL2Data": "0x" + inp.batch_l2_data.hex(), "forkID": 9,
         "sequencerAddr": hex(inp.sequencer_addr), "timestampLimit": 200}
    assert BatchInput.from_json(j).input_vars() == inp.input_vars()


def test_devnet_trace_matches_jax(runs):
    res, jres = runs
    assert res.ctx.counters.steps == jres.ctx.counters.steps == 6589
    assert len(res.ctx.required.storage) == \
        len(jres.ctx.required.storage) > 0
    assert res.ctx.ec_memo_hits == jres.ctx.ec_memo_hits > 0
    assert res.cm1_np.shape == (1 << 16, 519)
    assert np.array_equal(res.cm1_np, jres.cm1_np)
    assert np.array_equal(res.const_np, jres.const_np)
    assert [int(p) for p in res.publics] == [int(p) for p in jres.publics]


def test_devnet_state_transition(runs):
    """The transfer moved 1000 wei, charged 21000 gas to the sender,
    credited the coinbase (the receiver) and bumped the nonce."""
    res, _ = runs
    new_root = 0
    for i, limb in enumerate(res.ctx.regs.SR):
        new_root |= int(limb) << (32 * i)
    root4 = tuple((new_root >> (64 * i)) & ((1 << 64) - 1)
                  for i in range(4))
    smt = Smt(res.ctx.hashdb.batches["devnet"])
    a1 = devnet.address_of(devnet.DEVNET_PRIV1)
    a2 = devnet.address_of(devnet.DEVNET_PRIV2)
    gas_cost = 21000 * GAS_PRICE
    assert smt.get(root4, balance_key(a1)).value == \
        10 ** 18 - VALUE - gas_cost
    assert smt.get(root4, balance_key(a2)).value == 5 + VALUE + gas_cost
    assert smt.get(root4, nonce_key(a1)).value == 1


def test_devnet_air_matches_jax(engines):
    engine, jengine = engines
    ir, jir = _ir(engine.air, engine.executor.layout), \
        _ir(jengine.air, jengine.executor.layout)
    for key in ir:
        assert ir[key] == jir[key], key
    assert ir["widths"] == (216, 519, 384, 483)


@pytest.mark.slow
def test_devnet_proof_byte_equal_and_verifies(engines, runs):
    engine, jengine = engines
    res, _ = runs
    proof = engine.prove_from_trace(res.cm1_np, res.publics)
    assert proof.to_json() == fixtures.read(CASE)
    assert verifier.verify(engine.air, engine.setup().verkey, proof)
    assert jverifier.verify(jengine.air, engine.setup().verkey, proof)


@pytest.mark.slow
def test_devnet_fixture_is_the_jax_proof():
    assert fixtures.jax_proof(CASE) == fixtures.read(CASE)
