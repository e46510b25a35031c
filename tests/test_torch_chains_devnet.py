"""Port parity: the whole zkEVM composite at 2^18 with the Keccak-F and
SHA-256-F chains (the fork_9 ROM with the storage ROM, at the devnet
chains geometry ``utils/devnet.DEVNET_CHAINS_GEOMETRY``): the IR equals
the JAX package's, and the port's devnet batch 0 (``build_devnet_inputs``,
as the card's phase builds it) executed on the CPU gives the const and
cm1 column digests, the executor's steps and the publics of the committed
JAX fixture ``tests/data/zkevm_devnet0_n18_chains.json``
(``tools/torch_proof_fixtures.py``).  The slow tier builds the fixture
again with the JAX package and checks the JAX proof fixture, where it was
made, with the JAX verifier."""

import functools
import json
import os

import numpy as np
import pytest

import chip_smoke
from tools import torch_proof_fixtures as fx
from xlayer_prover_tpu_torch.utils import devnet

from tests.test_torch_zkevm_air import chains_groups, chains_ir
from tests.torch_cpu import one_torch_thread  # noqa: F401

@functools.lru_cache(maxsize=1)
def _port():
    """The port's 2^18 BatchProver on the CPU and its execution of devnet
    batch 0."""
    engine = devnet.devnet_prover("cpu", devnet.DEVNET_CHAINS_GEOMETRY)
    res = engine.execute_only(devnet.build_devnet_inputs(engine, 1)[0])
    return engine, res


@functools.lru_cache(maxsize=1)
def _digests():
    """``torch_proof_fixtures.chains_digests`` of the port's execution
    (its const columns are zkevm_air.fill_fixed's, the Setup's)."""
    engine, res = _port()
    return fx.chains_digests(engine.air, res.ctx.counters.steps, res.cm1_np,
                             res.const_np, res.publics,
                             fx.read_chains()["verkey"])


GROUP_NAMES = ["main", "binary", "memory", "arith", "poseidon", "storage",
               "climb_key", "padding_pg", "keccak", "keccak.kk",
               "keccak.gate", "sha", "sha.ps", "sha.gate", "mem_align",
               "arith_ec"]
# (group, section): ClimbKey has no fixed columns of its own
DIGEST_CASES = [(g, part) for g in GROUP_NAMES for part in ("cm1", "const")
                if (g, part) != ("climb_key", "const")]


def test_air_matches_jax():
    """The IR at 2^18 with the storage ROM equals the JAX package's:
    669 / 600 / 999 / 361 columns, 100 plookups, one gate slot of 48
    instances a chain."""
    from xlayer_prover_tpu.executor.rom import Rom as JRom
    from xlayer_prover_tpu.executor.storage_rom import StorageRom as JSRom
    from xlayer_prover_tpu.models.zkevm import zkevm_air as jzkevm_air
    engine, _ = _port()
    air, layout = engine.air, engine.executor.layout
    jair, jlayout = jzkevm_air.build(
        JRom.load_fork(9), **{k: v for k, v in
                              devnet.DEVNET_CHAINS_GEOMETRY.items()
                              if k != "max_steps"},
        storage_rom=JSRom.load_default())
    ir, jir = chains_ir(air, layout), chains_ir(jair, jlayout)
    for key in ir:
        assert ir[key] == jir[key], key
    assert ir["widths"] == (361, 669, 600, 999)
    assert len(air.plookups) == 100
    for chain in (layout.keccak, layout.sha):
        assert (chain.n_slots, chain.n_instances) == (1, 48)


def test_fixture_holds_the_circuit():
    want = fx.read_chains()
    engine, res = _port()
    air = engine.air
    assert want["widths"] == [air.cm1_width, air.cm2_width, air.cm3_width,
                              air.const_width] == [669, 600, 999, 361]
    assert want["n_plookups"] == len(air.plookups)
    assert len(want["cm1"]) == air.cm1_width
    assert len(want["const"]) == air.const_width
    assert want["executor_steps"] == res.ctx.counters.steps == 6589


@pytest.mark.parametrize("group,part", DIGEST_CASES,
                         ids=[f"{g}-{p}" for g, p in DIGEST_CASES])
def test_column_digests_match_fixture(group, part):
    """Each state machine's fixed (const) and committed (cm1) columns of
    the port's execution have the JAX execution's digests."""
    want = fx.read_chains()[part]
    engine, _res = _port()
    layout = chains_groups(engine.executor.layout)[group]
    cols = sorted({c.index for kind in ("fixed", "witness")
                   for c in getattr(layout, kind).values()
                   if c.section == part})
    assert cols
    assert [_digests()[part][j] for j in cols] == [want[j] for j in cols]


def test_every_column_digest_matches_fixture():
    want = fx.read_chains()
    got = _digests()
    for key in want:
        assert got[key] == want[key], key


def test_publics_match_fixture():
    _engine, res = _port()
    assert [int(p) for p in res.publics] == fx.read_chains()["publics"]


def test_chains_were_fed_by_the_executor():
    """The executor's hashK streams reach the Keccak chain unchanged: each
    stream's keccak-256 sits in its PaddingKK lastHash row, and the gate
    slot's first states are the streams' first blocks absorbed into the
    zero state.  Batch 0 hashes nothing with SHA-256."""
    from xlayer_prover_tpu_torch.models.zkevm import (keccak_chain_sm,
                                                      padding_kk_sm)
    from xlayer_prover_tpu_torch.ops.keccak import keccak256
    engine, res = _port()
    streams = sorted(res.ctx.required.padding_kk, key=lambda s: s.addr)
    assert streams and list(res.ctx.required.padding_sha) == []
    kw = engine.executor.layout.keccak.kk.witness
    last = np.nonzero(res.cm1_np[:, kw["lastHash"].index])[0]
    for stream, row in zip(streams, last):
        scalar = int.from_bytes(keccak256(stream.data), "big")
        assert [int(res.cm1_np[row, kw[f"hash{q}"].index])
                for q in range(8)] == [(scalar >> (32 * q)) & 0xFFFFFFFF
                                       for q in range(8)]
    states = keccak_chain_sm.slot_states(streams, 48)
    first = padding_kk_sm.pad_bytes(streams[0].data)[:136]
    assert [int(v) for v in states[0][:17]] == [
        int.from_bytes(first[8 * k:8 * k + 8], "little") for k in range(17)]


def test_chip_smoke_digests_are_the_tools():
    """chip_smoke.py's copy of column_digests equals the fixture tool's."""
    rng = np.random.default_rng(20261018)
    table = rng.integers(0, 1 << 64, size=(1000, 7), dtype=np.uint64)
    table[:, 0] = 0
    table[-1] = (1 << 64) - 1
    assert chip_smoke.column_digests(table) == fx.column_digests(table)
    assert chip_smoke.CHAINS_FIXTURE == os.path.join(
        fx.DATA, f"{fx.CHAINS}.json")
    assert chip_smoke.CHAINS_PROOF == fx.path(fx.CHAINS_PROOF)


@pytest.mark.slow
def test_jax_rebuilds_the_fixture():
    """The JAX package builds the digest fixture again (its Setup at 2^18:
    minutes) and it equals the committed one."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert json.loads(fx.chains_fixture_jax()) == fx.read_chains()


@pytest.mark.slow
def test_jax_verifies_the_proof_fixture():
    """The committed JAX proof of devnet batch 0 at 2^18, where it was
    made, passes the JAX verifier under the fixture's verkey, and its
    publics are the fixture's."""
    path = fx.path(fx.CHAINS_PROOF)
    if not os.path.exists(path):
        pytest.skip("the JAX proof fixture was not made")
    from xlayer_prover_tpu.stark import verifier
    from xlayer_prover_tpu.stark.proof import StarkProof
    engine = fx.devnet_prover("xlayer_prover_tpu",
                              devnet.DEVNET_CHAINS_GEOMETRY)
    want = fx.read_chains()
    with open(path) as f:
        proof = StarkProof.from_json(f.read())
    assert [int(p) for p in proof.publics] == want["publics"]
    assert verifier.verify(engine.air, want["verkey"], proof)
