"""Port parity: the executor of xlayer_prover_tpu_torch (Main SM interpreter
+ every secondary-SM expander of the composite AIR) against the JAX
package's, and the port's host Keccak-256 and Poseidon byte hash against
the JAX package's native ones.  Exact equality throughout.

Two programs run through both ``Executor.execute``: the mini-ROM at the
geometry of the JAX package's zkEVM proof test (n_bits 13), and a wider
program at n_bits 12 that also drives the MemAlign, ArithEC and PaddingPG
expanders and the hashK/hashS/hashP digests (the mini-ROM reaches none of
them)."""

import dataclasses
import hashlib

import numpy as np
import pytest

from xlayer_prover_tpu import native
from xlayer_prover_tpu.executor.executor import Executor as JExecutor
from xlayer_prover_tpu.executor.rom import Rom as JRom
from xlayer_prover_tpu.state.hashdb import HashDB
from xlayer_prover_tpu_torch.executor.executor import Executor
from xlayer_prover_tpu_torch.executor.rom import Rom
from xlayer_prover_tpu_torch.models.zkevm.mem_align_sm import (MemAlignAction,
                                                               apply_action)
from xlayer_prover_tpu_torch.models.zkevm.mini_rom import mini_rom
from xlayer_prover_tpu_torch.models.zkevm.padding_pg_sm import \
    linear_hash_bytes
from xlayer_prover_tpu_torch.utils.keccak import keccak256

from tests.test_arith_ec import BN_P, GX, GY, ec_add, ec_double
from tests.test_zkevm_proof import mini_rom as jmini_rom
from tests.torch_cpu import one_torch_thread  # noqa: F401

# ---------------------------------------------------------------------------
# host hashes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 1, 55, 135, 136, 137, 271, 272, 273])
def test_keccak256_rate_edges_match_native(length):
    data = np.random.default_rng(length).integers(
        0, 256, size=length, dtype=np.uint8).tobytes()
    assert keccak256(data) == native.keccak256(data)


def test_keccak256_lengths_0_to_300_match_native():
    rng = np.random.default_rng(20261016)
    for length in range(301):
        data = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
        assert keccak256(data) == native.keccak256(data), length
    # Keccak-256 is not SHA3-256 (the padding differs)
    assert keccak256(b"") != hashlib.sha3_256(b"").digest()
    assert keccak256(b"").hex().startswith("c5d2460186f7233c")


@pytest.mark.parametrize("length", [0, 1, 55, 56, 57, 200])
def test_poseidon_byte_hash_matches_native(length):
    data = bytes(range(length % 256)) * (length // 256) \
        + bytes(range(length % 256))
    assert tuple(linear_hash_bytes(data)) == \
        tuple(native.poseidon_linear_hash_bytes(data))


# ---------------------------------------------------------------------------
# executor parity
# ---------------------------------------------------------------------------

M0 = int.from_bytes(bytes(range(32)), "big")
M1 = int.from_bytes(bytes(range(32, 64)), "big")
VAL = int.from_bytes(bytes(range(100, 132)), "big")
OFF = 5


def wide_program():
    """memAlignRD/WR/WR8, EC double/add, BN254 Fp2 mul/sub, and one hash
    stream per family (Len + Digest) as rom.json."""
    prog = []
    labels = {}

    def line(**kw):
        prog.append(kw)
        return len(prog) - 1

    rd_v, _, _ = apply_action(MemAlignAction("RD", M0, M1, OFF, 0))
    _, wr_w0, wr_w1 = apply_action(MemAlignAction("WR", M0, M1, OFF, VAL))
    _, w8_w0, _ = apply_action(MemAlignAction("WR8", M0, M1, 9, 0xAB))
    labels["start"] = line(CONSTL=M0, setA=1)
    line(CONSTL=M1, setB=1)
    line(CONSTL=OFF, setC=1)
    line(CONSTL=rd_v, memAlignRD=1, setD=1)
    line(CONSTL=wr_w0, setD=1)
    line(CONSTL=wr_w1, setE=1)
    line(CONSTL=VAL, memAlignWR=1)
    line(CONSTL=9, setC=1)
    line(CONSTL=w8_w0, setD=1)
    line(CONSTL=0xAB, memAlignWR8=1)

    d2 = ec_double(GX, GY)
    d3 = ec_add(GX, GY, *d2)
    line(CONSTL=GX, setA=1)
    line(CONSTL=GY, setB=1)
    line(CONSTL=d2[0], setE=1)
    line(CONSTL=d2[1], arithEq2=1)
    line(CONSTL=d2[0], setC=1)
    line(CONSTL=d2[1], setD=1)
    line(CONSTL=d3[0], setE=1)
    line(CONSTL=d3[1], arithEq1=1)
    line(CONSTL=3, setA=1)
    line(CONSTL=4, setB=1)
    line(CONSTL=5, setC=1)
    line(CONSTL=6, setD=1)
    line(CONSTL=(3 * 5 - 4 * 6) % BN_P, setE=1)
    line(CONSTL=(4 * 5 + 3 * 6) % BN_P, arithEq3=1)
    line(CONSTL=(3 - 5) % BN_P, setE=1)
    line(CONSTL=(4 - 6) % BN_P, arithEq5=1)

    line(CONST=0, setHASHPOS=1)
    line(CONST=2, setD=1)
    line(CONSTL=0x0102, hashK=1, offset=7)
    line(CONSTL=0x03, hashK1=1, offset=7)
    line(CONSTL=3, hashKLen=1, offset=7)
    line(freeInTag={}, inFREE=1, hashKDigest=1, offset=7, setA=1)
    line(CONST=0, setHASHPOS=1)
    line(CONSTL=0xBEEF, hashS=1, offset=9)
    line(CONSTL=2, hashSLen=1, offset=9)
    line(freeInTag={}, inFREE=1, hashSDigest=1, offset=9, setB=1)
    line(CONST=0, setHASHPOS=1)
    line(CONST=4, setD=1)
    line(CONSTL=0xDEADBEEF, hashP=1, offset=11)
    line(CONSTL=4, hashPLen=1, offset=11)
    line(freeInTag={}, inFREE=1, hashPDigest=1, offset=11, setC=1)
    labels["finalizeExecution"] = len(prog)
    line()
    return {"program": prog, "labels": labels, "constants": {}}


def _required(req):
    """Required -> plain values (ByteStreamInput dataclasses as dicts)."""
    out = {}
    for f in dataclasses.fields(req):
        out[f.name] = [dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                       else v for v in getattr(req, f.name)]
    return out


def _execute_both(rom, jrom, **geometry):
    res = Executor(rom, **geometry).execute()
    jres = JExecutor(jrom, **geometry).execute(HashDB())
    assert dataclasses.asdict(res.ctx.counters) == \
        dataclasses.asdict(jres.ctx.counters)
    assert _required(res.ctx.required) == _required(jres.ctx.required)
    assert res.publics == jres.publics
    assert np.array_equal(res.const_np, jres.const_np)
    assert np.array_equal(res.cm1_np, jres.cm1_np)
    return res


def test_mini_rom_is_the_jax_tests_program():
    rom, jrom = mini_rom(), jmini_rom()
    assert rom.labels == jrom.labels
    assert [dataclasses.asdict(ln) for ln in rom.program] == \
        [dataclasses.asdict(ln) for ln in jrom.program]


def test_mini_rom_execution_matches_jax():
    res = _execute_both(mini_rom(), jmini_rom(), n_bits=13, chunk_bits=2,
                        limb_bits=8, n_queries=4, max_steps=1 << 12)
    ctx = res.ctx
    assert ctx.done and ctx.counters.steps == 24
    assert (ctx.counters.binary, ctx.counters.arith) == (3, 1)
    assert len(ctx.required.memory) == 2


def test_wide_program_execution_matches_jax():
    prog = wide_program()
    res = _execute_both(Rom.from_json(prog), JRom.from_json(prog),
                        n_bits=12, chunk_bits=2, limb_bits=8, n_queries=4,
                        max_steps=1 << 10)
    req = res.ctx.required
    assert [a[0] for a in req.mem_align] == ["RD", "WR", "WR8"]
    assert sorted(a[0] for a in req.arith) == [1, 2, 3, 5]
    assert [len(r) for r in (req.padding_kk, req.padding_sha,
                             req.padding_pg)] == [1, 1, 1]
    assert res.ctx.counters.padding_pg == 1


def _one_line_rom(labels_at_start=(), **kw):
    prog = [dict(kw), {}]
    labels = {"start": 0, "finalizeExecution": 1}
    labels.update({name: 0 for name in labels_at_start})
    return {"program": prog, "labels": labels, "constants": {}}


@pytest.mark.parametrize("rom_kw,n_storage", [
    ({"freeInTag": {}, "inFREE": 1, "sRD": 1, "setA": 1}, 1),
    ({"inA": 1, "sWR": 1}, 1),
    ({"labels_at_start": ("ecrecover_store_args",), "setA": 1}, 0),
], ids=["sRD", "sWR", "ecrecover"])
def test_unported_operations_raise(rom_kw, n_storage):
    """The operations the port once lacked (an sRD, an sWR on the empty
    state, the ECRecover precalc hook) raise no NotImplementedError now:
    each one-line program runs as in the JAX package, storage actions
    included."""
    prog = _one_line_rom(**rom_kw)
    res = _execute_both(Rom.from_json(prog), JRom.from_json(prog),
                        n_bits=12, chunk_bits=2, limb_bits=8, n_queries=4,
                        max_steps=8)
    assert len(res.ctx.required.storage) == n_storage
