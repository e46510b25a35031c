"""Port parity: the Keccak-F and SHA-256-F chains (ops/keccak, the gate
framework, the two gate scripts, the gate SM, the two padding SMs and the
two chain SMs) against the JAX package's modules on seeded numpy inputs.
Exact equality.  The state machines are built alone on a fresh
AirBuilder at n_bits 18, the smallest domain that holds a gate slot."""

import functools
import zlib

import numpy as np
import pytest
import torch

from xlayer_prover_tpu.models.zkevm import gate_sm as jgate_sm
from xlayer_prover_tpu.models.zkevm import gates as jgates
from xlayer_prover_tpu.models.zkevm import keccak_chain_sm as jkeccak_chain
from xlayer_prover_tpu.models.zkevm import keccak_gates as jkeccak_gates
from xlayer_prover_tpu.models.zkevm import padding_kk as jpadding_kk
from xlayer_prover_tpu.models.zkevm import padding_kk_sm as jpadding_kk_sm
from xlayer_prover_tpu.models.zkevm import padding_sha_sm as jpadding_sha_sm
from xlayer_prover_tpu.models.zkevm import sha256_gates as jsha256_gates
from xlayer_prover_tpu.models.zkevm import sha_chain_sm as jsha_chain
from xlayer_prover_tpu.ops import keccak as jkeccak
from xlayer_prover_tpu.stark.air import AirBuilder as JAirBuilder
from xlayer_prover_tpu_torch import device as dev
from xlayer_prover_tpu_torch.models.zkevm import (gate_sm, gates,
                                                  keccak_chain_sm,
                                                  keccak_gates, padding_kk,
                                                  padding_kk_sm,
                                                  padding_sha_sm,
                                                  sha256_gates, sha_chain_sm)
from xlayer_prover_tpu_torch.models.zkevm.padding_bytes import \
    ByteStreamInput
from xlayer_prover_tpu_torch.ops import keccak
from xlayer_prover_tpu_torch.stark.air import AirBuilder
from xlayer_prover_tpu_torch.utils import keccak as ukeccak

from tests.test_torch_zkevm_air import air_ir
from tests.torch_cpu import one_torch_thread  # noqa: F401

N_BITS = 18
SCRIPTS = {"keccak": (keccak_gates, jkeccak_gates),
           "sha": (sha256_gates, jsha256_gates)}
STREAM_LENS = [0, 135, 136, 137, 409]


def _rng(tag):
    """A numpy generator seeded from `tag`."""
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _u64(rng, shape):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) \
        * np.uint64(2) + rng.integers(0, 2, size=shape, dtype=np.uint64)


# ---------------------------------------------------------------------------
# ops/keccak
# ---------------------------------------------------------------------------

def _states(rng, batch):
    """`batch` seeded (batch, 25) states, then all zero and all ones."""
    return np.concatenate([_u64(rng, (batch, 25)),
                           np.zeros((1, 25), dtype=np.uint64),
                           np.full((1, 25), (1 << 64) - 1, dtype=np.uint64)])


def test_keccak_tables_match_jax():
    assert keccak.round_constants() == jkeccak.round_constants()
    assert keccak.rotation_offsets() == jkeccak.rotation_offsets()


def test_host_keccak_f_matches_jax():
    for st in _states(_rng("host_keccak_f"), 6):
        lanes = [int(v) for v in st]
        assert keccak._host_keccak_f(lanes) == jkeccak._host_keccak_f(lanes)


@pytest.mark.parametrize("length", [0, 1, 55, 135, 136, 137, 272, 500])
def test_keccak256_matches_jax(length):
    data = _rng(f"keccak256{length}").integers(
        0, 256, size=length, dtype=np.uint8).tobytes()
    assert keccak.keccak256(data) == jkeccak.keccak256(data)
    assert ukeccak.keccak256 is keccak.keccak256


@pytest.mark.parametrize("batch", [1, 5, 33])
def test_keccak_f_matches_jax(batch):
    """The batched torch permutation on int64 lanes against the JAX
    package's keccak_f on u32 lo/hi halves and against _host_keccak_f,
    edge states (all zero, all ones) included."""
    states = _states(_rng(f"keccak_f{batch}"), batch)
    out = dev.to_u64_np(keccak.keccak_f(dev.from_u64_np(states, "cpu")))
    lo, hi = jkeccak.keccak_f(((states & np.uint64(0xFFFFFFFF))
                               .astype(np.uint32),
                               (states >> np.uint64(32)).astype(np.uint32)))
    jout = np.asarray(lo).astype(np.uint64) \
        | (np.asarray(hi).astype(np.uint64) << np.uint64(32))
    assert np.array_equal(out, jout)
    host = [jkeccak._host_keccak_f([int(v) for v in s]) for s in states]
    assert out.tolist() == host


# ---------------------------------------------------------------------------
# gates, keccak_gates, sha256_gates
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scripts(name):
    port, jax_mod = SCRIPTS[name]
    return port.build_script(), jax_mod.build_script()


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_levelize_matches_jax(name):
    script, jscript = _scripts(name)
    assert (script.n_inputs, script.n_wires) == \
        (jscript.n_inputs, jscript.n_wires)
    assert script.gates == jscript.gates
    assert np.array_equal(script.outputs, jscript.outputs)
    assert len(script.levels) == len(jscript.levels)
    for lv, jlv in zip(script.levels, jscript.levels):
        for a, b in zip(lv, jlv):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name,pack_bits", [("keccak", 48), ("keccak", 1),
                                            ("sha", 48), ("sha", 44)])
def test_execute_all_wires_np_matches_jax(name, pack_bits):
    script, jscript = _scripts(name)
    rng = _rng(f"wires{name}{pack_bits}")
    inp = rng.integers(0, 1 << pack_bits, size=script.n_inputs,
                       dtype=np.uint64)
    assert np.array_equal(gates.execute_all_wires_np(script, inp, pack_bits),
                          jgates.execute_all_wires_np(jscript, inp,
                                                      pack_bits))


def test_pack_rows_matches_jax():
    for name in SCRIPTS:
        script, jscript = _scripts(name)
        for a, b in zip(gates._pack_rows(script), jgates._pack_rows(jscript)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name,lanes", [("keccak", 1), ("keccak", 2),
                                        ("keccak", 3), ("sha", 1),
                                        ("sha", 2)])
def test_execute_matches_jax(name, lanes):
    """The port's gates.execute (one gather, select and scatter a packed
    row, on the CPU) against the JAX package's lax.scan, at a few lane
    counts."""
    script, jscript = _scripts(name)
    inp = _rng(f"execute{name}{lanes}").integers(
        0, 1 << 32, size=(script.n_inputs, lanes), dtype=np.uint64)
    out = gates.execute(script, inp, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.int64
    jout = np.asarray(jgates.execute(jscript, inp.astype(np.uint32)))
    assert np.array_equal(out.numpy(), jout.astype(np.int64))


def test_execute_takes_a_tensor_on_its_device():
    script, _ = _scripts("sha")
    inp = _rng("execute_tensor").integers(0, 1 << 32, size=(768, 2),
                                          dtype=np.int64)
    out = gates.execute(script, torch.from_numpy(inp))
    assert np.array_equal(out.numpy(),
                          gates.execute(script, inp, device="cpu").numpy())


def test_keccak_script_is_the_permutation():
    """The Keccak script over 48 packed states, on the host and through
    gates.execute, gives _host_keccak_f of each state."""
    script, _ = _scripts("keccak")
    states = _states(_rng("script_perm"), 46)
    want = np.array([keccak._host_keccak_f([int(v) for v in s])
                     for s in states], dtype=np.uint64)
    packed = keccak_gates.pack_states(states)
    out = gates.execute(script, packed, device="cpu").numpy()
    assert np.array_equal(keccak_gates.unpack_states(out, 48), want)
    # the 48-bit host packing of the chain's gate slot
    bits = keccak_chain_sm.slot_input(states, 0)
    assert np.array_equal(keccak_gates.unpack_states(
        bits[:, None] >> np.arange(0, 64, 32, dtype=np.uint64)
        & np.uint64(0xFFFFFFFF), 48), states)
    wires = gates.execute_all_wires_np(script, bits, 48)[script.outputs]
    assert np.array_equal(wires & np.uint64(0xFFFFFFFF),
                          out[:, 0].astype(np.uint64))
    # word 1's bits 16..31 are instances 48..63, all-zero states
    assert np.array_equal(wires >> np.uint64(32),
                          out[:, 1].astype(np.uint64) & np.uint64(0xFFFF))


def test_pack_states_matches_jax():
    states = _states(_rng("pack_states"), 38)
    packed = keccak_gates.pack_states(states)
    assert np.array_equal(packed, jkeccak_gates.pack_states(states))
    assert np.array_equal(keccak_gates.unpack_states(packed, 40),
                          jkeccak_gates.unpack_states(packed, 40))
    assert np.array_equal(keccak_gates.unpack_states(packed, 40), states)


def test_pack_inputs_matches_jax():
    rng = _rng("pack_inputs")
    st = rng.integers(0, 1 << 32, size=(35, 8), dtype=np.uint64)
    blk = rng.integers(0, 1 << 32, size=(35, 16), dtype=np.uint64)
    st[-1], blk[-1] = 0xFFFFFFFF, 0xFFFFFFFF
    packed = sha256_gates.pack_inputs(st, blk)
    assert np.array_equal(packed, jsha256_gates.pack_inputs(st, blk))
    assert np.array_equal(sha256_gates.unpack_outputs(packed, 35),
                          jsha256_gates.unpack_outputs(packed, 35))
    assert np.array_equal(sha256_gates.unpack_outputs(packed, 35), st)
    assert sha256_gates.K == jsha256_gates.K
    assert sha256_gates.IV == jsha256_gates.IV


def test_sha_compress_matches_jax():
    rng = _rng("compress")
    for _ in range(4):
        st = [int(v) for v in rng.integers(0, 1 << 32, size=8)]
        words = [int(v) for v in rng.integers(0, 1 << 32, size=16)]
        assert sha_chain_sm._compress_host(st, words) == \
            jsha_chain._compress_host(st, words)


# ---------------------------------------------------------------------------
# padding_kk
# ---------------------------------------------------------------------------

def _data(length, tag="data"):
    return _rng(f"{tag}{length}").integers(0, 256, size=length,
                                           dtype=np.uint8).tobytes()


@pytest.mark.parametrize("length", STREAM_LENS)
def test_pad_stream_matches_jax(length):
    data = _data(length)
    assert padding_kk.pad_stream(data) == jpadding_kk.pad_stream(data)


def test_expand_and_digests_match_jax():
    """expand over the empty, 135-, 136-, 137-byte and a multi-block
    stream; run_instances (the port's on the CPU) and the digests equal
    the JAX package's and keccak256."""
    streams = [_data(n) for n in STREAM_LENS]
    padded, states = padding_kk.expand(streams)
    jpadded, jstates = jpadding_kk.expand(streams)
    assert np.array_equal(states, jstates)
    assert [(p.data, p.blocks, p.instance_ids, p.digest) for p in padded] \
        == [(p.data, p.blocks, p.instance_ids, p.digest) for p in jpadded]
    outs = padding_kk.run_instances(states, device="cpu")
    assert np.array_equal(outs, jpadding_kk.run_instances(jstates))
    digests = padding_kk.digests_from_outputs(padded, outs)
    assert digests == jpadding_kk.digests_from_outputs(jpadded, outs)
    assert digests == [keccak.keccak256(d) for d in streams]
    assert np.array_equal(padding_kk.run_instances(states[:0], "cpu"),
                          np.zeros((0, 25), dtype=np.uint64))


# ---------------------------------------------------------------------------
# the state machines at n_bits 18
# ---------------------------------------------------------------------------

def _streams(tag, lengths, base=7):
    """Seeded hash streams at contiguous addresses, each read in seeded
    chunks of 1..32 bytes."""
    rng = _rng(tag)
    out = []
    for k, n in enumerate(lengths):
        data = _data(n, tag)
        reads, left = [], n
        while left:
            reads.append(min(left, int(rng.integers(1, 33))))
            left -= reads[-1]
        out.append(ByteStreamInput(addr=base + k, data=data, reads=reads,
                                   len_called=bool(k % 2),
                                   digest_called=True))
    return out


KK_STREAMS = _streams("hashK", [40, 0, 135, 136, 137, 409, 1000])
SHA_STREAMS = _streams("hashS", [0, 55, 56, 64, 100, 300])


def _jax_inputs(streams):
    return [jpadding_kk_sm.PaddingKKInput(
        addr=s.addr, data=s.data, reads=list(s.reads),
        len_called=s.len_called, digest_called=s.digest_called)
        for s in streams]


def _gate_alone(pkg, b):
    """The gate SM alone over the Keccak script, 16 instances a slot in
    two 8-bit chunks (the chains pack 48 in six): one seeded slot."""
    script = (keccak_gates if pkg == "port" else jkeccak_gates).build_script()
    mod = gate_sm if pkg == "port" else jgate_sm
    layout = mod.build(b, script, N_BITS, pack_bits=16, chunk_bits=8)
    slot = _rng("gate_slot").integers(0, 1 << 16, size=1600, dtype=np.uint64)
    return layout, {"layout": layout}, \
        lambda cm1, _streams: mod.expand_into(layout, [slot], cm1)


def _padding(port_mod, jax_mod):
    def make(pkg, b):
        mod = port_mod if pkg == "port" else jax_mod
        layout = mod.build(b, N_BITS, n_blocks=48)
        return layout, {"layout": layout}, \
            lambda cm1, streams: mod.expand_into(layout, streams, cm1)
    return make


def _chain(port_mod, jax_mod):
    def make(pkg, b):
        mod = port_mod if pkg == "port" else jax_mod
        layout = mod.build(b, N_BITS)
        assert (layout.n_slots, layout.n_instances) == (1, 48)
        pad = layout.kk if hasattr(layout, "kk") else layout.ps
        return layout, {"layout": layout, "pad": pad, "gate": layout.gate}, \
            lambda cm1, streams: mod.expand_into(layout, streams, cm1)
    return make


# name -> (port module, JAX module, builder, the hash streams it expands)
SMS = {
    "gate_sm": (gate_sm, jgate_sm, _gate_alone, None),
    "padding_kk_sm": (padding_kk_sm, jpadding_kk_sm,
                      _padding(padding_kk_sm, jpadding_kk_sm), KK_STREAMS),
    "keccak_chain_sm": (keccak_chain_sm, jkeccak_chain,
                        _chain(keccak_chain_sm, jkeccak_chain), KK_STREAMS),
    "padding_sha_sm": (padding_sha_sm, jpadding_sha_sm,
                       _padding(padding_sha_sm, jpadding_sha_sm),
                       SHA_STREAMS),
    "sha_chain_sm": (sha_chain_sm, jsha_chain,
                     _chain(sha_chain_sm, jsha_chain), SHA_STREAMS),
}


@functools.lru_cache(maxsize=1)
def _sm(name):
    """{"ir", "fixed", "expand", "expand_empty"} -> (port's, JAX's) of
    state machine `name` built alone at n_bits 18: the IR, the fixed
    columns, and cm1 with expand_into's return over the seeded streams
    and over none."""
    port_mod, jax_mod, make, streams = SMS[name]
    out = {}
    for pkg, builder in (("port", AirBuilder), ("jax", JAirBuilder)):
        b = builder(name, N_BITS, n_queries=4, fri_fold_bits=3)
        layout, groups, expand = make(pkg, b)
        air = b.compile()
        mod = port_mod if pkg == "port" else jax_mod
        const_np = np.zeros((air.n, air.const_width), dtype=np.uint64)
        mod.fill_fixed(layout, const_np)
        got = {"ir": air_ir(air, groups), "fixed": const_np}
        for part, inputs in (("expand", streams), ("expand_empty", [])):
            if inputs is not None and pkg == "jax":
                inputs = _jax_inputs(inputs)
            cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
            got[part] = (cm1, expand(cm1, inputs))
        for part, value in got.items():
            out.setdefault(part, []).append(value)
    return out


SM_PARTS = [(name, part) for name in SMS
            for part in ("ir", "fixed", "expand", "expand_empty")
            if not (name == "gate_sm" and part == "expand_empty")]


@pytest.mark.parametrize("name,part", SM_PARTS,
                         ids=[f"{n}-{p}" for n, p in SM_PARTS])
def test_state_machine_matches_jax(name, part):
    port, jax_ = _sm(name)[part]
    if part == "ir":
        for key in port:
            assert port[key] == jax_[key], key
    elif part == "fixed":
        assert np.array_equal(port, jax_)
    else:
        (cm1, ret), (jcm1, jret) = port, jax_
        assert cm1.any() and np.array_equal(cm1, jcm1)
        if name == "gate_sm":
            assert len(ret) == len(jret) == 1
            assert np.array_equal(ret[0], jret[0])
        else:
            assert ret == jret


def test_slot_states_are_the_packed_gate_inputs():
    """keccak_chain_sm.slot_states gives the states that expand_into
    packs into the Keccak gate slot (the states the card's gates.execute
    check runs on)."""
    b = AirBuilder("kk", N_BITS, n_queries=4, fri_fold_bits=3)
    layout = padding_kk_sm.build(b, N_BITS, n_blocks=48)
    air = b.compile()
    cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
    instances = padding_kk_sm.expand_into(layout, KK_STREAMS, cm1)
    s_in = keccak_chain_sm.replay(instances)[0]
    states = keccak_chain_sm.slot_states(KK_STREAMS, 48)
    assert np.array_equal(states, s_in)
    want = [keccak._host_keccak_f([int(v) for v in s]) for s in states]
    assert np.array_equal(keccak_chain_sm.replay(instances)[1],
                          np.array(want, dtype=np.uint64))
