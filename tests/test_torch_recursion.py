"""Port parity: the recursion stack of xlayer_prover_tpu_torch against the
JAX package's, exact equality.  The gadgets, the traced STARK verifier
(op for op on the fib toy and on the devnet AIR, and its witness on the
committed devnet batch proof 0), the gate AIR's constant and committed
columns at the fib recursive1 geometry (2^13 rows), and the port's fib
recursive1 proof, byte-equal to the JAX package's, committed as
``tests/data/rec1_fib_n13_q4.proof.json``.  The slow tier proves that
fixture and the committed devnet recursive1 proof again with the JAX
package, and aggregates through the port's fib recursive2 at 2^16."""

import json
import os

import numpy as np
import pytest

from xlayer_prover_tpu.recursion import circuit as jcircuit
from xlayer_prover_tpu.recursion import engine as jengine
from xlayer_prover_tpu.recursion import gate_air as jgate_air
from xlayer_prover_tpu.recursion import stack as jstack
from xlayer_prover_tpu.recursion import verifier_circuit as jvc
from xlayer_prover_tpu.stark import verifier as jverifier
from xlayer_prover_tpu.stark.proof import StarkProof as JStarkProof
from xlayer_prover_tpu_torch.fields.gl3 import _host_pow3
from xlayer_prover_tpu_torch.recursion import circuit, engine, gate_air, stack
from xlayer_prover_tpu_torch.recursion import verifier_circuit as vc
from xlayer_prover_tpu_torch.stark import prover, verifier
from xlayer_prover_tpu_torch.stark.proof import StarkProof

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

P = prover.P
PORT, JAX = "xlayer_prover_tpu_torch", "xlayer_prover_tpu"
REC1_FIB = "rec1_fib_n13_q4"
A7 = os.path.join(fixtures.ROOT, "a7_state_devnet")


def canon(tracer):
    """A tracer's program as plain data: every op (gate coefficients, the
    wires of Poseidon ops and hints) with its scope, and the wire counts,
    inputs and publics."""
    ops = []
    for op, scope in zip(tracer.ops, tracer._op_scopes, strict=True):
        kind = type(op).__name__
        if kind == "Gate":
            ops.append((kind, op.a, op.b, op.c, op.qM, op.qL, op.qR, op.qO,
                        op.qC, scope))
        elif kind == "PoseidonOp":
            ops.append((kind, tuple(op.inputs), tuple(op.outputs), scope))
        else:
            ops.append((kind, tuple(op.ins), tuple(op.outs), scope))
    return (tracer.n_wires, tuple(tracer.input_wires),
            tuple(tracer.public_wires), ops)


def read_a7(name: str) -> str:
    with open(os.path.join(A7, f"{name}_nb16_q4.json")) as f:
        return f.read()


# ---------------------------------------------------------------------------
# Gadgets
# ---------------------------------------------------------------------------

def _seeded(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, P, size=n, dtype=np.uint64)]


# name -> (inputs from seeded values, gadget over the input wires, the
# outputs' plain values)
GADGETS = {
    "is_zero": (lambda r: [0, r[0]],
                lambda t, w: [t.is_zero(w[0]), t.is_zero(w[1])],
                lambda v: [1, 0]),
    "all_eq": (lambda r: [r[0], r[1], r[0], (r[1] + 1) % P],
               lambda t, w: [t.all_eq(w[:2], w[:2]),
                             t.all_eq(w[:2], w[2:])],
               lambda v: [1, 0]),
    "select": (lambda r: [1, 0, r[0], r[1]],
               lambda t, w: [t.select(w[0], w[2], w[3]),
                             t.select(w[1], w[2], w[3])],
               lambda v: [v[2], v[3]]),
    "bits": (lambda r: [r[0], r[1] >> 44],
             lambda t, w: t.bits(w[0], 64) + t.bits(w[1], 20),
             lambda v: [(v[0] >> i) & 1 for i in range(64)]
             + [(v[1] >> i) & 1 for i in range(20)]),
    "inv": (lambda r: [r[0] or 1],
            lambda t, w: [t.inv(w[0])],
            lambda v: [pow(v[0], P - 2, P)]),
    "pow_static": (lambda r: r[:3],
                   lambda t, w: list(t.pow_static(tuple(w), 1597))
                   + list(t.pow_static(tuple(w), 0)),
                   lambda v: _host_pow3(v, 1597) + [1, 0, 0]),
    "inv3": (lambda r: r[:3],
             lambda t, w: list(t.inv3(tuple(w))),
             lambda v: _host_pow3(v, P ** 3 - 2)),
    "lin": (lambda r: r[:3],
            lambda t, w: [t.lin([(5, w[0]), (1, w[1]), (P - 2, w[2])], 9)],
            lambda v: [(5 * v[0] + v[1] - 2 * v[2] + 9) % P]),
}


@pytest.mark.parametrize("name", sorted(GADGETS))
@pytest.mark.parametrize("seed", [1, 2])
def test_gadget_matches_jax(name, seed):
    make_inputs, gadget, plain = GADGETS[name]
    values = make_inputs(_seeded(4, seed))
    runs = []
    for mod in (circuit, jcircuit):
        t = mod.Tracer()
        outs = gadget(t, t.inputs(len(values)))
        for w in outs:
            t.mark_public(w)
        vals = t.run(values)
        runs.append((canon(t), vals, [vals[w] for w in outs]))
    (ir, vals, outs), (jir, jvals, _) = runs
    assert ir == jir
    assert vals == jvals
    assert outs == plain(values)


@pytest.mark.parametrize("mod", [circuit, jcircuit], ids=["port", "jax"])
def test_bits_refuses_a_wider_value(mod):
    t = mod.Tracer()
    t.bits(t.input(), 20)
    t.run([(1 << 20) - 1])
    with pytest.raises(ValueError, match="assertion gate failed"):
        t.run([1 << 20])


# ---------------------------------------------------------------------------
# The traced verifier: fib toy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fib():
    """The fib inner proof (the port's, on the CPU) and the JAX package's
    AIR and proof object for it."""
    from xlayer_prover_tpu.models.toy import fib as jfib
    air, setup, proof = fixtures.fib_inner(PORT)
    jair = jfib.build_air(n_bits=4, n_queries=2)
    return air, jair, setup.verkey, proof, \
        JStarkProof.from_json(proof.to_json())


def test_fib_verifier_circuit_matches_jax(fib):
    air, jair, verkey, proof, jproof = fib
    tracer, _pw = vc.build_verifier_circuit(air, verkey)
    jtracer, _jpw = jvc.build_verifier_circuit(jair, verkey)
    assert canon(tracer) == canon(jtracer)
    stats = tracer.stats()
    assert stats == jtracer.stats()
    assert stats["poseidons"] > 10 and stats["gates"] > 100
    flat = vc.flatten_proof(air, proof)
    assert flat == jvc.flatten_proof(jair, jproof)
    vals = tracer.run(flat)
    assert vals == jtracer.run(flat)
    # circuit publics = inner publics
    assert [vals[w] for w in tracer.public_wires] == \
        [p % P for p in proof.publics]
    bad = list(flat)
    bad[len(proof.publics) + 2] += 1      # tamper a root limb
    for t in (tracer, jtracer):
        with pytest.raises(ValueError):
            t.run(bad)


# ---------------------------------------------------------------------------
# The traced verifier: devnet batch 0 (the recursive1 circuit of the chip
# run)
# ---------------------------------------------------------------------------

def test_devnet_verifier_circuit_matches_jax():
    air = fixtures.devnet_prover(PORT).air
    jair = fixtures.devnet_prover(JAX).air
    verkey = fixtures.DEVNET_VERKEY
    tracer, _pw = engine.Recursive1.trace(air, verkey)
    jtracer, _jpw = jengine.Recursive1.trace(jair, verkey)
    assert canon(tracer) == canon(jtracer)
    assert tracer.stats()["poseidons"] == 2230
    assert gate_air.plan(tracer)["n_bits"] == 18
    text = fixtures.read("devnet_batch0_n16_q4")
    proof = StarkProof.from_json(text)
    flat = vc.flatten_proof(air, proof)
    assert flat == jvc.flatten_proof(jair, JStarkProof.from_json(text))
    vals = tracer.run(flat)
    assert vals == jtracer.run(flat)
    assert [vals[w] for w in tracer.public_wires] == \
        [0, 0, 0, 0] + proof.publics


# ---------------------------------------------------------------------------
# The gate AIR and the fib recursive1 proof at 2^13
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rec1_fib(fib):
    """The fib recursive1 case (gate AIR, layout, constant and committed
    columns, publics) built by each package over the same inner proof."""
    _air, _jair, verkey, proof, _jproof = fib
    inner = (verkey, proof.to_json())
    return fixtures.rec1_fib_case(PORT, inner), \
        fixtures.rec1_fib_case(JAX, inner)


@pytest.fixture(scope="module")
def rec1_setup(rec1_fib):
    (air, _layout, const_np, _cm1, _publics), _ = rec1_fib
    return prover.Setup.build(air, const_np, device="cpu")


def test_gate_air_fib_rec1_matches_jax(rec1_fib, rec1_setup):
    (air, layout, const_np, cm1, publics), \
        (jair, jlayout, jconst, jcm1, jpublics) = rec1_fib
    for key in ("n_pub_rows", "pos_row0", "arith_row0", "used", "n_bits"):
        assert gate_air.plan(layout.tracer)[key] == \
            jgate_air.plan(jlayout.tracer)[key], key
    assert air.n_bits == 13 and air.fri_steps == jair.fri_steps
    assert engine._shape_sig(air) == jengine._shape_sig(jair)
    assert (air.cm1_width, air.cm3_width) == (60, 39)
    assert np.array_equal(const_np, jconst)
    assert np.array_equal(cm1, jcm1)
    assert publics == jpublics
    # the verkey is the JAX package's (its Setup.build over these columns
    # gave these limbs), and the JAX package's committed proof (its
    # transcript opens with the verkey, its constant-tree openings hash up
    # to it) verifies against the port's
    assert rec1_setup.verkey == [10387500288996916894, 7098768771481568950,
                                 4245700399847880853, 8880567243123089745]
    assert jverifier.verify(jair, rec1_setup.verkey,
                            JStarkProof.from_json(fixtures.read(REC1_FIB)))


def test_rec1_fib_proof_byte_equal_and_verifies(rec1_fib, rec1_setup):
    (air, _layout, _const, cm1, publics), (jair, *_rest) = rec1_fib
    proof = prover.gen_proof(rec1_setup, cm1, publics)
    assert proof.to_json() == fixtures.read(REC1_FIB)
    assert proof.publics == [0, 0, 0, 0, 1, 1, 1597]
    assert verifier.verify(air, rec1_setup.verkey, proof)
    assert jverifier.verify(jair, rec1_setup.verkey,
                            JStarkProof.from_json(proof.to_json()))


@pytest.mark.parametrize("link, refused", [([(0, 0)], False),
                                           ([(0, 2)], True)],
                         ids=["holds", "violated"])
def test_recursive2_link_in_circuit(rec1_fib, rec1_setup, link, refused):
    """The chain rule payload1[i] == payload2[j] of the aggregation circuit
    over two fib recursive1 proofs (publics 1, 1, 1597): a violated link
    fails its assert gate at witness time, in both packages."""
    (air, *_), (jair, *_) = rec1_fib
    proof = StarkProof.from_json(fixtures.read(REC1_FIB))
    out_map = [("p1", i) for i in range(air.n_publics - 4)]
    tracer = engine.Recursive2.trace(air, rec1_setup.verkey, link, out_map)
    jtracer = jengine.Recursive2.trace(jair, rec1_setup.verkey, link,
                                       out_map)
    assert canon(tracer) == canon(jtracer)
    flat = vc.flatten_proof(air, proof)
    inputs = [0, 0, 0, 0] + flat + flat
    for t in (tracer, jtracer):
        if refused:
            with pytest.raises(ValueError, match="scope 'links'"):
                t.run(inputs)
        else:
            vals = t.run(inputs)
            assert [vals[w] for w in t.public_wires] == \
                [0, 0, 0, 0, 1, 1, 1597]


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [27, 44])
def test_zkevm_chain_spec_matches_jax(n):
    link, out_map = stack.zkevm_chain_spec(n)
    assert (link, out_map) == jstack.zkevm_chain_spec(n)
    assert link == [(19 + k, k) for k in range(8)]
    assert len(out_map) == n
    assert out_map[0] == ("p1", 0) and out_map[19] == ("p2", 19)
    assert out_map[-1] == ("p2", n - 1)


def test_zkevm_chain_spec_refuses_other_widths():
    with pytest.raises(ValueError):
        stack.zkevm_chain_spec(30)


@pytest.mark.parametrize("name", ["recursive1_0", "aggregate_01",
                                  "aggregate_root"])
def test_recursive_proof_json_round_trip(name):
    """The cascade's stage files read back to the same bytes."""
    text = read_a7(name)
    rp = stack.RecursiveProof.from_json(text)
    assert rp.level == (1 if name.startswith("recursive1") else 2)
    assert json.dumps(rp.to_json()) == text
    assert stack.RecursiveProof.from_json(json.loads(text)) == rp


def test_finalize_refuses_unknown_wrap_before_work(rec1_fib):
    """finalize refuses a wrap it does not know before any work: no
    recursive1 engine is built and no key is cached."""
    (air, *_), _ = rec1_fib
    st = stack.RecursionStack(air, [0, 0, 0, 0], device="cpu")
    with pytest.raises(ValueError, match="wrap"):
        st.finalize(None, wrap="plonk")
    assert st._rec1 is None and not st._aux


# ---------------------------------------------------------------------------
# Slow tier
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_rec1_fib_fixture_is_the_jax_proof():
    assert fixtures.jax_proof(REC1_FIB) == fixtures.read(REC1_FIB)


@pytest.mark.slow
def test_devnet_verkey_is_the_setup_root():
    engine_ = fixtures.devnet_prover(PORT)
    assert engine_.setup().verkey == fixtures.DEVNET_VERKEY


@pytest.mark.slow
def test_jax_reproduces_devnet_recursive1_0():
    """Today's JAX package lifts the committed batch proof 0 to the
    committed recursive1_0, byte for byte (the recursive1 of the pair,
    at 2^18)."""
    jeng = fixtures.devnet_prover(JAX)
    link, out_map = jstack.zkevm_chain_spec(jeng.air.n_publics)
    st = jstack.RecursionStack(jeng.air, jeng.setup().verkey, n_queries=4,
                               link=link, out_map=out_map)
    batch = JStarkProof.from_json(fixtures.read("devnet_batch0_n16_q4"))
    rp = st.lift(batch)
    assert json.dumps(rp.to_json()) == read_a7("recursive1_0")


@pytest.mark.slow
def test_recursive2_fib_port(rec1_fib, rec1_setup):
    """The port's Recursive2 over the fib recursive1 AIR at its own
    minimal domain (2^16) aggregates two recursive1 proofs and verifies
    (the root pin included)."""
    (air, *_), _ = rec1_fib
    rec2 = engine.Recursive2(air, rec1_setup.verkey, n_queries=4,
                             device="cpu")
    assert rec2.air.n_bits == 16
    p1 = StarkProof.from_json(fixtures.read(REC1_FIB))
    agg = rec2.prove(p1, p1)
    assert agg.publics[:4] == rec2.verkey
    assert agg.publics[4:] == [1, 1, 1597]
    assert rec2.verify(agg)
