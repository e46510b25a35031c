"""Port parity: Groth16 over BN254 in xlayer_prover_tpu_torch against the
JAX package, exact equality.

The host fields and groups (Fq, Fq2, Fq12, G1, G2, one pairing and its
bilinearity), the plain Montgomery arithmetic of both moduli against
Python ints and the kernels' constants in ``csrc/bn254.cuh``, the plain
versions of the curve kernels (``msm_g1`` / ``msm_g2`` against the JAX
package's native Pippenger, ``fixed_base_g1`` / ``_g2`` against its
``_g1`` / ``_g2``, with zero scalars, infinity, a repeated point and a
point beside its negation) and of the Fr NTT (``ntt`` against
``_ntt_fr``), h against ``_h_coefficients``, setup and proof on the
cubic circuit (random.Random(42)) and the multi-constraint circuit
(random.Random(7)) of tests/test_groth16.py equal to the JAX package's
keys and proofs, a JAX setup carried across by ``keys_from_host``, the
zkey bytes and the snarkjs files, ``finalize(wrap="groth16", snark=True)``
with stand-ins, and the committed JAX fixtures
(``tests/data/g16_fib_bn128_r7/``, ``tests/data/g16_devnet_root_r11/``).
Every kernel wrapper runs its plain version here (CPU tensors).  The slow
tier proves the fib bn128 final circuit with the port on the CPU and
derives the JAX fixtures again."""

import dataclasses
import filecmp
import json
import os
import random

import numpy as np
import pytest
import torch

from xlayer_prover_tpu import native
from xlayer_prover_tpu.fields import bn254 as jbn
from xlayer_prover_tpu.fields import bn254_tower as jtower
from xlayer_prover_tpu.snark import groth16 as jg16
from xlayer_prover_tpu.snark import snarkjs_io as jsnarkjs
from xlayer_prover_tpu.snark import zkey as jzkey
from xlayer_prover_tpu.snark.r1cs import R1CSBuilder as JR1CSBuilder
from xlayer_prover_tpu_torch.fields import bn254, bn254_tower
from xlayer_prover_tpu_torch.ops import bn254_mont, bn254_msm, ntt_fr
from xlayer_prover_tpu_torch.recursion import stack
from xlayer_prover_tpu_torch.snark import groth16, snarkjs_io, zkey
from xlayer_prover_tpu_torch.snark.r1cs import R1CSBuilder

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

P, R = bn254.P, bn254.R
CUH = os.path.join(fixtures.ROOT, "xlayer_prover_tpu_torch", "csrc",
                   "bn254.cuh")
FILES = fixtures.SNARKJS_FILES


def words(values):
    return torch.from_numpy(bn254_mont.to_words(values))


# ---------------------------------------------------------------------------
# Host fields and groups
# ---------------------------------------------------------------------------

def _fq_values(rng, n):
    return [0, 1, P - 1, P - 2] + [rng.randrange(P) for _ in range(n)]


def test_fq_fq2_fq12_match_jax():
    rng = random.Random(1)
    vals = _fq_values(rng, 6)
    for a, b in zip(vals, reversed(vals)):
        assert bn254.fq_inv(a) == jbn.fq_inv(a)
        x, y = (a, b), (b, (a + 7) % P)
        for fn in ("fq2_add", "fq2_sub", "fq2_mul"):
            assert getattr(bn254_tower, fn)(x, y) == \
                getattr(jtower, fn)(x, y)
        for fn in ("fq2_sqr", "fq2_neg", "fq2_conj"):
            assert getattr(bn254_tower, fn)(x) == getattr(jtower, fn)(x)
        if x != (0, 0):
            assert bn254_tower.fq2_inv(x) == jtower.fq2_inv(x)
    f = tuple(rng.randrange(P) for _ in range(12))
    g = tuple([P - 1] + [rng.randrange(P) for _ in range(11)])
    assert bn254_tower.fq12_mul(f, g) == jtower.fq12_mul(f, g)
    assert bn254_tower.fq12_inv(f) == jtower.fq12_inv(f)
    assert bn254_tower.fq12_pow(f, 12345) == jtower.fq12_pow(f, 12345)
    assert bn254_tower.B2 == jtower.B2
    assert bn254_tower.FINAL_EXP == jtower.FINAL_EXP


def test_g1_g2_match_jax():
    rng = random.Random(2)
    ks = [0, 1, 2, R - 1, R - 2] + [rng.randrange(R) for _ in range(4)]
    g1 = bn254.g1_from_affine(bn254.G1_GEN)
    pts = [bn254.g1_mul(g1, k) for k in ks]
    jpts = [jbn.g1_mul(jbn.g1_from_affine(jbn.G1_GEN), k) for k in ks]
    assert pts == jpts
    assert bn254.g1_to_affine(pts[0]) is None and pts[0] == bn254.INF
    for p1, p2 in zip(pts, reversed(pts)):
        assert bn254.g1_add(p1, p2) == jbn.g1_add(p1, p2)
        assert bn254.g1_double(p1) == jbn.g1_double(p1)
        assert bn254.g1_neg(p1) == jbn.g1_neg(p1)
        assert bn254.g1_to_affine(p1) == jbn.g1_to_affine(p1)
        assert bn254.g1_is_on_curve(bn254.g1_to_affine(p1))
    # P + P and P + (-P)
    assert bn254.g1_add(pts[5], pts[5]) == jbn.g1_add(pts[5], pts[5])
    assert bn254.g1_to_affine(bn254.g1_add(pts[5], bn254.g1_neg(
        pts[5]))) is None
    q = [bn254_tower.g2_mul(bn254_tower.G2_GEN, k) for k in ks[:6]]
    assert q == [jtower.g2_mul(jtower.G2_GEN, k) for k in ks[:6]]
    assert q[0] is None
    for a, b in zip(q, reversed(q)):
        assert bn254_tower.g2_add(a, b) == jtower.g2_add(a, b)
        assert bn254_tower.g2_double(a) == jtower.g2_double(a)
        assert bn254_tower.g2_is_on_curve(a)
    assert bn254_tower.g2_add(q[3], bn254_tower.g2_neg(q[3])) is None


def test_pairing_matches_jax_and_is_bilinear():
    g2, g1 = bn254_tower.G2_GEN, bn254.G1_GEN
    e = bn254_tower.pairing(g2, g1)
    assert e == jtower.pairing(jtower.G2_GEN, jbn.G1_GEN)
    assert e != bn254_tower.FQ12_ONE
    a, b = 6, 35
    pa = bn254.g1_to_affine(bn254.g1_mul(bn254.g1_from_affine(g1), a))
    qb = bn254_tower.g2_mul(g2, b)
    assert bn254_tower.pairing(qb, pa) == bn254_tower.fq12_pow(e, a * b)
    assert bn254_tower.pairing_check([(pa, qb), (bn254.g1_to_affine(
        bn254.g1_neg(bn254.g1_mul(bn254.g1_from_affine(g1), a * b))), g2)])


# ---------------------------------------------------------------------------
# Plain Montgomery arithmetic and the kernels' constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["FQ", "FR"])
def test_plain_montgomery_matches_python_ints(field):
    f = getattr(bn254_mont, field)
    p = f.p
    rng = random.Random(3)
    a = [0, 1, p - 1, p, p + 1, (1 << 256) - 1] + \
        [rng.randrange(1 << 256) for _ in range(26)]
    b = list(reversed(a))
    ta, tb = f.to_mont(words(a)), f.to_mont(words(b))

    def back(x):
        return bn254_mont.from_words(f.from_mont(x))

    assert back(ta) == [v % p for v in a]
    assert back(f.mul(ta, tb)) == [x * y % p for x, y in zip(a, b)]
    assert back(f.add(ta, tb)) == [(x + y) % p for x, y in zip(a, b)]
    assert back(f.sub(ta, tb)) == [(x - y) % p for x, y in zip(a, b)]
    assert back(f.small(ta, 8)) == [8 * x % p for x in a]
    assert back(f.reduce(f.sub(f.sub(ta, tb), tb))) == \
        [(x - 2 * y) % p for x, y in zip(a, b)]
    assert f.is_zero(f.sub(ta, ta)).all()
    assert f.is_zero(ta).tolist() == [x % p == 0 for x in a]


def test_cuh_field_constants():
    """csrc/bn254.cuh's moduli, -m^-1 mod 2^32, R^2 and (Fq) R mod the
    modulus, R = 2^256."""
    import re
    text = open(CUH).read()

    def const(name):
        return int(re.search(rf"#define {name} 0x([0-9a-f]+)u",
                             text).group(1), 16)

    def words8(prefix):
        return sum(const(f"{prefix}{k}") << (32 * k) for k in range(8))

    for tag, p in (("FR", R), ("FQ", P)):
        assert words8(f"{tag}_P") == p
        assert words8(f"{tag}_R2_") == (1 << 512) % p
        assert (const(f"{tag}_N0INV") * p + 1) % (1 << 32) == 0
    assert words8("FQ_ONE_") == (1 << 256) % P


# ---------------------------------------------------------------------------
# The curve kernels' plain versions
# ---------------------------------------------------------------------------

def _edge_g1(rng, n):
    """n G1 points with infinity, a repeated point and a point beside its
    negation, and their scalars with zeros, r - 1 and equal pairs."""
    pts = jg16._g1_batch([rng.randrange(1, R) for _ in range(n)])
    sc = [rng.randrange(R) for _ in range(n)]
    pts[3] = None
    pts[5], sc[5] = pts[4], sc[4]
    pts[7] = jbn.g1_to_affine(jbn.g1_neg(jbn.g1_from_affine(pts[6])))
    sc[7] = sc[6]
    sc[0] = sc[11] = 0
    sc[9], sc[10] = R - 1, 1
    return pts, sc


def _jax_msm_g1(pts, sc):
    """The JAX package's G1 MSM, affine: its native Pippenger, or its
    Python one where the native library is not built."""
    jac = native.msm_g1(pts, sc)
    if jac is None:
        pairs = [(p, k % R) for p, k in zip(pts, sc) if p is not None]
        jac = jbn.msm([p for p, _ in pairs], [k for _, k in pairs])
    return jbn.g1_to_affine(jac)


def _jax_msm_g2(pts, sc):
    """The JAX package's G2 MSM, affine: its native Pippenger, or the sum
    of g2_mul terms its prover falls back to."""
    jac = native.msm_g2(pts, sc)
    if jac is None:
        acc = None
        for p, k in zip(pts, sc):
            if p is not None and k % R:
                acc = jtower.g2_add(acc, jtower.g2_mul(p, k))
        return acc
    x, y, z = jac
    if z == (0, 0):
        return None
    zi = jtower.fq2_inv(z)
    zi2 = jtower.fq2_sqr(zi)
    return (jtower.fq2_mul(x, zi2), jtower.fq2_mul(y, jtower.fq2_mul(zi2, zi)))


def test_plain_msm_g1_matches_native():
    pts, sc = _edge_g1(random.Random(4), 64)
    got = bn254_msm.msm_g1(torch.from_numpy(bn254_msm.g1_words(pts)),
                           words(sc))
    assert got.shape == (3, 4)
    assert bn254_msm.to_affine_g1(got) == _jax_msm_g1(pts, sc)
    zero = bn254_msm.msm_g1(torch.from_numpy(bn254_msm.g1_words(pts)),
                            words([0] * 64))
    assert bn254_mont.from_words(zero) == [0, 1, 0]


def test_plain_msm_g2_matches_native():
    rng = random.Random(5)
    n = 16
    pts = jg16._g2_batch([rng.randrange(1, R) for _ in range(n)])
    sc = [rng.randrange(R) for _ in range(n)]
    pts[2] = None
    pts[5], sc[5] = pts[4], sc[4]
    pts[7], sc[7] = jtower.g2_neg(pts[6]), sc[6]
    sc[0] = 0
    got = bn254_msm.msm_g2(torch.from_numpy(bn254_msm.g2_words(pts)),
                           words(sc))
    assert got.shape == (3, 8)
    assert bn254_msm.to_affine_g2(got) == _jax_msm_g2(pts, sc)


def test_plain_fixed_base_matches_jax():
    rng = random.Random(6)
    ks = [0, 1, 2, R - 1, R - 2, 1 << 253] + \
        [rng.randrange(R) for _ in range(10)]
    g1 = bn254_msm.fixed_base_g1(bn254.G1_GEN, words(ks))
    assert g1.shape == (16, 8)
    assert bn254_msm.g1_points(g1) == [jg16._g1(k) for k in ks]
    assert not g1[0].any()
    g2 = bn254_msm.fixed_base_g2(bn254_tower.G2_GEN, words(ks[:8]))
    assert g2.shape == (8, 16)
    assert bn254_msm.g2_points(g2) == [jg16._g2(k) for k in ks[:8]]


def test_msm_refuses_bad_shapes():
    with pytest.raises(ValueError):
        bn254_msm.msm_g1(torch.zeros((4, 16), dtype=torch.int64),
                         torch.zeros((4, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        bn254_msm.msm_g2(torch.zeros((4, 16), dtype=torch.int64),
                         torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        ntt_fr.ntt(torch.zeros((6, 4), dtype=torch.int64))


# ---------------------------------------------------------------------------
# The Fr NTT and h
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 11))
def test_plain_ntt_matches_jax(bits):
    rng = random.Random(bits)
    vals = [rng.randrange(R) for _ in range(1 << bits)]
    vals[0] = R - 1
    t = words(vals)
    for inverse in (False, True):
        assert bn254_mont.from_words(ntt_fr.ntt(t, inverse)) == \
            jg16._ntt_fr(vals, inverse)
    assert ntt_fr.root_of_unity(bits) == jg16._fr_root_of_unity(bits)


def test_plain_mul_sub():
    rng = random.Random(8)
    a, b, c = ([0, 1, R - 1] + [rng.randrange(R) for _ in range(13)]
               for _ in range(3))
    got = ntt_fr.mul_sub(words(a), words(b), words(c))
    assert bn254_mont.from_words(got) == [(x * y - z) % R
                                      for x, y, z in zip(a, b, c)]


def cubic_circuit(builder, x: int = 3):
    """tests/test_groth16.py cubic_circuit: x^3 + x + 5 == out."""
    b = builder()
    out = b.public((x ** 3 + x + 5) % R)
    xw = b.wire(x)
    x2 = b.mul(xw, xw)
    x3 = b.mul(x2, xw)
    b.assert_eq_lc({x3: 1, xw: 1}, 5, out)
    return b


def multi_circuit(builder):
    """tests/test_groth16.py test_groth16_multi_constraint's circuit."""
    b = builder()
    out = b.public(0)
    ws = [b.wire(i + 2) for i in range(6)]
    acc = ws[0]
    for w in ws[1:]:
        acc = b.mul(acc, w)
    b.assert_eq_lc({acc: 1}, 0, out)
    prod = 1
    for i in range(6):
        prod = prod * (i + 2) % R
    b.set_value(out, prod)
    return b


CIRCUITS = {"cubic": (cubic_circuit, 42), "multi": (multi_circuit, 7)}


def test_h_matches_jax_and_refuses_a_bad_witness():
    b, jb = multi_circuit(R1CSBuilder), multi_circuit(JR1CSBuilder)
    r1cs, wit = b.build(), b.witness()
    jr1cs = jb.build()
    bits = (len(r1cs.constraints) - 1).bit_length()
    h = groth16._h_coefficients(r1cs, wit, bits, torch.device("cpu"))
    assert bn254_mont.from_words(h) == jg16._h_coefficients(jr1cs, wit, bits)
    bad = list(wit)
    bad[3] = (bad[3] + 1) % R
    with pytest.raises(AssertionError):
        groth16._h_coefficients(r1cs, bad, bits, torch.device("cpu"))
    with pytest.raises(AssertionError):
        jg16._h_coefficients(jr1cs, bad, bits)


# ---------------------------------------------------------------------------
# Setup and proof against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def proven():
    """name -> (r1cs, witness, JAX (pk, vk, proof), port (pk, vk, proof)),
    each package's setup and proof drawn from one random.Random(seed).
    The cubic circuit's port proof is made with the JAX package's keys
    carried across by keys_from_host (the port's own keys are equal to
    them, test_keys_and_proof_equal_jax), the multi-constraint circuit's
    with the port's own keys."""
    out = {}
    for name, (build, seed) in CIRCUITS.items():
        b, jb = build(R1CSBuilder), build(JR1CSBuilder)
        r1cs, wit = b.build(), b.witness()
        jr1cs = jb.build()
        assert jb.witness() == wit and jr1cs.constraints == r1cs.constraints
        rng = random.Random(seed)
        jpk, jvk = jg16.setup(jr1cs, rng=rng)
        jproof = jg16.prove(jpk, jr1cs, wit, rng=rng)
        rng = random.Random(seed)
        pk, vk = groth16.setup(r1cs, rng=rng, device="cpu")
        keys = groth16.keys_from_host(jpk, jvk, device="cpu") \
            if name == "cubic" else (pk, vk)
        proof = groth16.prove(keys[0], r1cs, wit, rng=rng)
        out[name] = (r1cs, wit, (jpk, jvk, jproof), (pk, vk, proof))
    return out


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_keys_and_proof_equal_jax(proven, name):
    _r1cs, _wit, (jpk, jvk, jproof), (pk, vk, proof) = proven[name]
    assert pk.a_query.device.type == "cpu"
    hpk, hvk = groth16.keys_to_host(pk, vk)
    assert dataclasses.asdict(hpk) == dataclasses.asdict(jpk)
    assert dataclasses.asdict(hvk) == dataclasses.asdict(jvk)
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_proof_verifies_and_refuses(proven, name):
    r1cs, wit, _jax, (_pk, vk, proof) = proven[name]
    pubs = wit[1:1 + r1cs.n_public]
    assert groth16.verify(vk, proof, pubs)
    assert not groth16.verify(vk, proof, [(pubs[0] + 1) % R])
    bad = groth16.Proof(a=proof.c, b=proof.b, c=proof.a)
    assert not groth16.verify(vk, bad, pubs)


def test_jax_setup_carried_across(proven):
    """A JAX setup carried into the port by keys_from_host goes back
    unchanged, and the port's proof with it (the `proven` fixture's cubic
    proof) is the JAX package's; a bad witness is refused."""
    r1cs, wit, (jpk, jvk, jproof), (_pk, _vk, proof) = proven["cubic"]
    pk, vk = groth16.keys_from_host(jpk, jvk, device="cpu")
    assert pk.c_query.shape == (r1cs.n_wires, 8)
    assert not pk.c_query[:r1cs.n_public + 1].any()
    hpk, hvk = groth16.keys_to_host(pk, vk)
    assert dataclasses.asdict(hpk) == dataclasses.asdict(jpk)
    assert dataclasses.asdict(hvk) == dataclasses.asdict(jvk)
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    bad = list(wit)
    bad[2] = (bad[2] + 1) % R
    with pytest.raises(AssertionError):
        groth16.prove(pk, r1cs, bad)


def test_zkey_bytes_equal_jax(proven, tmp_path):
    r1cs, _wit, (jpk, jvk, _jp), (pk, vk, _p) = proven["cubic"]
    path, jpath = str(tmp_path / "port.zkey"), str(tmp_path / "jax.zkey")
    zkey.write_zkey(zkey.from_setup(pk, vk, r1cs), path)
    jzkey.write_zkey(jzkey.from_setup(jpk, jvk, r1cs), jpath)
    assert filecmp.cmp(path, jpath, shallow=False)
    pk2, vk2 = zkey.to_keys(zkey.read_zkey(path), device="cpu")
    assert dataclasses.asdict(groth16.keys_to_host(pk2, vk2)[0]) == \
        dataclasses.asdict(jpk)


def test_snarkjs_files_equal_jax(proven, tmp_path):
    r1cs, wit, (_jpk, jvk, jproof), (_pk, vk, proof) = proven["cubic"]
    pubs = wit[1:1 + r1cs.n_public]
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    snarkjs_io.export_vk(vk, str(port / FILES[0]))
    snarkjs_io.export_proof(proof, str(port / FILES[1]))
    snarkjs_io.export_publics(pubs, str(port / FILES[2]))
    jsnarkjs.export_vk(jvk, str(jax / FILES[0]))
    jsnarkjs.export_proof(jproof, str(jax / FILES[1]))
    jsnarkjs.export_publics(pubs, str(jax / FILES[2]))
    for f in FILES:
        assert filecmp.cmp(port / f, jax / f, shallow=False), f
    assert snarkjs_io.verify_files(*(str(port / f) for f in
                                     (FILES[0], FILES[2], FILES[1])))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([str((pubs[0] + 1) % R)]))
    assert not snarkjs_io.verify_files(str(port / FILES[0]), str(bad),
                                       str(port / FILES[1]))


# ---------------------------------------------------------------------------
# finalize(wrap="groth16", snark=True) with stand-ins
# ---------------------------------------------------------------------------

class _Engine:
    """A stand-in for the stack's recursion engines and RecursiveF."""

    def __init__(self):
        self.air, self.verkey = "air", [0, 0, 0, 0]
        self.setup = self
        self.proved = []

    def verify(self, _proof):
        return True

    def prove(self, inner, timings=None):
        self.proved.append(inner)
        return "recf-proof"


def test_finalize_groth16_contract(monkeypatch):
    """finalize(snark=True): the final circuit of the cached ("recF",
    level) engine's proof, Groth16 set up once per level under ("g16",
    level) with the caller's rng, proven with the same rng, verified; a
    failed verification raises ValueError."""
    b = cubic_circuit(R1CSBuilder)
    r1cs, wit = b.build(), b.witness()
    calls = []

    def build_final_circuit(air, verkey, proof):
        calls.append(("circuit", air, proof))
        return r1cs, wit, None

    def setup(system, rng=None, device=None, timings=None):
        calls.append(("setup", rng.random(), device))
        timings["g16_wire_polys_s"] = 0.0
        return "pk", "vk"

    def prove(pk, system, witness, rng=None, timings=None):
        calls.append(("prove", pk, rng.random(), witness is wit))
        timings["g16_h_s"] = 0.0
        return "g16-proof"

    verdict = {"ok": True}

    def verify(vk, proof, publics):
        calls.append(("verify", vk, proof, publics))
        return verdict["ok"]

    from xlayer_prover_tpu_torch.snark import final_circuit
    monkeypatch.setattr(final_circuit, "build_final_circuit",
                        build_final_circuit)
    monkeypatch.setattr(groth16, "setup", setup)
    monkeypatch.setattr(groth16, "prove", prove)
    monkeypatch.setattr(groth16, "verify", verify)
    st = stack.RecursionStack("batch-air", [0, 0, 0, 0], device="cpu")
    eng = _Engine()
    st._rec1 = st._rec2 = eng
    st._aux[("recF", 2)] = eng
    rp = stack.RecursiveProof(level=2, proof="root")
    timings = {}
    draws = random.Random(11)
    out = st.finalize(rp, wrap="groth16", snark=True, rng=random.Random(11),
                      timings=timings)
    assert out == {"final": "groth16", "proof": "g16-proof", "vk": "vk",
                   "publics": wit[1:1 + r1cs.n_public],
                   "recf_proof": "recf-proof"}
    assert calls == [("circuit", "air", "recf-proof"),
                     ("setup", draws.random(), "cpu"),
                     ("prove", "pk", draws.random(), True),
                     ("verify", "vk", "g16-proof", [wit[1]])]
    assert st._aux[("g16", 2)] == ("pk", "vk")
    assert set(timings) == {"r1cs_s", "g16_setup_s", "g16_wire_polys_s",
                            "g16_prove_s", "g16_h_s", "g16_verify_s"}
    # the key is set up once per level
    calls.clear()
    timings = {}
    st.finalize(rp, wrap="groth16", snark=True, rng=random.Random(1),
                timings=timings)
    assert [c[0] for c in calls] == ["circuit", "prove", "verify"]
    assert "g16_setup_s" not in timings
    verdict["ok"] = False
    with pytest.raises(ValueError, match="Groth16"):
        st.finalize(rp, wrap="groth16", snark=True, rng=random.Random(1))
    # snark=False keeps its contract and names the RecursiveF proof twice
    out = st.finalize(rp, wrap="groth16", snark=False)
    assert out["final"] == "r1cs"
    assert out["proof"] == out["recf_proof"] == "recf-proof"


# ---------------------------------------------------------------------------
# The committed JAX fixtures
# ---------------------------------------------------------------------------

def _files(name):
    d = fixtures.snarkjs_dir(name)
    return [os.path.join(d, f) for f in FILES]


@pytest.mark.parametrize("name", list(fixtures.GROTH16))
def test_committed_fixtures_verify(name):
    vk_path, proof_path, pub_path = _files(name)
    assert snarkjs_io.verify_files(vk_path, pub_path, proof_path)
    with open(pub_path) as f:
        publics = [int(v) for v in json.load(f)]
    with open(vk_path) as f:
        assert json.load(f)["nPublic"] == len(publics)
    if name == "g16_devnet_root_r11":
        with open(os.path.join(fixtures.ROOT,
                               "PROOF_a7_cascade_devnet.json")) as f:
            want = [int(v) for v in json.load(f)["groth16_publics"]]
        assert publics == want and len(want) == 52
    else:
        assert publics == [1, 1, 1597]


# ---------------------------------------------------------------------------
# Slow tier
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_port_groth16_over_fib_final_circuit(tmp_path):
    """The port's Groth16 over the fib bn128 final circuit on the CPU
    (plain versions), random.Random(7): its snarkjs files equal
    tests/data/g16_fib_bn128_r7/."""
    from xlayer_prover_tpu_torch.snark import final_circuit
    from xlayer_prover_tpu_torch.stark import prover
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    air, _l, const_np, cm1, publics = fixtures.fib_bn128_case(
        "xlayer_prover_tpu_torch")
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1, publics)
    r1cs, wit, _fb = final_circuit.build_final_circuit(air, setup.verkey,
                                                       proof)
    rng = random.Random(7)
    pk, vk = groth16.setup(r1cs, rng=rng, device="cpu")
    g_proof = groth16.prove(pk, r1cs, wit, rng=rng)
    out = [str(tmp_path / f) for f in FILES]
    snarkjs_io.export_vk(vk, out[0])
    snarkjs_io.export_proof(g_proof, out[1])
    snarkjs_io.export_publics(wit[1:1 + r1cs.n_public], out[2])
    for got, want in zip(out, _files("g16_fib_bn128_r7")):
        assert filecmp.cmp(got, want, shallow=False), want


@pytest.mark.slow
@pytest.mark.parametrize("name", list(fixtures.GROTH16))
def test_groth16_fixtures_are_the_jax_proofs(name, tmp_path):
    fixtures.write_groth16(name, str(tmp_path))
    for f, want in zip(FILES, _files(name)):
        assert filecmp.cmp(tmp_path / f, want, shallow=False), want


def test_words_round_trip():
    vals = [0, 1, R - 1, P - 1, (1 << 256) - 1]
    assert bn254_mont.from_words(words(vals)) == vals
    assert words(vals).dtype == torch.int64
    assert np.array_equal(bn254_mont.to_words([]).reshape(-1, 4),
                          np.zeros((0, 4), dtype=np.int64))
