"""The port's fflonk (``snark/fflonk.py``) against the JAX package's on the
CPU, byte for byte.

The polynomial helpers on word tensors equal the JAX package's on seeded
inputs; on tests/test_fflonk.py's two circuits the keys (the SRS, [C0],
every preprocessed poly, sigma and selector column, [tau] G2) and the
proof ([C1], [C2], [W], [W'], the 15 evaluations) equal the JAX package's
under the same random.Random; each package's verifier accepts the other's
proof and both refuse the same tampered ones.  The committed fixture of
chip_smoke.py phase 13 (b) (tests/data/fflonk_seeded_n12.json, the JAX
package's keys and proof of a seeded R1CS at n = 2^12) verifies under
both verifiers; the slow tier proves it again with the JAX package, and
with the port on the CPU, and compares.
"""

import dataclasses
import json
import os
import random

import pytest
import torch

from xlayer_prover_tpu.snark import fflonk as jff
from xlayer_prover_tpu.snark import plonk as jplonk
from xlayer_prover_tpu_torch.fields.bn254 import R
from xlayer_prover_tpu_torch.ops.bn254_mont import from_words, to_words
from xlayer_prover_tpu_torch.snark import fflonk, plonk
from xlayer_prover_tpu_torch.snark.r1cs import R1CSBuilder

from tests.torch_cpu import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "fflonk_seeded_n12.json")


def words(vals):
    return torch.from_numpy(to_words([v % R for v in vals]))


def ints(t):
    return jff._trim(from_words(t))


def seeded(n, seed):
    rng = random.Random(seed)
    out = [rng.randrange(R) for _ in range(n)]
    out[:2] = [0, R - 1][:n]
    return out


# ---------------------------------------------------------------------------
# polynomial helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(1, 1), (3, 9), (9, 3), (20, 33)])
def test_poly_helpers_equal_jax(n, m):
    p, q = seeded(n, n), seeded(m, 100 + m)
    k = seeded(1, 5)[0] or 7
    assert ints(fflonk.padd(words(p), words(q))) == jff.padd(p, q)
    assert ints(fflonk.psub(words(p), words(q))) == jff.psub(p, q)
    assert ints(fflonk.pscale(words(p), k)) == jff.pscale(p, k)
    assert ints(fflonk.pmul(words(p), words(q))) == jff.pmul(p, q)
    x = seeded(3, 9)[2]
    assert fflonk.peval(words(p), x) == jff.peval(p, x)
    w = fflonk._root_of_order(8)
    assert from_words(fflonk._shift_omega(words(p), w)) == \
        jff._shift_omega(p, w)
    for t in (3, 4, 8):
        polys = [p, q, p[:1]]
        assert ints(fflonk._combine([words(v) for v in polys], t)) == \
            jff._combine(polys, t)
    # divisions by binomials, exact and not
    for d in ([(-x) % R, 1], [R - 5, 0, 0, 3], [R - 1] + [0] * 7 + [1]):
        got_q, got_r = fflonk.pdivmod(words(p), d)
        want_q, want_r = jff.pdivmod(p, d)
        assert (ints(got_q), ints(got_r)) == (want_q, want_r)
    prod = jff.pmul(q, [R - 1] + [0] * 3 + [1])
    assert ints(fflonk.pdiv_zh(words(prod), 4)) == jff.pdiv_zh(prod, 4)
    with pytest.raises(ValueError):
        fflonk.pdivmod(words(p), [1, 2, 1])


def test_few_point_helpers_equal_jax():
    pts = seeded(6, 3)[1:]
    vals = seeded(5, 4)
    y = seeded(2, 8)[1]
    assert fflonk._vanishing(pts) == jff._vanishing(pts)
    assert fflonk._lagrange_at(pts, vals, y) == jff._lagrange_at(pts, vals, y)
    assert fflonk._interp(pts, vals) == jff._interp(pts, vals)
    for n in (8, 16, 1 << 12, 1 << 24):
        assert fflonk._root_sets(y, n) == jff._root_sets(y, n)
    for k in (3, 8, 3 << 12):
        assert fflonk._root_of_order(k) == jff._root_of_order(k)


def test_transcript_equals_jax():
    ours, theirs = fflonk._FS(), jff._FS()
    for fs in (ours, theirs):
        fs.absorb_point((1, 2))
        fs.absorb_scalar(R - 1)
    assert ours.challenge() == theirs.challenge()
    assert ours.state == theirs.state


# ---------------------------------------------------------------------------
# keys and proofs
# ---------------------------------------------------------------------------

def cubic(builder, x: int):
    b = builder()
    out = b.public((x ** 3 + x + 5) % R)
    xw = b.wire(x)
    x2 = b.mul(xw, xw)
    x3 = b.mul(x2, xw)
    b.assert_eq_lc({x3: 1, xw: 1}, 5, out)
    return b


def multi(builder):
    b = builder()
    xs = [b.public(v) for v in (3, 5, 9)]
    w1 = b.mul(xs[0], xs[1])
    w2 = b.mul(w1, xs[2])
    out = b.wire((2 * 135 + 3 * 15 + 3 + 7) % R)
    b.assert_eq_lc({w2: 2, w1: 3, xs[0]: 1}, 7, out)
    b.mul(out, out)
    return b


def prove_both(b, seed: int):
    """The JAX package's setup and proof and the port's (from the array
    form, its witness from r1cs_to_arrays) under random.Random(seed)."""
    r1cs, wit = b.build(), b.witness()
    pubs = wit[1:1 + r1cs.n_public]
    jc = jplonk.r1cs_to_plonk(r1cs)
    jv = jplonk.plonk_witness(jc, r1cs, wit)
    rng = random.Random(seed)
    jpk, jvk = jff.setup(jc, rng=rng)
    jproof = jff.prove(jpk, jc, jv, pubs, rng=rng)
    arr = plonk.r1cs_to_arrays(r1cs, wit)
    rng = random.Random(seed)
    timings = {}
    pk, vk = fflonk.setup(arr, rng=rng, device="cpu", timings=timings)
    assert set(timings) == {"srs_s", "sigma_s", "ntt_s", "c0_s"}
    timings = {}
    proof = fflonk.prove(pk, arr, pubs, rng=rng, timings=timings)
    assert {"ntt_s", "div_s", "eval_s", "commit_c1_s", "commit_c2_s",
            "commit_w_s", "commit_w2_s"} <= set(timings)
    return (jpk, jvk, jproof), (pk, vk, proof), pubs


@pytest.fixture(scope="module")
def cubic_proofs():
    return prove_both(cubic(R1CSBuilder, 3), 11)


def test_keys_equal_jax(cubic_proofs):
    (jpk, jvk, _jp), (pk, vk, _p), _pubs = cubic_proofs
    host = fflonk.key_to_host(pk)
    assert (host.n, host.n_public) == (jpk.n, jpk.n_public)
    assert host.taus_g1 == jpk.taus_g1
    assert host.c0 == jpk.c0 and vk.c0 == jvk.c0
    assert host.polys == jpk.polys
    assert list(host.sigma_cols) == [list(c) for c in jpk.sigma_cols]
    assert host.q_cols == jpk.q_cols
    assert (vk.n, vk.n_public, vk.g2_gen, vk.g2_tau) == \
        (jvk.n, jvk.n_public, jvk.g2_gen, jvk.g2_tau)
    assert fflonk.key_digests(host) == fflonk.key_digests(jpk)


def test_proof_equals_jax_and_both_verifiers_agree(cubic_proofs):
    (_jpk, jvk, jproof), (_pk, vk, proof), pubs = cubic_proofs
    assert (proof.c1, proof.c2, proof.w, proof.w2) == \
        (jproof.c1, jproof.c2, jproof.w, jproof.w2)
    assert list(proof.evals.items()) == list(jproof.evals.items())
    assert fflonk.to_json(vk, proof, pubs) == \
        fflonk.to_json(jvk, jproof, pubs)
    assert fflonk.verify(vk, proof, pubs)
    as_jax = jff.FflonkProof(c1=proof.c1, c2=proof.c2, w=proof.w,
                             w2=proof.w2, evals=dict(proof.evals))
    assert jff.verify(jvk, as_jax, pubs)
    bad = dict(proof.evals)
    bad["z"] = (bad["z"] + 1) % R
    for verify, v, pr in ((fflonk.verify, vk, proof),
                          (jff.verify, jvk, as_jax)):
        assert not verify(v, dataclasses.replace(pr, evals=bad), pubs)
        assert not verify(v, pr, [(pubs[0] + 1) % R])


def test_multi_constraint_circuit_equals_jax():
    (_jpk, jvk, jproof), (pk, vk, proof), pubs = prove_both(
        multi(R1CSBuilder), 13)
    assert fflonk.to_json(vk, proof, pubs) == \
        fflonk.to_json(jvk, jproof, pubs)
    assert fflonk.key_digests(fflonk.key_to_host(pk)) == \
        fflonk.key_digests(_jpk)
    assert fflonk.verify(vk, proof, pubs)
    assert not fflonk.verify(vk, proof, [pubs[0], pubs[1],
                                         (pubs[2] + 1) % R])


def test_list_form_and_python_witness_prove_alike(cubic_proofs):
    """The list form and plonk_witness's list, through arrays_of, give
    the same key and proof as r1cs_to_arrays."""
    *_j, (_pk, vk, proof), pubs = cubic_proofs
    b = cubic(R1CSBuilder, 3)
    r1cs, wit = b.build(), b.witness()
    circ = plonk.r1cs_to_plonk(r1cs)
    arr = plonk.arrays_of(circ, plonk.plonk_witness(circ, r1cs, wit))
    rng = random.Random(11)
    pk2, vk2 = fflonk.setup(arr, rng=rng, device="cpu")
    proof2 = fflonk.prove(pk2, arr, pubs, rng=rng)
    assert fflonk.to_json(vk2, proof2, pubs) == fflonk.to_json(vk, proof,
                                                               pubs)


class _Engine:
    """A stand-in for the recursion stack's engines and RecursiveF."""

    def __init__(self):
        self.air, self.verkey = "air", [0, 0, 0, 0]
        self.setup = self

    def verify(self, _proof):
        return True

    def prove(self, inner, timings=None):
        return "recf-proof"


def test_finalize_keeps_the_circuit_a_second_wrap_proves(monkeypatch):
    """RecursionStack.finalize keeps the final circuit's R1CS and witness
    in ``final_circuit``, and they convert to the PLONK arrays that fflonk
    proves."""
    from xlayer_prover_tpu_torch.recursion import stack
    from xlayer_prover_tpu_torch.snark import final_circuit
    b = cubic(R1CSBuilder, 3)
    r1cs, wit = b.build(), b.witness()
    monkeypatch.setattr(final_circuit, "build_final_circuit",
                        lambda air, verkey, proof: (r1cs, wit, None))
    st = stack.RecursionStack("batch-air", [0, 0, 0, 0], device="cpu")
    st._rec1 = st._rec2 = eng = _Engine()
    st._aux[("recF", 2)] = eng
    assert st.final_circuit is None
    st.finalize(stack.RecursiveProof(level=2, proof="root"), wrap="groth16",
                snark=False)
    assert st.final_circuit == (r1cs, wit)
    arr = plonk.r1cs_to_arrays(*st.final_circuit)
    circ = plonk.r1cs_to_plonk(r1cs)
    back = plonk.arrays_of(circ, plonk.plonk_witness(circ, r1cs, wit))
    assert (arr.vals == back.vals).all() and (arr.wires == back.wires).all()


def test_zero_poly_commits_as_jax():
    pts = fflonk._srs(fflonk.fr_poly.scan_mul(words([5]), True, n=3))
    want = jff._commit([(1, 2)] * 3, [0, 0, 0])
    assert fflonk._commit(pts, words([0, 0, 0])) == want
    assert want is None


# ---------------------------------------------------------------------------
# the committed fixture of chip_smoke.py phase 13 (b)
# ---------------------------------------------------------------------------

def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _from_json(case):
    def pt(p):
        return None if p is None else tuple(int(v) for v in p)

    def g2(p):
        return tuple(tuple(int(v) for v in c) for c in p)
    v = case["vk"]
    vk = fflonk.FflonkVerifyingKey(n=v["n"], n_public=v["n_public"],
                                   c0=pt(v["c0"]), g2_gen=g2(v["g2_gen"]),
                                   g2_tau=g2(v["g2_tau"]))
    p = case["proof"]
    proof = fflonk.FflonkProof(c1=pt(p["c1"]), c2=pt(p["c2"]), w=pt(p["w"]),
                               w2=pt(p["w2"]),
                               evals={k: int(x) for k, x in
                                      p["evals"].items()})
    return vk, proof, [int(x) for x in case["publics"]]


def test_fixture_verifies_and_matches_its_circuit():
    case = _fixture()
    vk, proof, pubs = _from_json(case)
    assert fflonk.to_json(vk, proof, pubs) == {k: case[k] for k in (
        "vk", "proof", "publics")}
    r1cs, wit = plonk.seeded_r1cs(case["seed"], case["constraints"])
    arr = plonk.r1cs_to_arrays(r1cs)
    assert (arr.n, arr.n_gates) == (case["n"], case["gates"]) == \
        (1 << 12, 3979)
    assert pubs == wit[1:1 + r1cs.n_public]
    assert fflonk.verify(vk, proof, pubs)
    jvk = jff.FflonkVerifyingKey(**dataclasses.asdict(vk))
    assert jff.verify(jvk, jff.FflonkProof(**dataclasses.asdict(proof)),
                      pubs)
    bad = dict(proof.evals)
    bad["a"] = (bad["a"] + 1) % R
    assert not fflonk.verify(vk, dataclasses.replace(proof, evals=bad), pubs)
    assert not fflonk.verify(vk, proof, [(p + 1) % R for p in pubs])


@pytest.mark.slow
def test_fixture_proven_again_by_jax():
    """The JAX package proves the fixture's case again (~30 s)."""
    import tools.torch_proof_fixtures as fx
    assert json.loads(fx.fflonk_seeded_jax()) == _fixture()


@pytest.mark.slow
def test_fixture_proven_by_the_port_on_the_cpu():
    """The port's setup and prove of the fixture's case on the CPU (the
    plain versions: ~35 min in one process) equal the file."""
    case = _fixture()
    r1cs, wit = plonk.seeded_r1cs(case["seed"], case["constraints"])
    arr = plonk.r1cs_to_arrays(r1cs, wit)
    rng = random.Random(case["rng_seed"])
    pk, vk = fflonk.setup(arr, rng=rng, device="cpu")
    pubs = wit[1:1 + r1cs.n_public]
    proof = fflonk.prove(pk, arr, pubs, rng=rng)
    got = fflonk.to_json(vk, proof, pubs)
    assert got == {k: case[k] for k in ("vk", "proof", "publics")}
    assert fflonk.key_digests(fflonk.key_to_host(pk)) == case["pk_sha256"]
