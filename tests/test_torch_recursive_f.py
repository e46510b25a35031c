"""Port parity: RecursiveF's BN128 commitment stack and the final circuit's
R1CS in xlayer_prover_tpu_torch against the JAX package, exact equality.

Poseidon-BN254 (the circomlib known answers; the plain PyTorch version of
the permutation kernel, ``host_permute`` and the JAX package's permutation
at every width t in 2..17 with edge inputs), the kernels' constant table
against ``csrc/bn254.cuh``, ``BN128Scheme`` trees and openings (leaves,
levels, root, sibling groups) at widths 1, 4, 5, 9, 48 and 60,
``TranscriptBN128``, the fib proof over the bn128 scheme byte-equal to the
JAX package's (``tests/data/fib_bn128_n4_q2.proof.json``) with its
refusals, the final circuit's R1CS (constraints and witness) of that proof
equal to the JAX package's, and ``finalize(wrap="groth16", snark=False)``.
The slow tier runs RecursiveF over the committed fib recursive1 proof on
the CPU (finalize on a CPU stack, byte-equal to the JAX package's
RecursiveF proof) and proves the committed JAX fixtures again."""

import copy
import json
import os
import re

import numpy as np
import pytest
import torch

from xlayer_prover_tpu.ops import poseidon_bn254 as jpbn
from xlayer_prover_tpu.snark import final_circuit as jfc
from xlayer_prover_tpu.stark import commitment as jcommit
from xlayer_prover_tpu.stark import prover as jprover
from xlayer_prover_tpu.stark.proof import StarkProof as JStarkProof
from xlayer_prover_tpu_torch.fields import bn254
from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn
from xlayer_prover_tpu_torch.ops.bn254_mont import from_words, to_words
from xlayer_prover_tpu_torch.recursion import engine, stack
from xlayer_prover_tpu_torch.snark import final_circuit, r1cs
from xlayer_prover_tpu_torch.stark import commitment, prover, verifier
from xlayer_prover_tpu_torch.stark.proof import StarkProof

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

P = pbn.P
PORT, JAX = "xlayer_prover_tpu_torch", "xlayer_prover_tpu"
FIB = "fib_bn128_n4_q2"
RECF_DEVNET = "recF_devnet_root_q4"
CUH = os.path.join(fixtures.ROOT, "xlayer_prover_tpu_torch", "csrc",
                   "bn254.cuh")


def limbs_tensor(values, shape):
    return torch.from_numpy(to_words(values)).reshape(*shape, 4)


# ---------------------------------------------------------------------------
# Poseidon-BN254
# ---------------------------------------------------------------------------

def test_poseidon_bn254_kats():
    """Canonical circomlib known answers, as tests/test_recursive_f.py."""
    assert pbn.hash_n([1, 2]) == jpbn.hash_n([1, 2]) == \
        7853200120776062878684798364095072458815029376092732009249414926327459813530
    assert pbn.hash_n([1]) == jpbn.hash_n([1]) == \
        18586133768512220936620570745912940619677854269274689475585506675881198879027


def test_rounds_and_modulus_match_jax():
    assert (pbn.P, pbn.N_ROUNDS_F, pbn.N_ROUNDS_P) == \
        (jpbn.P, jpbn.N_ROUNDS_F, jpbn.N_ROUNDS_P)
    assert pbn._constants() == jpbn._constants()
    assert bn254.R == P and bn254.fr_inv(3) * 3 % P == 1


@pytest.mark.parametrize("t", range(2, 18))
def test_plain_permutation_matches_host_and_jax(t):
    """The plain version of poseidon_bn254_permute, host_permute and the
    JAX package's permute agree at width t, edge inputs (0, 1, P - 1, P,
    P + 1, 2^256 - 1: inputs at or above P are reduced mod P) included."""
    rng = np.random.default_rng(100 + t)
    edges = [0, 1, P - 1, P, P + 1, (1 << 256) - 1]
    states = [[e] * t for e in edges] + [
        [int.from_bytes(rng.bytes(32), "little") % P for _ in range(t)]
        for _ in range(4)]
    states.append([(1 << 256) - 1 - k for k in range(t)])
    got = pbn.permute(limbs_tensor([v for s in states for v in s],
                                   (len(states), t)), t)
    got = from_words(got)
    want = [v for s in states for v in jpbn.permute(s)]
    assert got == want
    assert [v for s in states for v in pbn.host_permute(s)] == want


def test_permute_refuses_bad_shapes():
    with pytest.raises(ValueError):
        pbn.permute(torch.zeros((2, 3, 4), dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        pbn.permute(torch.zeros((2, 18, 4), dtype=torch.int64), 18)


def test_kernel_table_and_cuh_constants():
    """The kernels read kernel_table(t) (Montgomery form, R = 2^256) and
    csrc/bn254.cuh's modulus, -p^-1 mod 2^32 and R^2 mod p."""
    text = open(CUH).read()

    def words(prefix):
        return sum(int(re.search(rf"#define {prefix}{k} 0x([0-9a-f]+)u",
                                  text).group(1), 16) << (32 * k)
                   for k in range(8))

    assert words("FR_P") == P
    assert words("FR_R2_") == pbn.MONT_R2 == (1 << 512) % P
    n0 = int(re.search(r"#define FR_N0INV 0x([0-9a-f]+)u", text).group(1),
             16)
    assert n0 == pbn.MONT_N0INV and (n0 * P + 1) % (1 << 32) == 0
    c, m, pmat, s, nrp = pbn._params(5)
    table = pbn.kernel_table(5)
    offs, total = pbn.table_layout(5)
    assert table.size == 8 * total

    def entry(i):
        return sum(int(w) << (32 * k) for k, w in enumerate(table[8 * i:
                                                                8 * i + 8]))

    mont_inv = pow(pbn.MONT_R, -1, P)
    assert entry(offs["c"] + 7) * mont_inv % P == c[7]
    assert entry(offs["m"] + 2 * 5 + 3) * mont_inv % P == m[2][3]
    assert entry(offs["p"] + 4) * mont_inv % P == pmat[0][4]
    assert entry(total - 1) * mont_inv % P == s[-1]


# ---------------------------------------------------------------------------
# BN128Scheme and TranscriptBN128
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,height", [(1, 37), (4, 20), (5, 50), (9, 17),
                                          (48, 33), (60, 16)])
def test_bn128_tree_matches_jax(width, height):
    """Leaves, levels, root and the openings of open_many equal the JAX
    package's build_tree_bn128 / open (heights that leave a partial last
    group included); verify accepts them and refuses a changed value."""
    rng = np.random.default_rng(width * 100 + height)
    rows = rng.integers(0, (1 << 64) - (1 << 32), size=(height, width),
                        dtype=np.uint64)
    scheme = commitment.BN128Scheme()
    src = torch.from_numpy(rows.view(np.int64))
    tree = scheme.merkelize(src, width)
    jtree = jcommit.build_tree_bn128(rows)
    assert [from_words(lv) for lv in tree.levels] == jtree.levels
    root = scheme.root(tree)
    assert root == [jtree.root()]
    idxs = [0, height - 1, height // 2, 7 % height, 0]
    opened = scheme.open_many(tree, src, idxs)
    jscheme = jcommit.BN128Scheme()
    handle = jcommit.BN128Tree_Handle(jtree)
    for idx, (values, sibs) in zip(idxs, opened):
        jvalues, jsibs = jscheme.open(handle, rows, idx)
        assert (values, sibs) == (jvalues, jsibs)
        assert scheme.verify(root, idx, values, sibs)
        bad = list(values)
        bad[-1] = (bad[-1] + 1) % (1 << 64)
        assert not scheme.verify(root, idx, bad, sibs)
        assert not jscheme.verify(root, idx, bad, sibs)


def test_bn128_tree_of_width_zero():
    """A section of width 0 (an AIR without cm2) hashes every leaf to 0,
    as the JAX package's tree does."""
    rows = np.zeros((32, 0), dtype=np.uint64)
    tree = commitment.BN128Scheme().merkelize(
        torch.from_numpy(rows.view(np.int64)), 0)
    assert tree.root() == jcommit.build_tree_bn128(rows).root()
    assert not tree.levels[0].any()


def test_transcript_bn128_matches_jax():
    """A seeded put/get script: the first draw before any input (the
    out = [0] quirk), partial and full pending blocks, 253-bit fields,
    Goldilocks triples and query indices."""
    rng = np.random.default_rng(9)
    ours, theirs = commitment.TranscriptBN128(), jcommit.TranscriptBN128()
    outs = []
    for tr in (ours, theirs):
        got = [tr.get_fields1()]
        for n_put in (3, 16, 1, 40):
            vals = [int.from_bytes(rng.bytes(32), "little")
                    for _ in range(n_put)]
            tr.put(vals)
            got += [tr.get_field(), tr.get_fields253(), tr.get_fields1()]
        got.append(tr.get_permutations(7, 13))
        outs.append(got)
        rng = np.random.default_rng(9)
    assert outs[0] == outs[1]


def test_get_scheme():
    air = type("A", (), {"scheme": "bn128"})()
    assert isinstance(commitment.get_scheme(air), commitment.BN128Scheme)
    assert isinstance(commitment.get_scheme(object()), commitment.GLScheme)
    air.scheme = "kzg"
    with pytest.raises(ValueError):
        commitment.get_scheme(air)


# ---------------------------------------------------------------------------
# The fib proof over the bn128 scheme, and its R1CS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fib_bn128():
    air, _layout, const_np, cm1, publics = fixtures.fib_bn128_case(PORT)
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1, publics)
    return air, setup, proof


def test_fib_bn128_proof_is_the_jax_proof(fib_bn128):
    air, setup, proof = fib_bn128
    jair, _l, jconst, _cm1, _pub = fixtures.fib_bn128_case(JAX)
    assert setup.verkey == jprover.Setup.build(jair, jconst).verkey
    assert len(setup.verkey) == 1 and len(proof.roots[0]) == 1
    assert proof.to_json() == fixtures.read(FIB)
    assert verifier.verify(air, setup.verkey, proof)


@pytest.mark.parametrize("what", ["public", "root", "sibling"])
def test_fib_bn128_tampered_proof_refused(fib_bn128, what):
    air, setup, proof = fib_bn128
    bad = copy.deepcopy(proof)
    if what == "public":
        bad.publics[2] = (bad.publics[2] + 1) % prover.P
    elif what == "root":
        bad.roots[0][0] = (bad.roots[0][0] + 1) % P
    else:
        mp = bad.fri_steps[0].queries[0][0]
        mp.siblings[0][1] = (mp.siblings[0][1] + 1) % P
    with pytest.raises(verifier.VerifyError):
        verifier.verify(air, setup.verkey, bad)


@pytest.fixture(scope="module")
def fib_r1cs(fib_bn128):
    air, setup, proof = fib_bn128
    return final_circuit.build_final_circuit(air, setup.verkey, proof)


def test_final_circuit_matches_jax(fib_bn128, fib_r1cs):
    air, setup, proof = fib_bn128
    system, witness, _fb = fib_r1cs
    jair = fixtures.fib_bn128_case(JAX)[0]
    jsystem, jwitness, _jfb = jfc.build_final_circuit(
        jair, setup.verkey, JStarkProof.from_json(proof.to_json()))
    assert (system.n_public, system.n_wires) == \
        (jsystem.n_public, jsystem.n_wires)
    assert system.constraints == jsystem.constraints
    assert witness == jwitness
    assert r1cs.check_witness(system, witness)
    assert witness[1:1 + system.n_public] == proof.publics == [1, 1, 1597]


def test_final_circuit_refuses_tampered_proof(fib_bn128):
    air, setup, proof = fib_bn128
    bad = copy.deepcopy(proof)
    bad.evals[0][0] = (bad.evals[0][0] + 1) % prover.P
    with pytest.raises(AssertionError):
        final_circuit.build_final_circuit(air, setup.verkey, bad)


def test_check_witness_refuses_a_changed_wire(fib_r1cs):
    system, witness, _fb = fib_r1cs
    bad = list(witness)
    bad[-1] = (bad[-1] + 1) % P
    assert not r1cs.check_witness(system, bad)


class _Engine:
    """A stand-in for the stack's engines over the fib bn128 proof: a
    verifier that accepts, and a "RecursiveF" whose proof is the fib
    proof (its AIR is the bn128 fib AIR)."""

    def __init__(self, air, setup, proof):
        self.air, self.setup, self.verkey = air, setup, setup.verkey
        self.proof = proof
        self.proved = []

    def verify(self, _proof):
        return True

    def prove(self, inner, timings=None):
        self.proved.append(inner)
        return self.proof


def test_finalize_groth16_r1cs_contract(fib_bn128):
    """finalize(wrap="groth16", snark=False) proves with the cached
    ("recF", level) engine, builds the final circuit over its proof,
    checks the witness and returns the R1CS publics and the proof."""
    air, setup, proof = fib_bn128
    st = stack.RecursionStack(air, setup.verkey, device="cpu")
    eng = _Engine(air, setup, proof)
    st._rec1 = st._rec2 = eng
    st._aux[("recF", 2)] = eng
    rp = stack.RecursiveProof(level=2, proof=proof)
    timings = {}
    out = st.finalize(rp, wrap="groth16", snark=False, timings=timings)
    assert eng.proved == [proof]
    assert out["final"] == "r1cs" and out["proof"] is proof
    assert out["publics"] == [1, 1, 1597]
    assert out["n_constraints"] == 93327
    assert set(timings) == {"r1cs_s", "check_s"}
    with pytest.raises(ValueError, match="wrap"):
        st.finalize(rp, wrap="plonk")


def test_recursive_f_defaults_to_the_card():
    """RecursiveF is recursive1 over bn128; device=None means the card, so
    without one it refuses before any work."""
    assert issubclass(engine.RecursiveF, engine.Recursive1)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.RecursiveF(None, [0, 0, 0, 0])


def test_recf_devnet_fixture_publics():
    """The committed devnet RecursiveF proof carries the root's publics
    behind the leaf marker: the 52 groth16_publics of the JAX cascade."""
    proof = StarkProof.from_json(fixtures.read(RECF_DEVNET))
    with open(os.path.join(fixtures.ROOT, "PROOF_a7_cascade_devnet.json")) \
            as f:
        want = [int(v) for v in json.load(f)["groth16_publics"]]
    root = fixtures.devnet_root_proof(PORT)
    assert proof.publics == [0] * 4 + root.publics == want
    assert len(proof.roots[0]) == 1


# ---------------------------------------------------------------------------
# Slow tier
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_recursive_f_over_fib_rec1_on_cpu():
    """finalize(wrap="groth16", snark=False) on a CPU stack over the fib
    AIR, given the committed fib recursive1 proof: RecursiveF over
    recursive1 (2^15 rows), byte-equal to the JAX package's RecursiveF
    proof of the same input, verified; the R1CS publics are the leaf
    marker and the recursive1 publics."""
    from xlayer_prover_tpu.recursion import engine as jengine
    air, setup, inner = fixtures.fib_inner(PORT)
    rec1_text = fixtures.read("rec1_fib_n13_q4")
    st = stack.RecursionStack(air, setup.verkey, n_queries=4, device="cpu")
    # recursive1 at its own minimal domain (2^13), the fixture's geometry
    st._rec1 = engine.Recursive1(air, setup.verkey, n_queries=4,
                                 device="cpu")
    rp = stack.RecursiveProof(level=1, proof=StarkProof.from_json(rec1_text))
    out = st.finalize(rp, wrap="groth16", snark=False)
    recf = st._aux[("recF", 1)]
    assert recf.air.scheme == "bn128" and recf.air.n_bits == 15
    assert recf.verify(out["proof"])
    assert out["publics"] == [0] * 4 + rp.proof.publics
    jrecf = jengine.RecursiveF(
        fixtures.rec1_fib_case(JAX, (setup.verkey, inner.to_json()))[0],
        st.rec1().verkey, n_queries=4)
    assert jrecf.setup.verkey == recf.setup.verkey
    jproof = jrecf.prove(JStarkProof.from_json(rec1_text))
    assert out["proof"].to_json() == jproof.to_json()


@pytest.mark.slow
@pytest.mark.parametrize("name", [FIB, RECF_DEVNET])
def test_bn128_fixtures_are_the_jax_proofs(name):
    assert fixtures.jax_proof(name) == fixtures.read(name)
