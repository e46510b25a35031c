"""Port parity: the miniature composite circuit (Main dispatch + Binary SM +
Memory SM in one AIR, ``models/zkevm/composite.py``) and a selected
permutation argument, proven by xlayer_prover_tpu_torch on the CPU.

The composite proof is byte-equal (``StarkProof.to_json()``) to the JAX
package's, committed as ``tests/data/composite_n11_q4.proof.json`` (the
slow test proves the case with the JAX package again and compares), and
verifies under both verifiers; a Main row claiming a result the Binary SM
never computed is refused.  The permutation AIR, small enough to prove
with both packages here, holds the selected permutation argument that
binds Main to Memory in the zkEVM circuit."""

import numpy as np
import pytest

from xlayer_prover_tpu.stark import prover as jprover
from xlayer_prover_tpu.stark import verifier as jverifier
from xlayer_prover_tpu.stark.air import AirBuilder as JAirBuilder
from xlayer_prover_tpu_torch.stark import prover, verifier
from xlayer_prover_tpu_torch.stark.air import AirBuilder

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

CASE = "composite_n11_q4"
P = prover.P


@pytest.fixture(scope="module")
def comp():
    return fixtures.composite_case("xlayer_prover_tpu_torch")


def test_composite_proof_byte_equal_and_verifies(comp):
    air, layout, const_np, cm1, _ = comp
    jair, _jl, jconst, jcm1, _ = fixtures.composite_case("xlayer_prover_tpu")
    assert np.array_equal(jconst, const_np) and np.array_equal(jcm1, cm1)
    assert air.cm1_width == jair.cm1_width and len(air.plookups) == 4
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1, [])
    assert proof.to_json() == fixtures.read(CASE)
    assert jverifier.verify(jair, setup.verkey, proof)
    assert verifier.verify(air, setup.verkey, proof)


def test_composite_rejects_false_claim(comp):
    """A main row claiming a result the Binary SM never computed fails."""
    air, layout, const_np, cm1, _ = comp
    bad = cm1.copy()
    bad[0, layout.main["c0"].index] ^= np.uint64(1)
    setup = prover.Setup.build(air, const_np, device="cpu")
    with pytest.raises(prover.LookupMissingError):
        prover.gen_proof(setup, bad, [])


@pytest.mark.slow
def test_composite_fixture_is_the_jax_proof():
    assert fixtures.jax_proof(CASE) == fixtures.read(CASE)


def _permutation_case(builder_cls, n_bits=5):
    """(a, b) on the selected rows 0..9 is a permutation of (c, d) on the
    selected rows 20..29; the other rows hold unrelated values."""
    b = builder_cls("perm", n_bits, n_queries=4, fri_fold_bits=2)
    cols = {k: b.witness(k) for k in ("a", "b", "c", "d", "fsel", "tsel")}
    for s in ("fsel", "tsel"):
        b.constrain(cols[s] * (cols[s] - 1))
    b.permutation([cols["a"], cols["b"]], [cols["c"], cols["d"]],
                  f_sel=cols["fsel"], t_sel=cols["tsel"])
    air = b.compile()
    rng = np.random.default_rng(31)
    cm1 = rng.integers(0, P, size=(air.n, 6), dtype=np.uint64)
    cm1[:, 4:] = 0
    pairs = cm1[0:10, 0:2].copy()
    cm1[20:30, 2:4] = pairs[rng.permutation(10)]
    cm1[0:10, 4] = 1
    cm1[20:30, 5] = 1
    return air, np.zeros((air.n, 0), dtype=np.uint64), cm1


def test_selected_permutation_proof_byte_equal_and_verifies():
    air, const_np, cm1 = _permutation_case(AirBuilder)
    jair, _jconst, _jcm1 = _permutation_case(JAirBuilder)
    assert len(air.permutations) == 1
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1, [])
    jsetup = jprover.Setup.build(jair, const_np)
    assert proof.to_json() == jprover.gen_proof(jsetup, cm1, []).to_json()
    assert jverifier.verify(jair, jsetup.verkey, proof)
    assert verifier.verify(air, setup.verkey, proof)

    bad = cm1.copy()
    bad[23, 2] = (int(bad[23, 2]) + 1) % P      # a t value no f row has
    with pytest.raises(verifier.VerifyError):
        verifier.verify(air, setup.verkey, prover.gen_proof(setup, bad, []))
