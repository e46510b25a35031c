"""Port parity: plookup split, FRI fold, transcript and whole proofs of
xlayer_prover_tpu_torch against the JAX package; exact equality.

The proofs must be byte-equal (``StarkProof.to_json()``) and verify under
both verifiers."""

import numpy as np
import pytest
import torch

from xlayer_prover_tpu.fields import gl as jgl
from xlayer_prover_tpu.fields import gl3 as jgl3
from xlayer_prover_tpu.models.toy import fib as jfib
from xlayer_prover_tpu.stark import fri as jfri
from xlayer_prover_tpu.stark import lookup as jlookup
from xlayer_prover_tpu.stark import prover as jprover
from xlayer_prover_tpu.stark import verifier as jverifier
from xlayer_prover_tpu.stark.air import AirBuilder as JAirBuilder
from xlayer_prover_tpu.stark.transcript import Transcript as JTranscript
from xlayer_prover_tpu_torch.fields import gl, gl3
from xlayer_prover_tpu_torch.models.toy import fib
from xlayer_prover_tpu_torch.stark import fri, lookup, prover, verifier
from xlayer_prover_tpu_torch.stark.air import AirBuilder
from xlayer_prover_tpu_torch.stark.transcript import Transcript

from tests.torch_cpu import one_torch_thread  # noqa: F401

P = gl.P
CPU = torch.device("cpu")


def _lookup_case(rng, n, dim, dup_heavy=False):
    t = rng.integers(0, 50 if dup_heavy else 1 << 62, size=(n, dim),
                     dtype=np.uint64)
    t[: n // 8, 0] |= np.uint64(1 << 63)          # keys >= 2^63 (sign bit)
    f = t[rng.integers(0, n, size=n)]
    return f, t


@pytest.mark.parametrize("n,dim,dup", [(64, 1, False), (128, 3, False),
                                       (256, 3, True)])
def test_h1h2_matches_jax_and_host(rng, n, dim, dup):
    import jax.numpy as jnp
    f, t = _lookup_case(rng, n, dim, dup)
    h1, h2, bad = lookup.calculate_h1h2_device(gl.from_u64_np(f, CPU),
                                               gl.from_u64_np(t, CPU))
    assert int(bad) == 0
    j1, j2, jbad = jlookup.calculate_h1h2_device(jnp.asarray(f),
                                                 jnp.asarray(t))
    assert int(jbad) == 0
    e1, e2 = jlookup.calculate_h1h2(f.copy(), t.copy())
    for got, jexp, exp in ((h1, j1, e1), (h2, j2, e2)):
        assert np.array_equal(gl.to_u64_np(got), np.asarray(jexp))
        assert np.array_equal(gl.to_u64_np(got), exp)


def test_h1h2_counts_missing_f(rng):
    import jax.numpy as jnp
    f, t = _lookup_case(rng, 64, 3)
    f = f.copy()
    f[17] = [1, 2, 3]
    f[40] = [(1 << 64) - 1, 0, 5]
    _h1, _h2, bad = lookup.calculate_h1h2_device(gl.from_u64_np(f, CPU),
                                                 gl.from_u64_np(t, CPU))
    _j1, _j2, jbad = jlookup.calculate_h1h2_device(jnp.asarray(f),
                                                   jnp.asarray(t))
    assert int(bad) == int(jbad) == 2


@pytest.mark.parametrize("bits,bits_next", [(6, 4), (8, 5), (5, 5 - 2)])
def test_fri_fold_and_transpose_match_jax(rng, bits, bits_next):
    vals = rng.integers(0, P, size=(1 << bits, 3), dtype=np.uint64)
    sx = [int(v) for v in rng.integers(0, P, size=3, dtype=np.uint64)]
    shift_inv = jgl.host_inv(jgl.SHIFT)
    w_inv = jgl.host_inv(jgl.host_w(bits))
    got = fri.fold(gl3.from_u64_np(vals, CPU), gl3.from_ints(*sx, CPU),
                   shift_inv, w_inv, bits, bits_next)
    exp = jfri.fold(jgl3.from_u64_np(vals), jgl3.from_ints(*sx), shift_inv,
                    w_inv, bits, bits_next)
    assert np.array_equal(gl3.to_u64_np(got), jgl3.to_u64_np(exp))
    tt = fri.transpose_for_tree(gl3.from_u64_np(vals, CPU), bits, bits_next)
    jt = jfri.transpose_for_tree(jgl3.from_u64_np(vals), bits, bits_next)
    assert np.array_equal(gl.to_u64_np(tt), np.asarray(jt))


def test_transcript_matches_jax():
    a, b = Transcript(), JTranscript()
    for tr in (a, b):
        tr.put([1, 2, 3, P + 5])
        tr.put(list(range(11)))
    for _ in range(5):
        assert a.get_field() == b.get_field()
    a.put([9])
    b.put([9])
    assert a.get_permutations(8, 21) == b.get_permutations(8, 21)


def test_domain_helpers_match_jax():
    air = fib.build_air(n_bits=5, n_queries=8)
    jair = jfib.build_air(n_bits=5, n_queries=8)
    assert np.array_equal(gl.to_u64_np(prover._l1_values_ext(air, CPU)),
                          jgl.to_u64_np(jprover._l1_values_ext(jair)))
    assert np.array_equal(gl.to_u64_np(prover._zi_values_ext(air, CPU)),
                          jgl.to_u64_np(jprover._zi_values_ext(jair)))
    assert np.array_equal(
        gl.to_u64_np(prover._domain_x(air.n_bits_ext, CPU, shift=gl.SHIFT)),
        jgl.to_u64_np(jprover._domain_x(jair.n_bits_ext, shift=jgl.SHIFT)))


def test_exclusive_prefix_product_matches_jax(rng):
    r = rng.integers(0, P, size=(100, 3), dtype=np.uint64)
    got = prover._exclusive_prefix_product(gl3.from_u64_np(r, CPU))
    exp = jprover._exclusive_prefix_product(jgl3.from_u64_np(r))
    assert np.array_equal(gl3.to_u64_np(got), jgl3.to_u64_np(exp))


@pytest.fixture(scope="module")
def fib_pair():
    air = fib.build_air(n_bits=5, n_queries=8)
    const_np, cm1_np, publics = fib.gen_trace(air)
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1_np, publics)
    jair = jfib.build_air(n_bits=5, n_queries=8)
    jconst, jcm1, jpub = jfib.gen_trace(jair)
    assert np.array_equal(jconst, const_np) and np.array_equal(jcm1, cm1_np)
    jsetup = jprover.Setup.build(jair, jconst)
    jproof = jprover.gen_proof(jsetup, jcm1, jpub)
    return air, setup, proof, cm1_np, publics, jair, jsetup, jproof


def test_fib_proof_byte_equal_and_verifies(fib_pair):
    air, setup, proof, _cm1, _pub, jair, jsetup, jproof = fib_pair
    assert setup.verkey == jsetup.verkey
    assert proof.to_json() == jproof.to_json()
    assert jverifier.verify(jair, setup.verkey, proof)
    assert verifier.verify(air, setup.verkey, proof)


def test_fib_tampered_trace_fails(fib_pair):
    air, setup, _proof, cm1_np, publics, *_ = fib_pair
    bad = cm1_np.copy()
    bad[3, 1] = (bad[3, 1] + 1) % P            # break the fibonacci step
    proof = prover.gen_proof(setup, bad, publics)
    with pytest.raises(verifier.VerifyError):
        verifier.verify(air, setup.verkey, proof)


def _connection_case(builder_cls, n_bits=4):
    """A 5-column connection (split into committed im columns) with the
    identity wiring and a 2-column connection with one 2-cycle."""
    b = builder_cls("conn", n_bits, n_queries=4, fri_fold_bits=2)
    c = [b.witness(f"c{j}") for j in range(5)]
    d = [b.witness(f"d{j}") for j in range(2)]
    sc = [b.fixed(f"SC{j}") for j in range(5)]
    sd = [b.fixed(f"SD{j}") for j in range(2)]
    k = [pow(7, j, P) for j in range(5)]
    b.connection(c, sc, k)
    b.connection(d, sd, k[:2])
    air = b.compile()
    n = air.n
    x = np.array([pow(gl.host_w(n_bits), i, P) for i in range(n)],
                 dtype=object)
    const_np = np.zeros((n, 7), dtype=np.uint64)
    for j in range(5):
        const_np[:, j] = [int(v) * k[j] % P for v in x]
    for j in range(2):
        const_np[:, 5 + j] = [int(v) * k[j] % P for v in x]
    const_np[1, 5] = k[1] * int(x[3]) % P      # cell (1, d0) <-> (3, d1)
    const_np[3, 6] = k[0] * int(x[1]) % P
    cm1 = np.random.default_rng(9).integers(0, P, size=(n, 7),
                                            dtype=np.uint64)
    cm1[3, 6] = cm1[1, 5]
    return air, const_np, cm1


def test_connection_proof_byte_equal_and_verifies():
    air, const_np, cm1 = _connection_case(AirBuilder)
    jair, _jconst, _jcm1 = _connection_case(JAirBuilder)
    assert air.connections[0].num_ims and not air.connections[1].num_ims
    setup = prover.Setup.build(air, const_np, device="cpu")
    proof = prover.gen_proof(setup, cm1, [])
    jsetup = jprover.Setup.build(jair, const_np)
    assert proof.to_json() == jprover.gen_proof(jsetup, cm1, []).to_json()
    assert jverifier.verify(jair, jsetup.verkey, proof)
    assert verifier.verify(air, setup.verkey, proof)

    bad = cm1.copy()
    bad[3, 6] = (int(bad[3, 6]) + 1) % P        # break the copy constraint
    with pytest.raises(verifier.VerifyError):
        verifier.verify(air, setup.verkey,
                        prover.gen_proof(setup, bad, []))
