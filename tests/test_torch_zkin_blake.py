"""The port's zkin export (``stark/zkin.py``) and Blake2b-256
(``ops/blake2b.py``) against the JAX package's on the CPU, exactly.

zkin: the fib proof of tests/test_e2e_toy.py (n_bits 5, 8 queries),
proven by the port on the CPU (byte-equal to the JAX package's), through
``proof_to_zkin`` and ``joinzkin`` (plain and with the zkEVM chained
publics) equal to the JAX package's of its own proof.  Blake2b: the
reference's vectors (tests/test_blake.py), the stdlib oracle and the JAX
package's digests on seeded lengths around the 128-byte block.
"""

import hashlib
import random

import pytest

from xlayer_prover_tpu.models.toy import fib as jfib
from xlayer_prover_tpu.ops import blake2b as jblake
from xlayer_prover_tpu.stark import prover as jprover
from xlayer_prover_tpu.stark import zkin as jzkin
from xlayer_prover_tpu_torch.models.toy import fib
from xlayer_prover_tpu_torch.ops import blake2b
from xlayer_prover_tpu_torch.stark import prover, zkin

from tests.test_blake import VECTORS
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def fib_proofs():
    """(port air, port proof, port verkey, JAX air, JAX proof, JAX
    verkey) of the fib toy at n_bits 5, 8 queries."""
    jair = jfib.build_air(n_bits=5, n_queries=8)
    jconst, jcm1, jpub = jfib.gen_trace(jair)
    jsetup = jprover.Setup.build(jair, jconst)
    jproof = jprover.gen_proof(jsetup, jcm1, jpub)
    air = fib.build_air(n_bits=5, n_queries=8)
    const, cm1, pub = fib.gen_trace(air)
    setup = prover.Setup.build(air, const, device="cpu")
    proof = prover.gen_proof(setup, cm1, pub)
    return air, proof, setup.verkey, jair, jproof, jsetup.verkey


def test_fib_proof_is_the_jax_proof(fib_proofs):
    _air, proof, verkey, _jair, jproof, jverkey = fib_proofs
    assert proof.to_json() == jproof.to_json()
    assert [int(v) for v in verkey] == [int(v) for v in jverkey]


def test_proof_to_zkin_equals_jax(fib_proofs):
    air, proof, _vk, jair, jproof, _jvk = fib_proofs
    got = zkin.proof_to_zkin(air, proof)
    want = jzkin.proof_to_zkin(jair, jproof)
    assert got == want
    assert list(got) == list(want)            # the signals' order too
    assert got["root1"] == [str(v) for v in proof.roots[0]]
    assert len(got["s0_vals1"]) == air.n_queries


@pytest.mark.parametrize("chain", [False, True])
def test_joinzkin_equals_jax(fib_proofs, chain):
    air, proof, verkey, jair, jproof, jverkey = fib_proofs
    z = zkin.proof_to_zkin(air, proof)
    jz = jzkin.proof_to_zkin(jair, jproof)
    n_steps = len(proof.fri_steps)
    if chain:
        # the zkEVM layout reads 44 publics: pad the toy's
        for d in (z, jz):
            d["publics"] = d["publics"] + [str(i) for i in range(50)]
    got = zkin.joinzkin(z, dict(z), verkey, n_steps, chain_publics=chain)
    want = jzkin.joinzkin(jz, dict(jz), jverkey, n_steps,
                          chain_publics=chain)
    assert got == want
    assert list(got) == list(want)
    assert got["rootC"] == [str(v) for v in verkey]


def test_blake2b_reference_vectors():
    for inp, want in VECTORS:
        assert blake2b.blake2b_256_string(inp) == want, inp
        assert blake2b.blake2b_256_string(inp) == \
            jblake.blake2b_256_string(inp)


def test_blake2b_equals_jax_and_stdlib():
    rng = random.Random(20261018)
    for n in (0, 1, 64, 127, 128, 129, 255, 256, 257, 300, 1000):
        data = bytes(rng.randrange(256) for _ in range(n))
        got = blake2b.blake2b_256(data)
        assert got == jblake.blake2b_256(data), n
        assert got == hashlib.blake2b(data, digest_size=32).digest(), n
    assert blake2b.blake2b_256_string("") == jblake.blake2b_256_string("")
    assert blake2b.blake2b_256_string("00ff") == \
        jblake.blake2b_256_string("00ff")
