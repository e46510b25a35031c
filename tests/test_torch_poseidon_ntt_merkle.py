"""Port parity: Poseidon-GL permutation, NTT/LDE and Merkle trees of
xlayer_prover_tpu_torch against the JAX package; exact equality.

On the CPU the port runs its plain PyTorch versions; the kernels are held
against them on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from xlayer_prover_tpu.fields import gl as jgl
from xlayer_prover_tpu.ops import merkle as jmerkle
from xlayer_prover_tpu.ops import ntt as jntt
from xlayer_prover_tpu.ops import poseidon_gl as jposeidon
from xlayer_prover_tpu_torch.fields import gl
from xlayer_prover_tpu_torch.ops import (merkle, ntt, poseidon_constants,
                                         poseidon_gl)

from tests.torch_cpu import one_torch_thread  # noqa: F401

P = gl.P
CPU = torch.device("cpu")
EDGE_ROWS = np.array([[0] * 12, [1] * 12, [P - 1] * 12,
                      [P + k for k in range(12)],
                      [(1 << 64) - 1 - k for k in range(12)]],
                     dtype=np.uint64)


def _t(a):
    return gl.from_u64_np(a, CPU)


def _states(rng, n):
    s = rng.integers(0, P, size=(n, 12), dtype=np.uint64)
    s[:len(EDGE_ROWS)] = EDGE_ROWS
    return s


def test_permute_matches_jax_and_host(rng):
    states = _states(rng, 256)
    got = gl.to_u64_np(poseidon_gl.permute(_t(states)))
    exp = jgl.to_u64_np(jposeidon.permute_u64(jgl.from_u64_np(states)))
    assert np.array_equal(got, exp)
    for i in [0, 3, 4, 17, 255]:
        host = jmerkle._host_permute([int(v) for v in states[i]])
        assert [int(v) for v in got[i]] == host, i
        assert poseidon_gl.host_permute([int(v) for v in states[i]]) == host


def _permute_sparse(state):
    """The permutation through poseidon_constants.sparse_form (python ints)."""
    sf = poseidon_constants.sparse_form()
    _, mds = poseidon_constants.get_params()

    def full_round(s, c, m):
        s = [pow((x + y) % P, 7, P) for x, y in zip(s, c)]
        return [sum(s[i] * m[i][j] for i in range(12)) % P for j in range(12)]

    s = [x % P for x in state]
    for r in range(4):
        s = full_round(s, sf.full_c[r], sf.pre if r == 3 else mds)
    s = [(x + y) % P for x, y in zip(s, sf.first_c)]
    for c0, (m00, v, w_hat) in zip(sf.lane0_c, sf.sparse):
        s0 = pow((s[0] + c0) % P, 7, P)
        out0 = (s0 * m00 + sum(x * w for x, w in zip(s[1:], w_hat))) % P
        s = [out0] + [(x + s0 * vj) % P for x, vj in zip(s[1:], v)]
    for r in range(4, 8):
        s = full_round(s, sf.full_c[r], mds)
    return s


def test_sparse_form_is_the_permutation(rng):
    """The sparse partial-round form (the fewest-multiply algorithm that
    chip_smoke.py's poseidon bound counts) computes the same function."""
    sf = poseidon_constants.sparse_form()
    assert len(sf.sparse) == 22 and len(sf.full_c) == 8
    # the factors are dense field elements, not the MDS's small entries
    assert max(max(w_hat) for _, _, w_hat in sf.sparse) >= 1 << 32
    for s in _states(rng, 8):
        state = [int(v) for v in s]
        assert _permute_sparse(state) == jmerkle._host_permute(state)


@pytest.mark.slow
def test_permute_matches_pallas_interpret(rng):
    from xlayer_prover_tpu.ops import pallas_poseidon
    states = rng.integers(0, P, size=(128, 12), dtype=np.uint64)
    exp = np.asarray(pallas_poseidon.permute(jgl.from_u64_np(states), True,
                                             64))
    got = gl.to_u64_np(poseidon_gl.permute(_t(states)))
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("width", [1, 4, 5, 8, 9, 20, 39])
def test_linear_hash_matches_jax(rng, width):
    rows = rng.integers(0, P, size=(16, width), dtype=np.uint64)
    got = gl.to_u64_np(poseidon_gl.linear_hash(_t(rows), width))
    exp = jgl.to_u64_np(jposeidon.linear_hash(jgl.from_u64_np(rows), width))
    assert np.array_equal(got, exp)
    assert [int(v) for v in got[3]] == poseidon_gl.host_linear_hash(
        [int(v) for v in rows[3]])


@pytest.mark.parametrize("nbits,cols", [(1, 1), (4, 3), (7, 16), (10, 2),
                                        (12, 1)])
def test_ntt_intt_match_jax(rng, nbits, cols):
    vals = rng.integers(0, P, size=(1 << nbits, cols), dtype=np.uint64)
    j = jgl.from_u64_np(vals)
    assert np.array_equal(gl.to_u64_np(ntt.ntt(_t(vals))),
                          jgl.to_u64_np(jntt.ntt(j)))
    assert np.array_equal(gl.to_u64_np(ntt.intt(_t(vals))),
                          jgl.to_u64_np(jntt.intt(j)))


def test_ntt_1d_matches_jax(rng):
    vals = rng.integers(0, P, size=256, dtype=np.uint64)
    assert np.array_equal(gl.to_u64_np(ntt.ntt(_t(vals))),
                          jgl.to_u64_np(jntt.ntt(jgl.from_u64_np(vals))))


@pytest.mark.parametrize("nbits,nbits_ext,cols", [(3, 4, 1), (5, 7, 4),
                                                  (9, 10, 16), (11, 12, 3)])
def test_extend_pol_matches_jax(rng, nbits, nbits_ext, cols):
    vals = rng.integers(0, P, size=(1 << nbits, cols), dtype=np.uint64)
    got = gl.to_u64_np(ntt.extend_pol(_t(vals), nbits_ext))
    exp = jgl.to_u64_np(jntt.extend_pol(jgl.from_u64_np(vals), nbits_ext))
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("nbits,width", [(1, 3), (6, 9), (9, 39)])
def test_merkelize_levels_match_jax(rng, nbits, width):
    rows = rng.integers(0, P, size=(1 << nbits, width), dtype=np.uint64)
    tree = merkle.merkelize(_t(rows), width)
    jtree = jmerkle.merkelize(jgl.from_u64_np(rows), width)
    assert len(tree.levels) == len(jtree.levels) == nbits + 1
    for lv, jlv in zip(tree.levels, jtree.levels):
        assert np.array_equal(gl.to_u64_np(lv), jgl.to_u64_np(jlv))
    assert np.array_equal(tree.root_np(), jtree.root_np())

    idxs = [0, (1 << nbits) - 1, 1 % (1 << nbits)]
    paths = merkle.get_proofs_batch(tree, idxs)
    assert np.array_equal(paths, jmerkle.get_proofs_batch(jtree, idxs))
    got_rows = merkle.gather_rows(_t(rows), idxs)
    assert np.array_equal(got_rows, rows[idxs])
    for k, i in enumerate(idxs):
        assert merkle.verify_proof(tree.root_np(), i, got_rows[k], paths[k])
        assert [list(p) for p in merkle.get_proof(tree, i)] == \
            [list(p) for p in paths[k]]
    bad = got_rows[0].copy()
    bad[0] ^= np.uint64(1)
    assert not merkle.verify_proof(tree.root_np(), idxs[0], bad, paths[0])
