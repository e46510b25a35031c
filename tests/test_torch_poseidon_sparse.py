"""The Poseidon kernels' algorithm on the CPU: the sparse partial rounds,
lazy limb sums and non-canonical intermediates of
xlayer_prover_tpu_torch/csrc/poseidon_gl.cu, as their plain model
``_permute_sparse_plain`` over the packed constant table the kernels read,
against the dense permutation, the host permutation and the JAX package;
and Merkle levels hashed as width-8 linear hashes of the level's free
(n/2, 8) view, as the ``poseidon_linear_hash`` kernel hashes them.  Exact
equality throughout."""

import numpy as np
import pytest
import torch

from xlayer_prover_tpu.fields import gl as jgl
from xlayer_prover_tpu.ops import merkle as jmerkle
from xlayer_prover_tpu.ops import poseidon_gl as jposeidon
from xlayer_prover_tpu_torch.fields import gl
from xlayer_prover_tpu_torch.ops import merkle, poseidon_constants, poseidon_gl

from tests.torch_cpu import one_torch_thread  # noqa: F401

P = gl.P
CPU = torch.device("cpu")


def _t(a):
    return gl.from_u64_np(a, CPU)


def _states(rng, n):
    """Seeded states led by edge rows and non-canonical rows."""
    s = rng.integers(0, P, size=(n, 12), dtype=np.uint64)
    edges = [[0] * 12, [1] * 12, [P - 1] * 12, [P + k for k in range(12)],
             [(1 << 64) - 1 - k for k in range(12)], [1 << 63] * 12,
             [(1 << 32) - 1] * 12, [1 << 32] * 12]
    s[:len(edges)] = edges
    s[len(edges):len(edges) + 32] = rng.integers(
        P, (1 << 64) - 1, size=(32, 12), dtype=np.uint64, endpoint=True)
    return s


def test_sparse_model_matches_dense_and_host(rng):
    states = _states(rng, 256)
    got = poseidon_gl._permute_sparse_plain(_t(states))
    assert torch.equal(got, poseidon_gl._permute_plain(_t(states)))
    got = gl.to_u64_np(got)
    for i in [0, 3, 4, 5, 6, 7, 8, 20, 255]:
        assert [int(v) for v in got[i]] == poseidon_gl.host_permute(
            [int(v) for v in states[i]]), i


def test_sparse_model_matches_jax(rng):
    states = _states(rng, 64)
    got = gl.to_u64_np(poseidon_gl._permute_sparse_plain(_t(states)))
    exp = jgl.to_u64_np(jposeidon.permute_u64(jgl.from_u64_np(states)))
    assert np.array_equal(got, exp)


def test_kernel_constants_hold_the_sparse_form():
    """The packed table has the layout's size, and its limbs and halves
    give back the sparse form's constants (and w' = 2^32 w mod p)."""
    table = poseidon_gl.kernel_constants()
    assert table.dtype == np.uint32
    assert table.size == sum(int(np.prod(shape)) for _, shape
                             in poseidon_gl.KERNEL_LAYOUT)
    k = {n: t.numpy() for n, t in poseidon_gl._kernel_tables(CPU).items()}
    sf = poseidon_constants.sparse_form()

    def limbs(ws):
        return int(ws[0]) + (int(ws[1]) << 22) + (int(ws[2]) << 44)

    def term(ws, w):
        assert limbs(ws[:3]) == w and limbs(ws[3:]) == (w << 32) % P

    assert [[int(lo) + (int(hi) << 32) for lo, hi in row]
            for row in k["full_c"]] == [list(r) for r in sf.full_c]
    assert [limbs(c) for c in k["first_c"]] == list(sf.first_c)
    _, mds = poseidon_constants.get_params()
    assert np.array_equal(poseidon_gl.kernel_constants()[-288:].view(
        np.float64).reshape(12, 12), np.array(mds, dtype=np.float64))
    for i in range(12):
        for j in range(12):
            term(k["pre"][j][i], sf.pre[i][j])
    next_c0 = list(sf.lane0_c[1:]) + [0]
    for row, c0, (m00, v, w_hat) in zip(k["partial"], next_c0, sf.sparse):
        assert [int(row[2 * i]) + (int(row[2 * i + 1]) << 32)
                for i in range(11)] == list(v)
        assert limbs(row[22:25]) == c0 and row[25] == 0
        for t, w in zip(row[26:].reshape(12, 6), list(w_hat) + [m00]):
            term(t, w)


@pytest.mark.parametrize("width", [0, 3, 8, 9])
def test_merkelize_level_view_matches_jax(rng, width):
    rows = rng.integers(0, P, size=(16, width), dtype=np.uint64)
    tree = merkle.merkelize(_t(rows), width)
    jtree = jmerkle.merkelize(jgl.from_u64_np(rows), width)
    assert len(tree.levels) == len(jtree.levels) == 5
    for lv, jlv in zip(tree.levels, jtree.levels):
        assert lv.is_contiguous()
        assert np.array_equal(gl.to_u64_np(lv), jgl.to_u64_np(jlv))


def test_level_view_is_hash_node(rng):
    digests = rng.integers(0, P, size=(64, 4), dtype=np.uint64)
    level = _t(digests)
    got = gl.to_u64_np(poseidon_gl.linear_hash(level.view(-1, 8), 8))
    j = jgl.from_u64_np(digests)
    exp = jgl.to_u64_np(jposeidon.hash_node(j[0::2], j[1::2]))
    assert np.array_equal(got, exp)


def test_linear_hash_rejects_wrong_width():
    with pytest.raises(ValueError):
        poseidon_gl.linear_hash(gl.zeros((4, 9), CPU), 8)
