"""Port parity: Goldilocks and GF(p^3) ops of xlayer_prover_tpu_torch
against the JAX package, on the same numpy inputs; exact equality.

On the CPU the port runs its plain PyTorch versions; the kernels are held
against them on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from xlayer_prover_tpu.fields import gl as jgl
from xlayer_prover_tpu.fields import gl3 as jgl3
from xlayer_prover_tpu_torch import device as tdev
from xlayer_prover_tpu_torch.fields import gl, gl3

from tests.torch_cpu import one_torch_thread  # noqa: F401

P = gl.P
CPU = torch.device("cpu")
# tests/test_gl.py's edge values: 0, 1, p-1, p-2, 2^32-1, 2^32, 2^63, and a
# non-canonical value in [p, 2^64)
EDGES = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, 1 << 63,
                  (1 << 64) - (1 << 32), P, (1 << 64) - 1], dtype=np.uint64)


def _vals(rng, n, edges=True):
    v = rng.integers(0, P, size=n, dtype=np.uint64)
    if edges:
        v[:len(EDGES)] = EDGES
    return v


def _t(a):
    return gl.from_u64_np(a, CPU)


def _j(a):
    return jgl.from_u64_np(a)


def test_u64_roundtrip(rng):
    v = _vals(rng, 64)
    assert np.array_equal(gl.to_u64_np(_t(v)), v)
    for x in [0, 1, P - 1, 1 << 63, (1 << 64) - 1]:
        assert np.array([tdev.i64(x)], dtype=np.int64).view(np.uint64)[0] == x


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert tdev.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tdev.resolve(None)
    assert tdev.resolve("cpu") == CPU


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(rng, op):
    a = _vals(rng, 512)
    b = _vals(rng, 512, edges=False)
    b[len(EDGES):2 * len(EDGES)] = EDGES          # edge x edge pairs
    a[len(EDGES):2 * len(EDGES)] = EDGES[::-1]
    got = gl.to_u64_np(getattr(gl, op)(_t(a), _t(b)))
    exp = jgl.to_u64_np(getattr(jgl, op)(_j(a), _j(b)))
    assert np.array_equal(got, exp)


def test_neg_mul_const_exp_match_jax(rng):
    a = _vals(rng, 256)
    assert np.array_equal(gl.to_u64_np(gl.neg(_t(a))),
                          jgl.to_u64_np(jgl.neg(_j(a))))
    for c in [0, 1, 7, P - 1, 1 << 40]:
        assert np.array_equal(gl.to_u64_np(gl.mul_const(_t(a), c)),
                              jgl.to_u64_np(jgl.mul_const(_j(a), c)))
    assert np.array_equal(gl.to_u64_np(gl.exp_const(_t(a), 12345)),
                          jgl.to_u64_np(jgl.exp_const(_j(a), 12345)))


def test_mul_broadcasts_scalar(rng):
    a = _vals(rng, 64)
    s = gl.from_u64_np(np.array(P - 5, dtype=np.uint64), CPU)
    exp = np.array([(int(x) * (P - 5)) % P for x in a], dtype=np.uint64)
    assert np.array_equal(gl.to_u64_np(gl.mul(_t(a), s)), exp)
    assert np.array_equal(gl.to_u64_np(gl.mul(s, _t(a))), exp)


def test_inv_batch_inv_match_jax(rng):
    a = _vals(rng, 300)
    a[50] = 0
    assert np.array_equal(gl.to_u64_np(gl.inv(_t(a))),
                          jgl.to_u64_np(jgl.inv(_j(a))))
    canon = a.copy()
    canon[canon >= np.uint64(P)] = 3              # batch_inv takes canonical
    assert np.array_equal(gl.to_u64_np(gl.batch_inv(_t(canon))),
                          jgl.to_u64_np(jgl.batch_inv(_j(canon))))


@pytest.mark.parametrize("n", [1, 5, 64, 300])
def test_sum_axis_powers_match_jax(rng, n):
    a = _vals(rng, n, edges=n >= len(EDGES))
    assert gl.to_u64_np(gl.sum_axis(_t(a))) == jgl.to_u64_np(jgl.sum_axis(_j(a)))
    got = gl.to_u64_np(gl.powers_device(12345, n, CPU, start=7))
    exp = jgl.to_u64_np(jgl.powers_device(12345, n, start=7))
    assert np.array_equal(got, exp)


def _t3(a):
    return gl3.from_u64_np(a, CPU)


def test_gl3_mul_ops_match_jax(rng):
    a = rng.integers(0, P, size=(256, 3), dtype=np.uint64)
    b = rng.integers(0, P, size=(256, 3), dtype=np.uint64)
    a[:len(EDGES), 0] = EDGES
    b[:len(EDGES), 2] = EDGES
    ja, jb = jgl3.from_u64_np(a), jgl3.from_u64_np(b)
    assert np.array_equal(gl3.to_u64_np(gl3.mul(_t3(a), _t3(b))),
                          jgl3.to_u64_np(jgl3.mul(ja, jb)))
    assert np.array_equal(
        gl3.to_u64_np(gl3.mul_base(_t3(a), _t(b[:, 1]))),
        jgl3.to_u64_np(jgl3.mul_base(ja, jgl.from_u64_np(b[:, 1]))))
    for fn in ("add", "sub"):
        assert np.array_equal(
            gl3.to_u64_np(getattr(gl3, fn)(_t3(a), _t3(b))),
            jgl3.to_u64_np(getattr(jgl3, fn)(ja, jb)))


def test_gl3_inv_batch_inv_match_jax(rng):
    a = rng.integers(0, P, size=(200, 3), dtype=np.uint64)
    a[0] = [5, 0, 0]
    a[1] = [0, 1, 0]
    a[7] = [0, 0, 0]
    ja = jgl3.from_u64_np(a)
    assert np.array_equal(gl3.to_u64_np(gl3.inv(_t3(a[8:]))),
                          jgl3.to_u64_np(jgl3.inv(jgl3.from_u64_np(a[8:]))))
    assert np.array_equal(gl3.to_u64_np(gl3.batch_inv(_t3(a))),
                          jgl3.to_u64_np(jgl3.batch_inv(ja)))


def test_gl3_powers_take_cols_match_jax(rng):
    x = [int(v) for v in rng.integers(0, P, size=3, dtype=np.uint64)]
    got = gl3.powers_device(gl3.from_ints(*x, CPU), 37)
    exp = jgl3.powers_device(jgl3.from_ints(*x), 37)
    assert np.array_equal(gl3.to_u64_np(got), jgl3.to_u64_np(exp))
    idx = np.array([3, 0, 36, 5])
    taken = gl3.take(got, torch.from_numpy(idx))
    assert np.array_equal(gl3.to_u64_np(taken),
                          jgl3.to_u64_np(jgl3.take(exp, idx)))
    cols = gl3.stack_cols(got)
    assert tuple(cols.shape) == (37, 3)
    assert np.array_equal(gl3.to_u64_np(gl3.from_cols(cols)),
                          gl3.to_u64_np(got))
