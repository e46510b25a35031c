"""Port parity: the MSM kernels' schedule (``ops/bn254_msm.py``) against
the JAX package's native Pippenger (``xlayer_prover_tpu/native/msm.cpp``
``msm_g1`` / ``msm_g2``), exact equality in affine.

The signed c-bit digits recombine to the scalar at every window width;
the keys, the sort and every launch size depend on n and c alone (the
CPU's check that the path needs no host sync); the step-by-step model
``_msm_model`` (signed digits, chunks and their edge items level by
level, the running sums' levels, the window tree, the combination) equals
the native MSM on inputs with every edge of ``bn254_msm.msm_cases``; the
schedule's constants equal ``csrc/bn254_msm.cuh``'s.  The kernels are held
against the same model and the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import os
import random
import re

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from xlayer_prover_tpu import native
from xlayer_prover_tpu.fields import bn254 as jbn
from xlayer_prover_tpu.fields import bn254_tower as jtower
from xlayer_prover_tpu_torch.fields import bn254
from xlayer_prover_tpu_torch.ops import bn254_mont, bn254_msm

from tests.torch_cpu import one_torch_thread  # noqa: F401

R = bn254.R
CUH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "xlayer_prover_tpu_torch", "csrc", "bn254_msm.cuh")
WIDTHS = range(2, bn254_msm.MAX_WINDOW_BITS + 1)


def words(values):
    return torch.from_numpy(bn254_mont.to_words(values))


def recombine(digits, i: int, c: int) -> int:
    return sum(int(d) << (c * w) for w, d in enumerate(digits[:, i]))


def edge_scalars(c: int) -> list:
    """0, 1, r - 1, r - 2, 2^253, every window at 2^(c - 1) and at
    2^(c - 1) + 1 (digits +2^(c - 1) and, carried, -(2^(c - 1) - 1)),
    every window at 2^c - 1 (a carry through every window into the top
    one), and 2^254 - 1 (read below 2^254: the top carry at its most)."""
    full = range(0, bn254_msm.SCALAR_BITS, c)
    half = 1 << (c - 1)
    return [0, 1, R - 1, R - 2, 1 << 253,
            sum(half << w for w in full) % (1 << 254),
            sum((half + 1) << w for w in full) % (1 << 254),
            sum(((1 << c) - 1) << w for w in full) % (1 << 254),
            (1 << 254) - 1]


@pytest.mark.parametrize("c", WIDTHS)
def test_signed_digits_recombine_at_every_width(c):
    ks = edge_scalars(c)
    d = bn254_msm.signed_digits(words(ks), c)
    half = 1 << (c - 1)
    assert d.shape == (bn254_msm.n_windows(c), len(ks))
    assert int(d.max()) <= half and int(d.min()) > -half
    for i, k in enumerate(ks):
        assert recombine(d, i, c) == k, (c, i)
    # the window at 2^(c - 1) keeps the digit 2^(c - 1), the one at
    # 2^(c - 1) + 1 becomes -(2^(c - 1) - 1) with a carry
    assert int(d[0, 5]) == half and int(d[0, 6]) == 1 - half
    # scalars below r need no window above ceil(255 / c)
    assert bn254_msm.n_windows(c) * c >= bn254_msm.SCALAR_BITS + 1


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, (1 << 254) - 1), min_size=1, max_size=8),
       st.integers(2, bn254_msm.MAX_WINDOW_BITS))
def test_signed_digits_recombine_hypothesis(ks, c):
    d = bn254_msm.signed_digits(words(ks), c)
    half = 1 << (c - 1)
    assert int(d.max()) <= half and int(d.min()) > -half
    assert [recombine(d, i, c) for i in range(len(ks))] == ks


def test_keys_hold_window_digit_and_sign():
    """Key 2 (w 2^(c - 1) + |d| - 1) + (d < 0) for each digit; MSM_NONE
    for zero digits and for every digit of a point at infinity."""
    c, n = 5, 4
    pts, sc = bn254_msm.msm_cases("g1", 24, 1, c)
    pts, sc = pts[2:2 + n], sc[2:2 + n]               # r - 1, infinity, ..
    x = torch.from_numpy(bn254_msm.g1_words(pts))
    keys = bn254_msm.msm_keys(x, words(sc), c)
    d = bn254_msm.signed_digits(words(sc), c)
    assert keys.dtype == torch.int32 and keys.shape == (d.numel(),)
    for w in range(d.shape[0]):
        for i in range(n):
            k, dd = int(keys[w * n + i]), int(d[w, i])
            if dd == 0 or pts[i] is None:
                assert k == bn254_msm.MSM_NONE
            else:
                assert k == 2 * ((w << (c - 1)) + abs(dd) - 1) + (dd < 0)


@pytest.mark.parametrize("n,c", [(1, 2), (37, 3), (200, 5), (1000, 10),
                                 (1 << 20, 16)])
def test_schedule_shapes_depend_on_n_and_c_alone(n, c):
    """Two scalar sets of one n (all zero, all distinct) give keys and
    sorted schedules of the same shapes, and msm_plan is a function of
    (n, c): the CPU's check that nothing on the path waits for the host
    to learn a size.  The plan's levels close: one chunk at the last
    level, one segment at the last running-sum level, one tree item."""
    plan = bn254_msm.msm_plan(n, c)
    assert plan == bn254_msm.msm_plan(n, c)
    assert plan["entries"] == bn254_msm.n_windows(c) * n
    assert plan["buckets"] == bn254_msm.n_windows(c) << (c - 1)
    assert plan["chunks"][-1] <= 1 and plan["run_groups"][-1] == 1
    assert plan["tree"][0] == sum(plan["run_groups"])
    assert plan["tree"][-1] == 1
    if n > 1 << 12:
        return
    rng = random.Random(n)
    x = torch.from_numpy(bn254_msm.g1_words(
        [(1, 2)] * n))                           # G1's generator n times
    shapes = []
    for ks in ([0] * n, [rng.randrange(R) for _ in range(n)]):
        keys = bn254_msm.msm_keys(x, words(ks), c)
        sorted_keys, index = bn254_msm.msm_schedule(keys)
        shapes.append((keys.shape, sorted_keys.shape, index.shape,
                       keys.dtype, index.dtype))
        assert bool((sorted_keys[1:] >= sorted_keys[:-1]).all())
    assert shapes[0] == shapes[1]
    assert shapes[0][0] == (plan["entries"],)


def _native(group, pts, sc):
    """The JAX package's MSM in affine: its native Pippenger, or its
    Python one where the native library is not built."""
    if group == "g1":
        jac = native.msm_g1(pts, sc)
        if jac is None:
            pairs = [(p, k % R) for p, k in zip(pts, sc) if p is not None]
            jac = jbn.msm([p for p, _ in pairs], [k for _, k in pairs])
        return jbn.g1_to_affine(jac)
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
    return (jtower.fq2_mul(x, zi2), jtower.fq2_mul(y, jtower.fq2_mul(zi2,
                                                                     zi)))


def _model(group, pts, sc, c):
    F = bn254_msm.FQ1_OPS if group == "g1" else bn254_msm.FQ2_OPS
    x = bn254_msm.g1_words(pts) if group == "g1" else \
        bn254_msm.g2_words(pts)
    out = bn254_msm._msm_model(F, torch.from_numpy(x), words(sc), c)
    assert out.shape == (3, F.words)
    return getattr(bn254_msm, f"to_affine_{group}")(out)


@pytest.mark.parametrize("group,n,c", [
    ("g1", 160, 2), ("g1", 200, 3), ("g1", 256, 4), ("g1", 211, 5),
    ("g1", 150, 10), ("g2", 40, 2), ("g2", 48, 3), ("g2", 64, 4),
    ("g2", 41, 5)])
def test_model_matches_native(group, n, c):
    """Every edge of msm_cases (infinity, zero scalars, r - 1, a repeated
    point, P beside -P, one point under +d and -d in a window, digits
    2^(c - 1) and -(2^(c - 1) - 1) in every window, a bucket of half the
    points across chunks, empty buckets and windows); n of 200, 211, 150,
    48 and 41 end in a ragged chunk; c = 10 runs three running-sum levels
    and a two-level window tree."""
    pts, sc = bn254_msm.msm_cases(group, n, 20261017 + c, c)
    plan = bn254_msm.msm_plan(n, c)
    assert len(plan["chunks"]) >= 3           # edge items over levels
    assert _model(group, pts, sc, c) == _native(group, pts, sc)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_model_small_sets(group):
    """n = 1 (r - 1 times a point) and, over G1, scalars that are all zero
    (8-bit windows): each equals the native MSM."""
    pts, sc = bn254_msm.msm_cases(group, 24, 3, 8)
    assert _model(group, pts[2:3], sc[2:3], 8) == _native(group, pts[2:3],
                                                          sc[2:3])
    if group == "g1":
        assert _model(group, pts, [0] * 24, 8) is None


def test_plan_constants_match_header():
    """The schedule's constants in ops/bn254_msm.py are the kernels'."""
    with open(CUH) as f:
        src = f.read()

    def define(name):
        return int(re.search(rf"#define {name} (\w+)", src).group(1), 0)
    assert define("MSM_NONE") == bn254_msm.MSM_NONE
    assert define("MSM_CHUNK") == bn254_msm.CHUNK
    assert define("MSM_EDGE_CHUNK") == bn254_msm.EDGE_CHUNK
    assert define("MSM_SEGMENT") == bn254_msm.SEGMENT
    assert 1 << define("MSM_SEGMENT_BITS") == bn254_msm.SEGMENT
    assert define("MSM_FAN") == bn254_msm.FAN
    assert bn254_msm.NONE_BUCKET == bn254_msm.MSM_NONE >> 1


def test_window_bits_at_main_path_sizes():
    """16-bit windows for the devnet root's MSMs (~0.9-1 M points), as the
    running-sum segments and the kernels' key width assume; every choice
    in range and a key of the widest window below 2^31."""
    assert bn254_msm.window_bits(1 << 20) == 16
    assert bn254_msm.window_bits(900_000) == 16
    for n in (1, 64, 4096, 1 << 14, 1 << 24):
        assert 2 <= bn254_msm.window_bits(n) <= bn254_msm.MAX_WINDOW_BITS
    c = bn254_msm.MAX_WINDOW_BITS
    assert bn254_msm.n_windows(c) << c < bn254_msm.MSM_NONE
