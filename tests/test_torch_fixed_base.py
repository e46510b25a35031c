"""Port parity: the fixed-base kernels' plain version (8-bit windows, one
inversion a block) against the JAX package's native ``fixed_base_g1`` /
``fixed_base_g2`` (``xlayer_prover_tpu/native/msm.cpp``), exact equality.

The host-built table (entry (w, d) = d 2^(8w) G) against the native
product of d 2^(8w); the walk and the normalisation over the edge
scalars of ``bn254_msm.fixed_base_cases`` (0, 1, 255, 256, r - 1, r - 2,
2^253, bytes of 0xFF, d 2^(8w) at every window, the H = 0 branches), a
block of either kernel all at infinity, a block with one live lane, a
ragged last block, and seeded scalars; the block widths against
``csrc/bn254_msm.cuh``.  The kernels themselves are held against the
same plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import os
import random
import re

import pytest
import torch

from xlayer_prover_tpu import native
from xlayer_prover_tpu_torch.fields import bn254, bn254_tower
from xlayer_prover_tpu_torch.ops import bn254_mont, bn254_msm

from tests.torch_cpu import one_torch_thread  # noqa: F401

P, R = bn254.P, bn254.R
CUH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "xlayer_prover_tpu_torch", "csrc", "bn254_msm.cuh")
GROUPS = {"g1": (bn254.G1_GEN, bn254_msm.FQ1_OPS, native.fixed_base_g1),
          "g2": (bn254_tower.G2_GEN, bn254_msm.FQ2_OPS,
                 native.fixed_base_g2)}
# the lanes of fixed_base_cases: 11 edges, then d 2^(8w) for d = 1, 255
EDGES = slice(0, 11)
WINDOWS = slice(11, 11 + 2 * bn254_msm.FB_WINDOWS)


def words(values):
    return torch.from_numpy(bn254_mont.to_words(values))


def native_points(group, ks):
    gen, _F, fn = GROUPS[group]
    return fn(gen, [k % R for k in ks])


def plain_points(group, ks):
    gen, F, _fn = GROUPS[group]
    got = getattr(bn254_msm, f"fixed_base_{group}")(gen, words(ks))
    assert got.shape == (len(ks), 2 * F.words)
    return getattr(bn254_msm, f"{group}_points")(got)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("w,d", [(0, 1), (0, 255), (1, 1), (17, 128),
                                 (31, 48)])
def test_table_entry_matches_native(group, w, d):
    gen = GROUPS[group][0]
    entry = bn254_msm._window_table(gen)[w * bn254_msm.FB_DIGITS + d - 1]
    assert [entry] == native_points(group, [d << (8 * w)])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_device_table_is_montgomery_form(group):
    """The kernels' table: every coordinate times 2^256 mod p, in the
    order of the host table."""
    gen = GROUPS[group][0]
    pts = bn254_msm._window_table(gen)
    assert len(pts) == bn254_msm.FB_WINDOWS * bn254_msm.FB_DIGITS
    dev = bn254_msm._device_table(gen, torch.device("cpu"))
    vals = bn254_mont.from_words(dev.reshape(-1, 4))
    coords = [v for pt in pts for c in pt
              for v in (c if isinstance(c, tuple) else (c,))]
    assert vals == [v * (1 << 256) % P for v in coords]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("case", ["edges", "windows", "seeded"])
def test_plain_matches_native(group, case):
    ks = bn254_msm.fixed_base_cases(512, 20261017, 128)
    ks = {"edges": ks[EDGES], "windows": ks[WINDOWS],
          "seeded": ks[100:140]}[case]
    assert plain_points(group, ks) == native_points(group, ks)


def test_edge_scalars_reach_the_branches():
    """r's last addition meets -P and 2 (0x31 2^248) - r's meets P; every
    byte of the two 0xFF scalars but the top one is 0xFF."""
    ks = bn254_msm.fixed_base_cases(512, 1, 128)
    top = 1 << 248
    assert ks[9] == R and (ks[9] % top + (ks[9] >> 248) * top) % R == 0
    assert ks[10] % top == ((ks[10] >> 248) * top) % R
    for k in ks[7:9]:
        assert all((k >> (8 * b)) & 0xFF == 0xFF for b in range(31))
        assert k < R


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_blocks_match_native(group):
    """The cases at the kernel's block width W: lanes [2W, 3W) at
    infinity (a whole block), lanes [3W, 4W) at infinity but one, and a
    ragged last block of 37 lanes: zero words where k = 0, the native
    points elsewhere."""
    w = GROUPS[group][1].block
    ks = bn254_msm.fixed_base_cases(4 * w + 37, 20261017, w)
    assert [bool(k) for k in ks[2 * w:4 * w]] == \
        [k == 3 * w + 77 for k in range(2 * w, 4 * w)]
    got = plain_points(group, ks)
    assert got == native_points(group, ks)
    assert all(pt is None for pt in got[2 * w:3 * w])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_batch_inverse_groups(group):
    """Montgomery's trick over groups of the kernel's block width, the
    last group ragged: each lane's inverse."""
    _gen, F, _fn = GROUPS[group]
    rng = random.Random(4)
    n = F.block + 5
    vals = [rng.randrange(1, P) for _ in range(F.dims * n)]
    z = F.to_mont(words(vals).reshape(n, 4 * F.dims))
    got = bn254_mont.from_words(F.from_mont(bn254_msm._batch_inverse(
        F, z)).reshape(-1, 4))
    if F.dims == 1:
        assert got == [bn254.fq_inv(v) for v in vals]
    else:
        pairs = list(zip(vals[0::2], vals[1::2]))
        assert got == [c for a in pairs for c in bn254_tower.fq2_inv(a)]


def test_block_widths_match_the_kernel():
    with open(CUH) as f:
        src = f.read()
    shape = dict(re.findall(
        r"struct FixedBaseShape<(Fq2?)> \{\s*static constexpr int "
        r"THREADS = (\d+)", src))
    assert shape == {"Fq": str(bn254_msm.FQ1_OPS.block),
                     "Fq2": str(bn254_msm.FQ2_OPS.block)}
