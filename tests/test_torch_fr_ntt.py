"""The Fr NTT kernel's schedule (``csrc/fr_ntt.cu``) on the CPU.

``ops/ntt_fr._ntt_model`` runs the kernel's passes, index maps, bit
reversal, shared-memory swizzle, radix-4 groups and twiddle indices on
Python ints.  At small tiles (``tile_bits`` 1-4, so one, two and more
passes, groups of both radixes) and at the kernel's own (11) it is held
exact against the plain version ``_ntt_plain`` and the JAX package's
``_ntt_fr`` on seeded inputs, edge values and the round trip; the table
built from the host parts (``_host_twiddle_parts``, ``expand_twiddles``)
against ``_powers``; the pass plan, the swizzle's banks and the kernel's
constants read out of ``fr_ntt.cu``.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from xlayer_prover_tpu.snark import groth16 as jg16
from xlayer_prover_tpu_torch.fields.bn254 import R
from xlayer_prover_tpu_torch.ops import bn254_mont, ntt_fr

from tests.torch_cpu import one_torch_thread  # noqa: F401

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "xlayer_prover_tpu_torch", "csrc", "fr_ntt.cu")
EDGES = [0, 1, R - 1, R - 2]


def words(values):
    return torch.from_numpy(bn254_mont.to_words(values))


def seeded(bits: int, seed: int) -> list:
    """2^bits values below r from numpy's generator, the edges first."""
    gen = np.random.default_rng(seed)
    raw = gen.integers(0, 1 << 63, size=(1 << bits, 4), dtype=np.int64)
    vals = [v % R for v in bn254_mont.from_words(raw.view(np.uint64))]
    vals[:len(EDGES)] = EDGES[:1 << bits]
    return vals


@pytest.mark.parametrize("bits", range(14))
def test_model_matches_plain_and_jax(bits):
    """Every tile size 1-4 and the kernel's 11, both directions, exact
    against _ntt_plain and the JAX package's _ntt_fr."""
    vals = seeded(bits, 100 + bits)
    x = words(vals)
    for inverse in (False, True):
        want = jg16._ntt_fr(vals, inverse)
        assert bn254_mont.from_words(ntt_fr._ntt_plain(x, inverse)) == want
        for tile_bits in (1, 2, 3, 4, ntt_fr.TILE_BITS):
            got = ntt_fr._ntt_model(x, inverse, tile_bits)
            assert bn254_mont.from_words(got) == want, (tile_bits, inverse)


@pytest.mark.parametrize("tile_bits", [2, 3, ntt_fr.TILE_BITS])
def test_model_edge_values(tile_bits):
    """Inputs all 0, all 1, all r - 1, all r - 2, and the four mixed."""
    for vals in ([v] * 64 for v in EDGES):
        for inverse in (False, True):
            got = ntt_fr._ntt_model(words(vals), inverse, tile_bits)
            assert bn254_mont.from_words(got) == jg16._ntt_fr(vals, inverse)
    mixed = EDGES * 16
    for inverse in (False, True):
        got = ntt_fr._ntt_model(words(mixed), inverse, tile_bits)
        assert bn254_mont.from_words(got) == jg16._ntt_fr(mixed, inverse)


@pytest.mark.parametrize("tile_bits", [1, 3, ntt_fr.TILE_BITS])
def test_model_round_trip(tile_bits):
    x = words(seeded(9, 7))
    y = ntt_fr._ntt_model(x, False, tile_bits)
    assert torch.equal(ntt_fr._ntt_model(y, True, tile_bits), x)


@pytest.mark.parametrize("bits", range(1, 17))
def test_twiddle_expansion_matches_powers(bits):
    """The table multiplied out from the host parts (the model, and the
    wrapper's plain version at the sizes of one expansion) equals the
    Montgomery form of _powers, word for word, in both directions; the
    host builds at most 2^12 entries."""
    for inverse in (False, True):
        parts = ntt_fr._host_twiddle_parts(bits, inverse)
        assert sum(len(p) for p in parts) <= 1 << 12
        want = [v * bn254_mont.MONT % R for v in ntt_fr._powers(bits, inverse)]
        assert ntt_fr._expand_twiddles_model(parts) == want
        if bits <= 12:
            table = ntt_fr._kernel_twiddles(bits, inverse, torch.device("cpu"))
            assert bn254_mont.from_words(table) == want


def test_expand_twiddles_plain_on_edges():
    lo = words([0, 1, R - 1, R - 2])
    hi = words([1, R - 1])
    got = bn254_mont.from_words(ntt_fr.expand_twiddles(lo, hi))
    rinv = pow(1 << 256, -1, R)
    assert got == [a * b * rinv % R for b in (1, R - 1)
                   for a in (0, 1, R - 1, R - 2)]
    with pytest.raises(ValueError):
        ntt_fr.expand_twiddles(lo, torch.zeros((3, 4), dtype=torch.int64))


@pytest.mark.parametrize("bits", range(29))
def test_plans(bits):
    """Passes: ceil(bits / 11) launches (2 at 2^20 and 2^21, at most 3),
    stages summing to bits, each block holding at most a full tile; the
    host twiddle parts: each at most 2^11 entries, 2^12 in all."""
    passes = ntt_fr._passes(bits)
    assert len(passes) == max(1, -(-bits // ntt_fr.TILE_BITS))
    assert len(passes) <= ntt_fr.MAX_PASSES
    if bits in (20, 21):
        assert len(passes) == 2
    first = 0
    for start, stages, c in passes:
        assert start == first and c >= 0
        assert stages + c == min(bits, ntt_fr.TILE_BITS)
        first += stages
    assert first == bits
    parts = ntt_fr._twiddle_parts(bits)
    assert sum(parts) == max(0, bits - 1)
    assert max(parts) <= ntt_fr.TWIDDLE_PART_BITS
    assert sum(1 << a for a in parts) <= 1 << 12


def _group_banks(stages, c, s0, r):
    """The banks each warp's threads touch, slot by slot, in one group."""
    tile = 1 << (stages + c)
    threads = max(1, tile // ntt_fr.VALUES)
    width = 1 << r
    for warp in range(0, threads, 32):
        for q in range(ntt_fr.VALUES):
            g, i = divmod(q, width)
            banks = []
            for t in range(warp, min(warp + 32, threads)):
                o = t + threads * g
                cc, rest = o & ((1 << c) - 1), o >> c
                lo, hi = rest & ((1 << s0) - 1), rest >> s0
                e = cc + ((lo + (i << s0) + (hi << (s0 + r))) << c)
                banks.append(ntt_fr._slot(e) % 32)
            yield banks


def test_swizzle_spreads_every_warp_over_distinct_banks():
    """Every pass the kernel runs for 2^5 .. 2^28 values: each group's
    slot accesses, and the loads and stores of the tile (rows in order
    for the first pass's stores), touch 32 distinct banks a warp."""
    shapes = {(s, c) for bits in range(5, 29)
              for _, s, c in ntt_fr._passes(bits)}
    for stages, c in sorted(shapes):
        tile = 1 << (stages + c)
        assert sorted(ntt_fr._slot(e) for e in range(tile)) == \
            list(range(tile))
        s0 = 0
        while s0 < stages:
            r = min(ntt_fr.GROUP_BITS, stages - s0)
            for banks in _group_banks(stages, c, s0, r):
                assert len(set(banks)) == len(banks), (stages, c, s0, r)
            s0 += r
        for f0 in range(0, tile, 32):
            rows = [ntt_fr._slot((f & ((1 << c) - 1)) + ((f >> c) << c))
                    % 32 for f in range(f0, f0 + 32)]
            cols = [ntt_fr._slot((f >> stages) + ((f & ((1 << stages) - 1))
                                                   << c)) % 32
                    for f in range(f0, f0 + 32)]
            assert len(set(rows)) == 32 and len(set(cols)) == 32


def test_cu_constants():
    """The tile, thread, pass and swizzle constants of fr_ntt.cu equal
    ops/ntt_fr.py's; a full tile's shared memory (2^11 x 32 bytes) fits
    NTT_MIN_BLOCKS blocks in an H100 SM's 227 KB, and their threads cap
    a thread at 64 registers."""
    text = open(CU).read()

    def const(name):
        return int(re.search(rf"#define {name} (\d+)u?\b", text).group(1))

    assert const("NTT_TILE_BITS") == ntt_fr.TILE_BITS
    assert const("NTT_VALUES") == ntt_fr.VALUES
    assert const("NTT_GROUP_BITS") == ntt_fr.GROUP_BITS
    assert const("NTT_THREADS") == ntt_fr.THREADS
    assert const("NTT_MAX_PASSES") == ntt_fr.MAX_PASSES
    assert tuple(const(f"NTT_SWIZZLE_{k}") for k in range(5)) == \
        ntt_fr.SWIZZLE
    blocks = const("NTT_MIN_BLOCKS")
    assert blocks * (1 << ntt_fr.TILE_BITS) * 32 <= 227 * 1024
    # __launch_bounds__(NTT_THREADS, NTT_MIN_BLOCKS): 64 registers a thread
    assert 65536 // (blocks * ntt_fr.THREADS) == 64


def test_wrapper_on_cpu_is_plain():
    x = words(seeded(6, 3))
    for inverse in (False, True):
        assert torch.equal(ntt_fr.ntt(x, inverse),
                           ntt_fr._ntt_plain(x, inverse))
