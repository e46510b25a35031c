"""The designs of fr_poly.cu's fr_eval and fr_scan_mul kernels, as
Python-int models, against the plain PyTorch versions that the CPU runs
(``ops/fr_poly._eval_plain``, ``_scan_mul_plain``), the Python-int
functions and the JAX package's fflonk helpers.

fr_eval (``eval_pass``): a persistent grid of blocks, each Horner over its
tiles from the top, a thread's tile value its running value times
x^(tile G) plus its segment's coefficients times x^(threads j), summed
exactly in 512 bits (checked below 17 r^2) and reduced once; the block's
threads summed with x^t (lanes pairwise, then the warps by Horner); the
blocks' values evaluated again at x^tile by one block.  fr_scan_mul of a
vector (``lookback_scan`` over Mul): tiles from an atomic ticket, each
run's suffix products in Montgomery form, the runs' and groups'
aggregates composed by Montgomery products, look-backs over windows of
the tiles above in orders of completion drawn from a seeded shuffle, the
positions mirrored for prefix products.  fr_scan_mul of one value
repeated (``pow_tables``, ``pow_values``): two tables built by doubling,
one product of theirs a value.  Each at small shapes and at the kernel's
own.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import os
import random
import re
import types

import pytest
import torch

from xlayer_prover_tpu.snark import fflonk as jff
from xlayer_prover_tpu_torch.fields.bn254 import R
from xlayer_prover_tpu_torch.ops import fr_poly
from xlayer_prover_tpu_torch.ops.bn254_mont import MONT, from_words, to_words

from tests.torch_cpu import one_torch_thread  # noqa: F401

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "xlayer_prover_tpu_torch", "csrc", "fr_poly.cu")
RINV = pow(MONT, R - 2, R)
EDGES = [0, 1, R - 1, R - 2]
LAZY = 17 * R * R                  # fr_redc_wide's bound on a 512-bit sum


def values(n: int, seed: int) -> list:
    rng = random.Random(seed)
    out = [rng.randrange(R) for _ in range(n)]
    out[:min(n, 4)] = EDGES[:min(n, 4)]
    return out


def words(vals):
    return torch.from_numpy(to_words(vals))


def mont(a: int, b: int) -> int:
    return a * b * RINV % R


def redc(s: int) -> int:
    """fr_redc_wide: S / 2^256 mod r for a 512-bit sum below 17 r^2."""
    assert 0 <= s < LAZY
    return s * RINV % R


# ---------------------------------------------------------------------------
# fr_eval
# ---------------------------------------------------------------------------

def eval_pass_model(p: list, xs: list, threads: int, seg: int, lanes: int,
                    blocks: int) -> list:
    """eval_pass over one polynomial p at the points xs with `blocks`
    blocks of `threads` threads (warps of `lanes`): -> the blocks' values
    by point, [m][g], so that p(x) = sum_g x^(threads seg g) out[m][g]."""
    n, tile = len(p), threads * seg
    tiles = -(-n // tile)
    assert 1 <= blocks <= tiles
    out = []
    for x in xs:
        sq = [x * MONT % R]
        while len(sq) < max(threads.bit_length() + seg.bit_length(), 6):
            sq.append(mont(sq[-1], sq[-1]))
        # the segment table by doubling: [s, 2s) = [0, s) x^(threads s)
        pj = [MONT % R]
        e = threads.bit_length() - 1
        while len(pj) < seg:
            pj += [mont(v, sq[e]) for v in pj]
            e += 1
        y = pow(x, tile * blocks, R) * MONT % R
        vals = []
        for g in range(blocks):
            acc = [0] * threads
            for t in range(g + (tiles - 1 - g) // blocks * blocks, -1,
                           -blocks):
                for tid in range(threads):
                    s = acc[tid] * y
                    for j in range(seg):
                        i = t * tile + tid + threads * j
                        if i < n:
                            s += p[i] * pj[j]
                    acc[tid] = redc(s)
            # lanes pairwise: lane l (a multiple of 2d) takes l + d's x^d
            d, e = 1, 0
            while d < lanes:
                for w0 in range(0, threads, lanes):
                    for ln in range(0, lanes, 2 * d):
                        s = acc[w0 + ln + d] * sq[e]
                        assert s < LAZY
                        acc[w0 + ln] = (s * RINV + acc[w0 + ln]) % R
                d, e = 2 * d, e + 1
            # the warps by Horner with x^lanes
            ws = acc[::lanes]
            v = ws[-1]
            for w in reversed(ws[:-1]):
                v = (v * sq[e] * RINV + w) % R
            vals.append(v)
        out.append(vals)
    return out


def eval_model(p: list, xs: list, threads: int, seg: int, lanes: int,
               blocks: int) -> list:
    """fr_evaluate's two passes: the blocks' values, then (more than one
    block) one block over them at x^(threads seg)."""
    parts = eval_pass_model(p, xs, threads, seg, lanes, blocks)
    if blocks == 1:
        return [v[0] for v in parts]
    tile = threads * seg
    assert blocks <= tile
    return [eval_pass_model(v, [pow(x, tile, R)], threads, seg, lanes,
                            1)[0][0] for v, x in zip(parts, xs)]


@pytest.mark.parametrize("threads,seg,lanes", [(8, 2, 4), (4, 4, 2),
                                               (16, 1, 8)])
def test_eval_model_matches_plain_and_jax(threads, seg, lanes):
    """Small tiles: one tile, either side of it, several tiles a block and
    more blocks than one, at 1 to 8 points with the edges."""
    tile = threads * seg
    for n in sorted({1, tile - 1, tile, tile + 1, 7 * tile + 3}):
        p = values(n, 11 * n + seg)
        rng = random.Random(n)
        for pts in (1, 2, 5, 8):
            xs = (EDGES + [rng.randrange(R) for _ in range(4)])[:pts]
            want = fr_poly._eval_plain(words(p), xs)
            assert want == [jff.peval(p, x) for x in xs]
            tiles = -(-n // tile)
            for blocks in sorted({1, min(3, tiles), tiles}):
                assert eval_model(p, xs, threads, seg, lanes,
                                  blocks) == want, (n, pts, blocks)


def test_eval_model_at_the_kernels_shape():
    """EVAL_THREADS threads in warps of 32, EVAL_SEG coefficients a
    segment, two tiles a block over three blocks and a ragged end; every
    coefficient r - 1 on a second polynomial (the 512-bit sums' largest
    terms)."""
    threads, seg = fr_poly.EVAL_THREADS, fr_poly.EVAL_SEG
    tile = threads * seg
    assert tile == fr_poly.EVAL_TILE
    n = 5 * tile + 7
    xs = [R - 1, 2, 123456789, random.Random(3).randrange(R)]
    for p in (values(n, 77), [R - 1] * n):
        want = [jff.peval(p, x) for x in xs]
        assert eval_model(p, xs, threads, seg, 32, 3) == want
        assert eval_model(p[:tile], xs, threads, seg, 32, 1) == [
            jff.peval(p[:tile], x) for x in xs]


def test_eval_args_and_grid(monkeypatch):
    """The EvalArgs words the launcher takes (x^(2^b), then x^(tile G),
    Montgomery form, EVAL_POINTS slots) and the grid, from the card's SM
    count and the blocks an SM holds, its tiles and the finishing pass's
    one tile."""
    xs = [3, R - 1, 2 ** 200 + 7]
    arr = fr_poly._eval_args(xs, 5)
    got = from_words(torch.frombuffer(bytearray(arr), dtype=torch.int64)
                     .reshape(-1, 4))
    sq = fr_poly.EVAL_SQ
    assert len(got) == fr_poly.EVAL_POINTS * (sq + 1)
    for j in range(fr_poly.EVAL_POINTS):
        x = xs[j] if j < len(xs) else 0
        assert got[j * sq:(j + 1) * sq] == [
            pow(x, 1 << b, R) * MONT % R for b in range(sq)]
        assert got[fr_poly.EVAL_POINTS * sq + j] == \
            pow(x, fr_poly.EVAL_TILE * 5, R) * MONT % R
    props = types.SimpleNamespace(multi_processor_count=132)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: props)
    tile = fr_poly.EVAL_TILE
    for occupancy in (4, 8, 16):
        monkeypatch.setattr(fr_poly, "_eval_occupancy", lambda: occupancy)
        assert fr_poly._eval_blocks(1, "cuda") == 1
        assert fr_poly._eval_blocks(3 * tile + 1, "cuda") == 4
        # the finishing pass is one tile: at most EVAL_TILE blocks
        assert fr_poly._eval_blocks(1 << 30, "cuda") == min(
            132 * occupancy, tile)


# ---------------------------------------------------------------------------
# fr_scan_mul of a vector: the product look-back
# ---------------------------------------------------------------------------

def scan_lookback_model(x: list, exclusive: bool, init: int,
                        reverse: bool, steps: int, lanes: int, warps: int,
                        window: int, seed: int) -> list:
    """init times the prefix (reverse: suffix) products of x the way
    lookback_scan<1, Mul> computes them: the kernel's own scan is from the
    top position down, over u_j = x[m - 1 - j] for prefix products."""
    m = len(x)
    u = x if reverse else x[::-1]
    P = lanes * warps                       # threads a tile
    TV = P * steps                          # values a tile
    tiles = -(-m // TV)
    one = MONT % R                          # the identity, Montgomery form
    r2 = MONT * MONT % R
    runs, local = {}, {}

    def tile_local(t):
        """Each run's suffix products (Montgomery form), the lanes'
        inclusive suffix scans of the runs' aggregates, the groups'
        totals and the tile's aggregate: none needs the carry."""
        lo = t * TV
        sp, ex, wtot = {}, {}, []
        for wi in range(warps):
            aggs = []
            for lane in range(lanes):
                g = wi * lanes + lane
                acc, have = one, False
                for i in range(steps - 1, -1, -1):
                    pos = g * steps + i
                    if lo + pos < m:
                        v = mont(u[lo + pos], r2)      # u R
                        acc = mont(v, acc) if have else v
                        have = True
                    sp[pos] = acc
                aggs.append(acc)
            d = 1
            while d < lanes:                    # Kogge-Stone, suffixes
                aggs = [mont(aggs[ln], aggs[ln + d]) if ln + d < lanes
                        else aggs[ln] for ln in range(lanes)]
                d *= 2
            for lane in range(lanes):
                ex[wi, lane] = aggs[lane + 1] if lane + 1 < lanes else one
            wtot.append(aggs[0])
        a = wtot[-1]
        for w in reversed(wtot[:-1]):
            a = mont(w, a)
        runs[t] = sp
        local[t] = (ex, wtot, a)

    flag = [0] * tiles
    aggs, incs, carry, look = {}, {}, {}, {}
    started, done = [], set()
    rng = random.Random(seed)
    while len(done) < tiles:
        choices = [t for t in started if t not in done]
        if len(started) < tiles:
            choices.append(None)            # the next ticket
        t = rng.choice(choices)
        if t is None:
            t = tiles - 1 - len(started)
            started.append(t)
            tile_local(t)
            continue
        agg = local[t][2]
        if t == tiles - 1 and flag[t] == 0:
            carry[t] = init * MONT % R
            incs[t], flag[t] = mont(agg, carry[t]), 2
            done.add(t)
            continue
        if flag[t] == 0:
            aggs[t], flag[t] = agg, 1
            look[t] = (t + 1, one)
            continue
        base, part = look[t]
        fl = [flag[base + d] if base + d < tiles else 2
              for d in range(window)]
        first = next((d for d, f in enumerate(fl) if f == 2), window)
        if any(f == 0 for f in fl[:first + 1]):
            continue                        # a spin
        for d in range(min(first + 1, window)):
            if base + d < tiles:
                part = mont(part, (incs if fl[d] == 2 else aggs)[base + d])
        if first == window:
            look[t] = (base + window, part)
            continue
        carry[t] = part
        incs[t] = mont(agg, part)
        flag[t] = 2
        done.add(t)

    y = [0] * m
    for t in range(tiles):
        ex, wtot, _ = local[t]
        sp = runs[t]
        lo = t * TV
        for wi in range(warps):
            cw = carry[t]
            for v in range(warps - 1, wi, -1):
                cw = mont(wtot[v], cw)
            for lane in range(lanes):
                g = wi * lanes + lane
                cy = mont(mont(ex[wi, lane], cw), 1)   # canonical
                for i in range(steps):
                    pos = g * steps + i
                    if exclusive:
                        val = cy if i == steps - 1 else mont(cy,
                                                             sp[pos + 1])
                    else:
                        val = mont(cy, sp[pos])
                    if lo + pos < m:
                        y[lo + pos] = val
    return y if reverse else y[::-1]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_lookback_model_matches_plain(exclusive, reverse):
    """Small runs, lanes and windows: one value, one tile, a ragged last
    tile, and tiles enough that look-backs read several windows."""
    steps, lanes, warps, window = 2, 4, 2, 3
    tv = steps * lanes * warps
    for m in sorted({1, 2, tv - 1, tv, tv + 1, 11 * tv - 3}):
        x = values(m, 13 * m + exclusive)
        init = [1, R - 1, 98765][m % 3]
        want = from_words(fr_poly._scan_mul_plain(words(x), exclusive, init,
                                                  None, reverse))
        assert want == fr_poly._scan_mul_model(x, exclusive, init, reverse)
        for seed in range(3):
            assert scan_lookback_model(x, exclusive, init, reverse, steps,
                                       lanes, warps, window, seed) == want, \
                (m, seed)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_lookback_model_at_the_kernels_shape(reverse):
    """The kernel's own run length, threads and window (``_lb_shape(1)``,
    LB_WINDOW) over three tiles and a ragged end, a zero among the
    values; the status words of its tiles."""
    steps, threads = fr_poly._lb_shape(1)
    assert fr_poly._lb_tile(1) == steps * threads
    m = 2 * fr_poly._lb_tile(1) + 7
    x = values(m, 21)
    for exclusive in (False, True):
        want = fr_poly._scan_mul_model(x, exclusive, 4321, reverse)
        assert scan_lookback_model(x, exclusive, 4321, reverse, steps, 32,
                                   threads // 32, fr_poly.LB_WINDOW,
                                   exclusive) == want
    assert from_words(fr_poly._scan_mul_plain(words(x), False, 4321, None,
                                              reverse)) == \
        fr_poly._scan_mul_model(x, False, 4321, reverse)
    assert fr_poly._lb_status_words(1, 3) == 4 + 4 + 16 * 3


def test_suffix_products_as_the_prover_took_them():
    """The reverse scan equals the flip of the scan of the flipped
    vector (the denominators' suffix products of the z column, which the
    fflonk prover once took with two copies)."""
    x = values(37, 8)
    t = words(x)
    for exclusive in (False, True):
        want = torch.flip(fr_poly.scan_mul(torch.flip(t, [0]).contiguous(),
                                           exclusive), [0])
        assert torch.equal(fr_poly.scan_mul(t, exclusive, reverse=True),
                           want)
    with pytest.raises(ValueError):
        fr_poly.scan_mul(words([3]), n=4, reverse=True)


# ---------------------------------------------------------------------------
# fr_scan_mul of one value repeated: the two tables
# ---------------------------------------------------------------------------

def pow_model(x: int, exclusive: bool, init: int, n: int) -> list:
    """pow_tables then pow_values: lo[k] = x^k (canonical) and hi[h] =
    init x^(2^L h) (Montgomery form), each by doubling with the steps'
    squares taken in Montgomery form from x, then one product a value."""
    off = 0 if exclusive else 1
    lo_bits, hi_n = fr_poly._pow_split(n + off)
    assert (hi_n - 1) << lo_bits < n + off <= hi_n << lo_bits
    sq = [x * MONT % R]
    while len(sq) < lo_bits + max(1, hi_n).bit_length():
        sq.append(mont(sq[-1], sq[-1]))

    def doubled(first, size, b0):
        tab, e = [first], 0
        while len(tab) < size:
            tab += [mont(v, sq[b0 + e]) for v in tab[:size - len(tab)]]
            e += 1
        return tab
    lo = doubled(1, 1 << lo_bits, 0)
    hi = doubled(init * MONT % R, hi_n, lo_bits)
    mask = (1 << lo_bits) - 1
    return [mont(lo[e & mask], hi[e >> lo_bits])
            for e in range(off, n + off)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 15, 16, 17, 63, 64, 65, 300,
                               1023, 1024, 1025])
def test_pow_model_matches_plain(n):
    """Lengths at and around 2^L of the split, inclusive and exclusive,
    the edges as x and init."""
    rng = random.Random(n)
    for x, init in ((rng.randrange(R), rng.randrange(R)), (R - 1, 1),
                    (0, R - 2), (1, 5)):
        for exclusive in (False, True):
            want = from_words(fr_poly._scan_mul_plain(
                words([x]), exclusive, init, n))
            assert want == fr_poly._scan_mul_model([x] * n, exclusive, init)
            assert pow_model(x, exclusive, init, n) == want


def test_pow_split_and_the_jax_shift():
    """The split at the wrap's lengths (tau^i at 10n + 41, the tags at n
    = 2^23) and across powers of two; the JAX package's _shift_omega of
    all ones is the repeated scan w^i."""
    assert fr_poly._pow_split(10 * (1 << 23) + 41) == (14, 5121)
    assert fr_poly._pow_split(1 << 23) == (12, 2048)
    for e in range(1, 3000):
        lo_bits, hi_n = fr_poly._pow_split(e)
        assert (hi_n - 1) << lo_bits < e <= hi_n << lo_bits
        assert hi_n <= 2 << lo_bits and lo_bits + hi_n.bit_length() <= \
            fr_poly.POW_SQ
    w = 2 ** 100 + 3
    for n in (1, 9, 40):
        want = jff._shift_omega([1] * n, w)
        assert from_words(fr_poly.scan_mul(words([w]), True, n=n)) == want
        assert pow_model(w, True, 1, n) == want


def test_the_montgomery_one_in_the_source():
    """fr_one's words are 2^256 mod r, the identity of the product
    look-back's Montgomery forms."""
    src = open(CU).read()
    body = re.search(r"void fr_one\(uint32_t x\[8\]\) \{(.*?)\}", src,
                     re.S).group(1)
    ws = [int(v, 16) for v in re.findall(r"= (0x[0-9a-f]+)u;", body)]
    assert len(ws) == 8
    assert sum(v << (32 * i) for i, v in enumerate(ws)) == MONT % R
