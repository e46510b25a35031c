"""The designs of fr_poly.cu's fr_div_binomial and fr_pointwise kernels,
as Python-int models, against the plain PyTorch versions that the CPU
runs (``ops/fr_poly._div_binomial_plain``, ``_pointwise_plain``).

The look-back model follows the kernel's decomposition of
y_j = u_j + c y_{j+k}: tiles of k S P values (S steps of a chain a
thread, P threads a chain), a thread's aggregate with no carry (its
values times c^i summed in 512 bits and reduced once), inclusive
suffix scans over a warp's lanes composed with c^(S d), warp totals
composed with c^(S lanes), tiles published from an atomic ticket, top
first, and look-backs over windows of the tiles above, in orders of
completion drawn from a seeded shuffle.  It runs at small S, lanes and
windows, and at the kernel's own shape (``_lb_shape``).  Beside it: the
c = 1 suffix sums of div_chain, and the identities in the Montgomery forms
the kernel computes them in (mont(a, b) = a b / 2^256, the reductions of
512-bit sums, the fixing products by ``_pointwise_consts``' constants, a
block's beta hi[h] of the domain tables).  The kernels themselves run
only on the card (``tests/test_torch_cuda.py``).
"""

import random

import pytest
import torch

from xlayer_prover_tpu_torch.fields.bn254 import R
from xlayer_prover_tpu_torch.ops import fr_poly, ntt_fr
from xlayer_prover_tpu_torch.ops.bn254_mont import MONT, from_words, to_words

from tests.torch_cpu import one_torch_thread  # noqa: F401

RINV = pow(MONT, R - 2, R)
EDGES = [0, 1, R - 1, R - 2]


def values(n: int, seed: int) -> list:
    rng = random.Random(seed)
    out = [rng.randrange(R) for _ in range(n)]
    out[:min(n, 4)] = EDGES[:min(n, 4)]
    return out


def words(vals):
    return torch.from_numpy(to_words(vals))


def mont(a: int, b: int) -> int:
    return a * b * RINV % R


def lookback_model(u: list, k: int, c: int, steps: int, lanes: int,
                   warps: int, window: int, seed: int) -> list:
    """y_j = u_j + c y_{j+k} (j < m) the way div_lookback computes it."""
    m = len(u)
    P = lanes * warps                       # threads a chain
    TS = P * steps                          # steps of a chain a tile
    TV = k * TS                             # values a tile
    tiles = -(-m // TV)
    cp = {e: pow(c, e, R) for e in {1, steps * lanes, TS}}

    def at(j):
        return u[j] if j < m else 0

    def compose(x, above, e):               # x + c^e above
        return (x + pow(c, e, R) * above) % R

    local = {}

    def tile_local(t):
        """Each run's aggregate, the lanes' inclusive suffix scans, the
        warp totals and the tile's aggregate: none needs the carry."""
        lo = t * TV
        ex, wtot, agg = {}, {}, []
        for r in range(k):
            for wi in range(warps):
                vals = []
                for lane in range(lanes):
                    g = wi * lanes + lane
                    # sum_i c^i u_i: products summed, reduced once
                    vals.append(sum(pow(c, i, R) * MONT % R
                                    * at(lo + (g * steps + i) * k + r)
                                    for i in range(steps)) * RINV % R)
                d = 1
                while d < lanes:                # Kogge-Stone, suffixes
                    vals = [compose(vals[ln], vals[ln + d], steps * d)
                            if ln + d < lanes else vals[ln]
                            for ln in range(lanes)]
                    d *= 2
                for lane in range(lanes):
                    ex[r, wi, lane] = vals[lane + 1] if lane + 1 < lanes \
                        else 0
                wtot[r, wi] = vals[0]
            a = wtot[r, warps - 1]
            for wi in range(warps - 2, -1, -1):
                a = compose(wtot[r, wi], a, steps * lanes)
            agg.append(a)
        local[t] = (ex, wtot, agg)

    flag = [0] * tiles
    aggs, incs, carry = {}, {}, {}
    look = {}                               # tile -> (base, partial, mult)
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
            incs[t], carry[t], flag[t] = list(agg), [0] * k, 2
            done.add(t)
            continue
        if flag[t] == 0:
            aggs[t], flag[t] = list(agg), 1
            look[t] = (t + 1, [0] * k, 1)
            continue
        base, part, mult = look[t]
        fl = [flag[base + d] if base + d < tiles else 2
              for d in range(window)]
        first = next((d for d, f in enumerate(fl) if f == 2), window)
        if any(f == 0 for f in fl[:first + 1]):
            continue                        # a spin
        for d in range(min(first + 1, window)):
            x = [0] * k if base + d >= tiles else \
                (incs if fl[d] == 2 else aggs)[base + d]
            part = [(part[r] + mult * pow(c, TS * d, R) * x[r]) % R
                    for r in range(k)]
        if first == window:
            look[t] = (base + window, part, mult * pow(c, TS * window, R)
                       % R)
            continue
        carry[t] = part
        incs[t] = [compose(agg[r], part[r], TS) for r in range(k)]
        flag[t] = 2
        done.add(t)

    y = [0] * m
    for t in range(tiles):
        ex, wtot, _ = local[t]
        lo = t * TV
        for r in range(k):
            for wi in range(warps):
                cw = carry[t][r]
                for v in range(warps - 1, wi, -1):
                    cw = compose(wtot[r, v], cw, steps * lanes)
                for lane in range(lanes):
                    g = wi * lanes + lane
                    cur = compose(ex[r, wi, lane], cw,
                                  steps * (lanes - 1 - lane))
                    for i in range(steps - 1, -1, -1):
                        j = lo + (g * steps + i) * k + r
                        cur = (at(j) + cp[1] * cur) % R
                        if j < m:
                            y[j] = cur
    return y


def chain_model(p: list, k: int, c: int):
    """div_chain: thread j < k walks its chain from the top, the suffix
    in registers.  -> (q, r) as div_binomial returns them."""
    n = len(p)
    q = [0] * max(1, n - k)
    r = []
    for j in range(k):
        acc = 0
        if j < n - k:
            for i in range(j + (n - k - 1 - j) // k * k, j - 1, -k):
                acc = (p[i + k] + c * acc) % R
                q[i] = acc
        r.append(((p[j] if j < n else 0) + c * acc) % R)
    return q, r


def plain_div(p: list, k: int, c: int):
    q, r = fr_poly._div_binomial_plain(words(p), k, c)
    return from_words(q), from_words(r)


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("one", [True, False])
def test_lookback_model_matches_plain(k, one):
    """Small S, lanes and windows: one tile, a ragged last tile, m < k,
    and tiles enough that look-backs read several windows."""
    c = 1 if one else random.Random(k).randrange(2, R)
    steps, lanes, window = 2, 4, 3
    warps = 2 if k == 1 else 1
    tv = k * steps * lanes * warps
    for m in sorted({max(1, k - 1), tv, tv + 5, 11 * tv - 3}):
        p = values(m + k, 31 * m + k)
        want_q, want_r = plain_div(p, k, c)
        for seed in range(3):
            got = lookback_model(p[k:], k, c, steps, lanes, warps, window,
                                 seed)
            assert got == want_q, (m, seed)
        # the remainder, as the wrapper takes it on the host
        qk = (got + [0] * k)[:k]
        assert [(a + c * b) % R for a, b in zip(p[:k], qk)] == want_r


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_lookback_model_at_the_kernels_shape(k):
    """The kernel's own S and P (``_lb_shape``) and window, over three
    tiles and a ragged end."""
    steps, threads = fr_poly._lb_shape(k)
    lanes = min(32, threads)
    assert fr_poly._lb_tile(k) == k * steps * threads
    assert k * threads % 32 == 0
    m = 2 * fr_poly._lb_tile(k) + 7
    c = 987654321
    p = values(m + k, 5 + k)
    got = lookback_model(p[k:], k, c, steps, lanes, threads // lanes,
                         fr_poly.LB_WINDOW, k)
    assert got == plain_div(p, k, c)[0]
    # the powers the launcher hands the kernel, as the model composes them
    pw = fr_poly._lb_powers(k, c)
    tile_steps = steps * threads
    assert pw[0] == c * MONT % R
    pw = pw[1:]
    assert pw[:steps] == [pow(c, i, R) * MONT % R for i in range(steps)]
    pw = pw[steps:]
    assert pw[:32] == [pow(c, steps * j, R) * MONT % R for j in range(32)]
    assert pw[32:37] == [pow(c, lanes * steps * j, R) * MONT % R
                         for j in range(fr_poly.LB_THREADS // 32 + 1)]
    assert pw[37:] == [pow(c, tile_steps * d, R) * MONT % R
                       for d in range(fr_poly.LB_WINDOW + 1)]
    tiles = -(-m // fr_poly._lb_tile(k))
    assert fr_poly._lb_status_words(k, tiles) == 4 + 4 + 16 * k * tiles


@pytest.mark.parametrize("k,n", [(9, 40), (16, 16), (16, 7), (64, 260),
                                 (1 << 10, 4 * (1 << 10) + 3)])
@pytest.mark.parametrize("c", [1, 12345])
def test_chain_model_matches_plain(k, n, c):
    p = values(n, k + n)
    assert chain_model(p, k, c) == plain_div(p, k, c)


def gate_model(ins: list) -> list:
    qm, ql, qr, qo, qc, a, b, c, pi = ins
    fix = fr_poly._pointwise_consts("gate", [])[0]
    out = []
    for i in range(len(a)):
        x = (qm[i] * b[i] + ql[i]) * RINV % R
        y = (qr[i] * b[i] + qo[i] * c[i]) * RINV % R
        z = (a[i] * x + y) * RINV % R
        out.append((mont(z, fix) + qc[i] + pi[i]) % R)
    return out


def perm_model(op: str, ins: list, beta: int, gamma: int, w: int,
               shift: int, block: int):
    """perm_z / perm_t2 in the kernel's forms; beta x = mont(lo[i],
    beta hi[h]), beta hi[h] a block's (h = the block's first i >> lo)."""
    n = len(ins[0])
    ks = fr_poly._pointwise_consts(op, [beta, gamma])
    lo_t, hi_t, lo_bits = fr_poly._domain_tables(n.bit_length() - 1, w,
                                                 torch.device("cpu"))
    lo_t, hi_t = from_words(lo_t), from_words(hi_t)
    a, b, c, s1, s2, s3 = ins[:6]
    nums, dens = [], []
    for i in range(n):
        bhi = mont(hi_t[(i // block * block) >> lo_bits], ks[0])
        bx = mont(lo_t[i & ((1 << lo_bits) - 1)], bhi)
        f = [(v + kx + ks[1]) % R for v, kx in
             ((a[i], bx), (b[i], 2 * bx), (c[i], 3 * bx))]
        g = [(v + mont(s[i], ks[0]) + ks[1]) % R for v, s in
             ((a[i], s1), (b[i], s2), (c[i], s3))]
        nums.append(mont(mont(f[0], f[1]), f[2]))
        dens.append(mont(mont(g[0], g[1]), g[2]))
    if op == "perm_z":
        return ([mont(x, ks[2]) for x in nums],
                [mont(x, ks[2]) for x in dens])
    z = ins[6]
    return [mont((z[i] * nums[i] + z[(i + shift) % n] * (R - dens[i]))
                 * RINV % R, ks[2]) for i in range(n)]


@pytest.mark.parametrize("n", [1, 7, 33])
def test_pointwise_forms_match_plain(n):
    """The linear combination's 512-bit sum and one reduction, the mul's
    two products, the gate's three reductions and fix."""
    ins = [values(n, 90 + j) for j in range(9)]
    ks = values(4, 19)[::-1]
    lens = [n, max(1, n // 2), 1, n]
    short = [v[:m] for v, m in zip(ins, lens)]
    kw = fr_poly._pointwise_consts("lincomb", ks)
    want = from_words(fr_poly._pointwise_plain(
        "lincomb", [words(v) for v in short], ks, 1, 0))
    assert want == [sum(x[i] * k for x, k in zip(short, kw) if i < len(x))
                    * RINV % R for i in range(n)]
    k2 = fr_poly._pointwise_consts("mul", ks[:1])[0]
    want = from_words(fr_poly._pointwise_plain(
        "mul", [words(ins[0]), words(ins[1])], ks[:1], 1, 0))
    assert want == [mont(mont(x, y), k2) for x, y in zip(ins[0], ins[1])]
    want = from_words(fr_poly._pointwise_plain(
        "gate", [words(v) for v in ins], [], 1, 0))
    assert want == gate_model(ins)


@pytest.mark.parametrize("bits", [0, 3, 6])
@pytest.mark.parametrize("block", [1, 8, 256])
def test_permutation_forms_match_plain(bits, block):
    """perm_z and perm_t2 with beta x from a block's beta hi[h], at
    blocks of 1, 8 and 256 values (the kernel's PW_THREADS divide
    2^DOMAIN_LO_BITS)."""
    n = 1 << bits
    w = ntt_fr.root_of_unity(bits)
    ins = [values(n, 170 + j) for j in range(7)]
    beta, gamma = 12345, R - 2
    tin = [words(v) for v in ins]
    num, den = fr_poly._pointwise_plain("perm_z", tin[:6], [beta, gamma], w,
                                        0)
    assert perm_model("perm_z", ins, beta, gamma, w, 0, block) == (
        from_words(num), from_words(den))
    for shift in {0, 1 % n, 3 % n}:
        want = fr_poly._pointwise_plain("perm_t2", tin, [beta, gamma], w,
                                        shift)
        assert perm_model("perm_t2", ins, beta, gamma, w, shift, block) == \
            from_words(want)


def test_domain_blocks_share_their_high_power():
    """At a domain past 2^DOMAIN_LO_BITS a block of PW_THREADS values
    (at most 2^DOMAIN_LO_BITS, a power of two) reads one hi[h]:
    its beta x = mont(lo[i], beta hi[h]) is beta w^i at its first and
    last values."""
    bits = fr_poly.DOMAIN_LO_BITS + 2
    w = ntt_fr.root_of_unity(bits)
    lo_t, hi_t, lo_bits = fr_poly._domain_tables(bits, w, torch.device("cpu"))
    lo_t, hi_t = from_words(lo_t), from_words(hi_t)
    per = fr_poly.PW_THREADS
    assert per & (per - 1) == 0 and per <= 1 << lo_bits
    beta = 777
    bm = fr_poly._pointwise_consts("perm_z", [beta, 0])[0]
    for blk in (0, 1, (1 << bits) // per - 1, (1 << lo_bits) // per):
        bhi = mont(hi_t[(blk * per) >> lo_bits], bm)
        for i in (blk * per, blk * per + per - 1):
            assert mont(lo_t[i & ((1 << lo_bits) - 1)], bhi) == \
                beta * pow(w, i, R) % R
