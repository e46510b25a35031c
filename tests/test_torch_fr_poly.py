"""The fflonk prover's Fr polynomial kernels (``csrc/fr_poly.cu``) on the
CPU: their plain PyTorch versions (``ops/fr_poly._*_plain``, which the
wrappers run on CPU tensors) against the Python-int models
(``_*_model``) and the JAX package's fflonk helpers, exactly, on seeded
inputs with the edges 0, 1, r - 1 and r - 2: every level boundary of the
kernels' schedules (a fr_eval segment of EVAL_SEG values, a fr_scan_mul
segment of SCAN_SEG, a fr_div_binomial segment of LIN_STEPS k), k from 1
to past LIN_MAX_K (the short chains of X^n - 1), broadcast scans, inputs
of their own lengths, each identity of fr_pointwise.  The kernels' own
constants are read out of the source.  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``).
"""

import os
import random
import re

import pytest
import torch

from xlayer_prover_tpu.snark import fflonk as jff
from xlayer_prover_tpu_torch import kernels
from xlayer_prover_tpu_torch.fields.bn254 import R
from xlayer_prover_tpu_torch.ops import fr_poly, ntt_fr
from xlayer_prover_tpu_torch.ops.bn254_mont import from_words, to_words

from tests.torch_cpu import one_torch_thread  # noqa: F401

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "xlayer_prover_tpu_torch", "csrc", "fr_poly.cu")
EDGES = [0, 1, R - 1, R - 2]


def values(n: int, seed: int) -> list:
    rng = random.Random(seed)
    out = [rng.randrange(R) for _ in range(n)]
    out[:min(n, 4)] = EDGES[:min(n, 4)]
    return out


def words(vals):
    return torch.from_numpy(to_words(vals))


def test_constants_match_the_source():
    src = open(CU).read()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))
    for name in ("EVAL_POINTS", "EVAL_SEG", "SCAN_SEG", "LIN_STEPS",
                 "LIN_MAX_K", "PW_INPUTS", "PW_CONSTS"):
        assert define(name) == getattr(fr_poly, name), name
    for op, code in fr_poly.PW_OPS.items():
        assert define(f"PW_{op.upper()}") == code, op
    # every entry point the wrappers call is in the library's table
    assert set(kernels._LIBS["fr_poly"][1]) == set(re.findall(
        r"^int (fr_\w+_launch)\(", src, re.M))
    for name in ("fr_eval", "fr_div_binomial", "fr_scan_mul",
                 "fr_pointwise"):
        assert name in kernels.LAUNCHES


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 65, 300])
def test_eval_plain_matches_model_and_jax(n):
    p = values(n, n)
    xs = EDGES + [random.Random(n).randrange(R)]
    got = fr_poly.evaluate(words(p), xs)
    assert got == [fr_poly._eval_model(p, x) for x in xs]
    assert got == [jff.peval(p, x) for x in xs]


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 33, 200])
def test_scan_mul_plain_matches_model(n):
    x = values(n, 100 + n)
    for exclusive in (False, True):
        for init in (1, R - 1, 12345):
            got = from_words(fr_poly.scan_mul(words(x), exclusive, init))
            assert got == fr_poly._scan_mul_model(x, exclusive, init)
            b = x[-1]
            got = from_words(fr_poly.scan_mul(words([b]), exclusive, init,
                                              n=n))
            assert got == fr_poly._scan_mul_model([b] * n, exclusive, init)
    # the JAX setup's tau powers and its _shift_omega's
    tau = x[-1]
    want = [1] * 8
    for i in range(1, 8):
        want[i] = want[i - 1] * tau % R
    assert from_words(fr_poly.scan_mul(words([tau]), True, n=8)) == want


@pytest.mark.parametrize("n", [1, 3, 8, 9, 17, 40, 129, 260])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 9, 16, 64])
def test_div_binomial_plain_matches_model(n, k):
    p = values(n, 7 * n + k)
    c = random.Random(n * k).choice([0, 1, R - 1, 987654321])
    q, r = fr_poly.div_binomial(words(p), k, c)
    wq, wr = fr_poly._div_binomial_model(p, k, c)
    assert from_words(q) == wq and from_words(r) == wr
    # the JAX package's long division by the same binomial
    jq, jr = jff.pdivmod(p, [(-c) % R] + [0] * (k - 1) + [1])
    assert jff._trim(from_words(q)) == jq
    assert jff._trim(from_words(r)) == jr


def test_div_binomial_exact_raises_on_a_remainder():
    """An exact division (the JAX pdiv_zh's and pdivmod's asserts) raises
    when the remainder is not zero, and not when it is."""
    n = 8
    zh = [R - 1] + [0] * (n - 1) + [1]
    q = values(5, 3)
    prod = jff.pmul(q, zh)
    got, r = fr_poly.div_binomial(words(prod), n, 1, exact=True)
    assert jff._trim(from_words(got)) == jff._trim(q)
    assert from_words(r) == [0] * n
    bad = list(prod)
    bad[2] = (bad[2] + 1) % R
    with pytest.raises(AssertionError):
        fr_poly.div_binomial(words(bad), n, 1, exact=True)
    with pytest.raises(AssertionError, match="Z_H"):
        jff.pdiv_zh(bad, n)
    y = 77
    lin = jff.pmul(q, [(-y) % R, 1])
    fr_poly.div_binomial(words(lin), 1, y, exact=True)
    lin[0] = (lin[0] + 1) % R
    with pytest.raises(AssertionError):
        fr_poly.div_binomial(words(lin), 1, y, exact=True)
    with pytest.raises(ValueError):
        fr_poly.div_binomial(words(lin), 0, y)


@pytest.mark.parametrize("n", [1, 7, 33])
def test_pointwise_plain_matches_model(n):
    ins = [values(n, 50 + j) for j in range(9)]
    ks = values(4, 9)[::-1]
    lens = [n, max(1, n // 2), 1, n]
    short = [v[:m] for v, m in zip(ins, lens)]
    got = fr_poly.pointwise("lincomb", [words(v) for v in short], ks)
    assert from_words(got) == fr_poly._pointwise_model("lincomb", short, ks)
    got = fr_poly.pointwise("mul", [words(ins[0]), words(ins[1])], [ks[0]])
    assert from_words(got) == fr_poly._pointwise_model("mul", ins[:2],
                                                       [ks[0]])
    got = fr_poly.pointwise("gate", [words(v) for v in ins])
    assert from_words(got) == fr_poly._pointwise_model("gate", ins, [])
    with pytest.raises(ValueError):
        fr_poly.pointwise("gate", [words(v) for v in ins[:8]])
    with pytest.raises(ValueError):
        fr_poly.pointwise("nope", [words(ins[0])])


@pytest.mark.parametrize("bits", [0, 1, 3, 6])
def test_pointwise_permutation_matches_model(bits):
    """perm_z's numerator and denominator, perm_t2's z f - z(w x) g, at the
    domain's points w^i (the JAX prover's z column and T2 numerator)."""
    n = 1 << bits
    w = ntt_fr.root_of_unity(bits)
    ins = [values(n, 70 + j) for j in range(7)]
    bg = [12345, R - 2]
    num, den = fr_poly.pointwise("perm_z", [words(v) for v in ins[:6]], bg,
                                 w)
    want_n, want_d = fr_poly._pointwise_model("perm_z", ins[:6], bg, w)
    assert from_words(num) == want_n and from_words(den) == want_d
    for shift in {0, 1 % n, 3 % n}:
        got = fr_poly.pointwise("perm_t2", [words(v) for v in ins], bg, w,
                                shift)
        assert from_words(got) == fr_poly._pointwise_model(
            "perm_t2", ins, bg, w, shift)
    # the JAX prover's z recurrence from the same numerators
    a, b, c, s1, s2, s3 = ins[:6]
    beta, gamma = bg
    doms = fr_poly._domain_model(n, w)
    for i in range(n):
        assert want_n[i] == ((a[i] + beta * doms[i] + gamma)
                             * (b[i] + beta * 2 * doms[i] + gamma)
                             * (c[i] + beta * 3 * doms[i] + gamma)) % R
        assert want_d[i] == ((a[i] + beta * s1[i] + gamma)
                             * (b[i] + beta * s2[i] + gamma)
                             * (c[i] + beta * s3[i] + gamma)) % R
    if n > 1:
        with pytest.raises(ValueError):
            fr_poly.pointwise("perm_z", [words(v) for v in ins[:6]], bg,
                              ntt_fr.root_of_unity(bits + 1))


def test_domain_tables_make_the_powers():
    """The kernel's domain point lo[i mod 2^lo] hi[i >> lo] / 2^256 is
    w^i (lo canonical, hi Montgomery form)."""
    mont_inv = pow(1 << 256, R - 2, R)
    for bits in (0, 3, fr_poly.DOMAIN_LO_BITS + 2):
        w = ntt_fr.root_of_unity(bits)
        lo, hi, lo_bits = fr_poly._domain_tables(bits, w, torch.device("cpu"))
        lo, hi = from_words(lo), from_words(hi)
        for i in {0, 1 % (1 << bits), (1 << bits) - 1, (1 << bits) // 3}:
            x = lo[i & ((1 << lo_bits) - 1)] * hi[i >> lo_bits] \
                * mont_inv % R
            assert x == pow(w, i, R)


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        fr_poly.evaluate(torch.zeros((3, 2), dtype=torch.int64), [1])
    with pytest.raises(ValueError):
        fr_poly.scan_mul(words([1, 2]), n=4)
    with pytest.raises(ValueError):
        fr_poly.pointwise("mul", [words([1, 2]), words([1])], [1])
    assert fr_poly.evaluate(words([5]), []) == []
    assert from_words(fr_poly.scan_mul(words([]))) == []
