"""The Poseidon-BN254 kernels' arithmetic and schedule, on the CPU.

``poseidon_bn254.cu`` keeps a state in the registers of a group of lanes
and sums each dot product exactly before one Montgomery reduction
(``bn254.cuh`` fr_mac_wide, fr_sqr_wide, fr_redc_wide, fr_canon).  The step
model ``_permute_model`` / ``_leaf_hash_model`` runs that schedule on
Python ints and asserts every bound the code relies on; here it is held
against ``host_permute``, the plain version and the JAX package at every
width, on extreme states and at every group size the source allows.  The
new helpers' PTX is read out of ``bn254.cuh`` and run by a small
interpreter of its carry chains, against the model's steps, with each
dropped carry checked to be zero.  No JAX reaches the port: the JAX
package is only the reference."""

import os
import re

import numpy as np
import pytest
import torch

from xlayer_prover_tpu.ops import poseidon_bn254 as jpbn
from xlayer_prover_tpu.stark import commitment as jcommit
from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn
from xlayer_prover_tpu_torch.ops.bn254_mont import from_words, to_words

from tests.torch_cpu import one_torch_thread  # noqa: F401

P = pbn.P
M32 = (1 << 32) - 1
CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "xlayer_prover_tpu_torch", "csrc")


def extreme_states(t: int, rng) -> list:
    """All lanes r - 1, 0, r, 2^256 - 1; mixed; and seeded states."""
    top = (1 << 256) - 1
    mixed = [(P - 1, 0, P, top, 1)[k % 5] for k in range(t)]
    return [[P - 1] * t, [0] * t, [P] * t, [top] * t, mixed] + [
        [int.from_bytes(rng.bytes(32), "little") for _ in range(t)]
        for _ in range(2)]


@pytest.mark.parametrize("t", range(2, 18))
def test_model_matches_host_and_jax(t):
    rng = np.random.default_rng(300 + t)
    states = extreme_states(t, rng)
    for st in states:
        want = jpbn.permute(st)
        assert pbn.host_permute(st) == want
        assert pbn._permute_model(st) == want
    got = pbn.permute(torch.from_numpy(to_words(
        [v for st in states[:3] for v in st])).reshape(3, t, 4), t)
    assert from_words(got) == [v for st in states[:3]
                               for v in jpbn.permute(st)]


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("t", [3, 5, 14, 17])
def test_model_at_other_group_sizes(t, g):
    """The split over 1, 2 and 8 lanes (slots past t at t = 3, 14; the
    kernels run t <= 5 at 1 lane and small batches at 8) computes the same
    permutation."""
    rng = np.random.default_rng(400 + t)
    st = extreme_states(t, rng)[4]
    assert pbn._permute_model(st, g) == pbn.host_permute(st)


def test_split_and_join():
    vals = list(range(100, 117))
    lanes = pbn._split(vals, 17, 4)
    assert [ln[0] for ln in lanes] == [100] * 4
    assert lanes[1] == [100, 102, 106, 110, 114]
    assert pbn._join(lanes, 17) == vals
    lanes = pbn._split(vals[:14], 14, 4)      # 13 lanes over 4: padding
    assert lanes[1][1:] == [102, 106, 110, 0]
    assert lanes[0][1:] == [101, 105, 109, 113]
    assert pbn._join(lanes, 14) == vals[:14]


@pytest.mark.parametrize("width", [1, 4, 5, 6, 39, 51, 60, 519])
def test_leaf_hash_model(width):
    rng = np.random.default_rng(500 + width)
    rows = rng.integers(0, 1 << 64, size=(3, width), dtype=np.uint64,
                        endpoint=False)
    rows[0] = (1 << 64) - 1
    rows[1, ::2] = 0
    for row in rows:
        ints = [int(v) for v in row]
        want = jcommit.leaf_hash_bn128(ints)
        assert pbn.leaf_hash_host(ints) == want
        assert pbn._leaf_hash_model(ints) == want
    got = pbn.leaf_hash(torch.from_numpy(rows.view(np.int64)), width)
    assert from_words(got) == [jcommit.leaf_hash_bn128([int(v) for v in r])
                               for r in rows]


def test_wide_products_and_square():
    rng = np.random.default_rng(7)
    top = (1 << 256) - 1
    vals = [0, 1, P - 1, P, top, top - (1 << 128)] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(20)]
    for a in vals:
        assert pbn._sqr_wide(a) == a * a
        for b in vals[:8]:
            assert pbn._mul_wide(a, b) == a * b


def test_lazy_reduction_bounds():
    """The worst sums the kernels reduce: 17 products of r - 1 (a dot
    product at t = 17), one product with the largest addend, and S_lo at
    its most; y - q r stays in [0, 2r) for every top word."""
    inv = pow(pbn.MONT_R, -1, P)
    worst = 17 * (P - 1) ** 2
    assert worst < 1 << 512
    for s in (worst, worst - (worst % pbn.MONT_R) + pbn.MONT_R - 1,
              (P - 1) ** 2, 0, pbn.MONT_R - 1):
        assert pbn._redc_wide(s) == s * inv % P
        assert pbn._redc_wide(s % (P * P), P - 1) == \
            (s % (P * P) * inv + P - 1) % P
    r7 = P >> 224
    tops = {0, M32, r7, r7 + 1} | {k * (r7 + 1) + d for k in range(1, 6)
                                   for d in (-1, 0, 1)}
    for y7 in sorted(v for v in tops if 0 <= v <= M32):
        for low in (0, (1 << 224) - 1, P & ((1 << 224) - 1)):
            y = (y7 << 224) | low
            assert pbn._canon(y) == y % P
    for k in range(6):                       # y at and around k r
        for d in (-1, 0, 1):
            y = k * P + d
            if 0 <= y < 1 << 256:
                assert pbn._canon(y) == y % P


def test_constants_read_out_of_the_sources():
    """The group sizes and the partial-round counts of poseidon_bn254.cu."""
    text = open(os.path.join(CSRC, "poseidon_bn254.cu")).read()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", text).group(1))

    assert define("GROUP") == pbn.GROUP
    assert define("GROUP_FEW") == pbn.GROUP_FEW
    assert define("SMALL_T") == pbn.SMALL_T
    nrp = re.search(r"constexpr int nrp\[16\] = \{([^}]*)\}", text)
    assert [int(v) for v in nrp.group(1).split(",")] == pbn.N_ROUNDS_P


def test_device_table_is_cached():
    """The constant table is copied to a device once per (t, device)."""
    a = pbn._device_table(17, torch.device("cpu"))
    b = pbn._device_table(17, torch.device("cpu"))
    assert a is b
    assert a.numpy().view(np.uint32).tobytes() == \
        pbn.kernel_table(17).tobytes()


# ---------------------------------------------------------------------------
# The PTX of bn254.cuh's wide arithmetic, interpreted
# ---------------------------------------------------------------------------

def _asm_blocks(name: str) -> list:
    """[(instructions, [(constraint, expression)])] of each asm statement
    in bn254.cuh's function `name`."""
    text = open(os.path.join(CSRC, "bn254.cuh")).read()
    start = re.search(rf"\bvoid {name}\(", text).start()
    body = text[start:text.index("\n}\n", start)]
    out = []
    for m in re.finditer(r"asm\((.*?)\);", body, re.S):
        src = m.group(1)
        head, _, operands = src.partition(":")
        code = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', head))
        code = code.replace("\\n", "\n").replace("\\t", "")
        ops = re.findall(r'"([=+]?r)"\(([^()]*)\)', operands)
        out.append(([ln.strip().rstrip(";") for ln in code.split("\n")
                     if ln.strip()], ops))
    return out


def _run_ptx(block, env: dict):
    """Run one asm block on Python ints.  Operand expressions are looked
    up in `env` (``x[k]`` or ``x``); a carry or borrow that an instruction
    without .cc would drop must be zero."""
    code, ops = block

    def ref(expr):
        m = re.fullmatch(r"(\w+)\s*\[(\d+)\]", expr.strip())
        return (m.group(1), int(m.group(2))) if m else (expr.strip(), None)

    def get(expr):
        name, k = ref(expr)
        if name.rstrip("u").isdigit():
            return int(name.rstrip("u"))
        return env[name][k] if k is not None else env[name]

    regs = [get(e) if c != "=r" else None for c, e in ops]
    cf = 0

    def val(tok):
        return regs[int(tok[1:])] if tok.startswith("%") else int(tok, 0)

    for ins in code:
        op, args = ins.split(None, 1)
        args = [a.strip() for a in args.split(",")]
        a, b = val(args[1]), val(args[2])
        parts = op.split(".")
        if parts[0] in ("mul", "mad", "madc"):
            prod = a * b
            x = prod & M32 if parts[1] == "lo" else prod >> 32
            s = x + (val(args[3]) if parts[0] != "mul" else 0)
            s += cf if parts[0] == "madc" else 0
        elif parts[0] in ("add", "addc"):
            s = a + b + (cf if parts[0] == "addc" else 0)
        else:                                   # sub, subc: borrow
            s = a - b - (cf if parts[0] == "subc" else 0)
        if "cc" in parts:
            cf = 1 if (s >> 32) != 0 else 0
        else:
            assert 0 <= s <= M32, f"{ins}: dropped carry"
        regs[int(args[0][1:])] = s & M32
    for (c, e), v in zip(ops, regs):
        if c != "r":
            name, k = ref(e)
            env[name][k] = v


def _words8(v, n=8):
    return [(v >> (32 * k)) & M32 for k in range(n)]


def _int(ws):
    return sum(w << (32 * k) for k, w in enumerate(ws))


def _ptx_mul_wide(a, b):
    (row,) = _asm_blocks("wide_mac_row")
    p = [0] * 16
    for i, bi in enumerate(_words8(b)):
        env = {"q": p[i:i + 9], "a": _words8(a), "b": bi}
        _run_ptx(row, env)
        p[i:i + 9] = env["q"]
    return _int(p)


def _ptx_sqr_wide(a):
    (sq,) = _asm_blocks("fr_sqr_wide")
    env = {"p": [0] * 16, "a": _words8(a)}
    _run_ptx(sq, env)
    return _int(env["p"])


def _ptx_add(name, x, y, n):
    (blk,) = _asm_blocks(name)
    key = "acc" if name == "wide_add" else "r"
    env = {"acc": _words8(x, n), "p": _words8(y, n), "a": _words8(x, n),
           "b": _words8(y, n), "r": [0] * n}
    _run_ptx(blk, env)
    return _int(env[key])


def _ptx_canon(y):
    qp_blk, sub_blk = _asm_blocks("fr_canon")
    q = (y >> 224) // ((P >> 224) + 1)
    env = {"p": _words8(P), "q": q, "qp": [0] * 8, "y": _words8(y),
           "d": [0] * 8}
    _run_ptx(qp_blk, env)
    _run_ptx(sub_blk, env)
    d = _int(env["d"])
    return d - P if d >= P else d            # mont_reduce_once


def _ptx_redc(s, add):
    (row,) = _asm_blocks("mont_mac_row")
    t = _words8(s & ((1 << 256) - 1)) + [0, 0]
    for _ in range(8):
        env = {"t": t, "a": _words8(P), "b": t[0] * pbn.MONT_N0INV & M32}
        _run_ptx(row, env)
        assert env["t"][0] == 0
        t = env["t"][1:] + [0]
    y = _ptx_add("add8", _int(t[:8]), s >> 256, 8)
    return _ptx_canon(_ptx_add("add8", y, add, 8))


def test_ptx_of_the_wide_helpers_matches_the_model():
    rng = np.random.default_rng(11)
    top = (1 << 256) - 1
    vals = [0, 1, P - 1, top] + [int.from_bytes(rng.bytes(32), "little")
                                 for _ in range(6)]
    for a in vals:
        assert _ptx_sqr_wide(a) == pbn._sqr_wide(a) == a * a
        for b in vals[:5]:
            assert _ptx_mul_wide(a, b) == pbn._mul_wide(a, b) == a * b
    worst = 17 * (P - 1) ** 2
    assert _ptx_add("wide_add", worst - (P - 1) ** 2, (P - 1) ** 2, 16) == \
        worst
    r7 = P >> 224
    for y7 in (0, r7, r7 + 1, 2 * r7 + 1, 4 * r7 + 4, 5 * r7 + 5, M32):
        for low in (0, (1 << 224) - 1):
            y = (y7 << 224) | low
            assert _ptx_canon(y) == pbn._canon(y) == y % P
    for s, add in ((worst, 0), ((P - 1) ** 2, P - 1), (0, 0),
                   ((P - 1) * (top % P), 12345)):
        assert _ptx_redc(s, add) == pbn._redc_wide(s, add)
