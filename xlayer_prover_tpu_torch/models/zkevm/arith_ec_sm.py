"""Arith EC equations (eq1..eq10) as a provable circuit.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/arith_ec_sm.py``.
Equivalent of the reference Arith SM's elliptic-curve and BN254-complex
equation kernels (src/sm/arith/sm_arith_eq1.cpp..eq10.cpp, selector and
carry mechanics of arith_executor.cpp:456-516):

  * secp256k1 point add (different points): selEq1 -> eq1 (slope), with
    selEq3 -> eq3/eq4 (x3/y3);
  * secp256k1 point double: selEq2 -> eq2 (slope), with selEq3;
  * BN254 Fp2 complex mul/add/sub: selMul/selAdd/selSub -> eq5..eq10.

Geometry follows the repo's Arith eq0 circuit (arith_sm.py), not the
reference's 16-column registers: every 256-bit operand is ONE witness
column whose limb j lives at block row j (L = 256/limb_bits limbs,
2L rows per action); the schoolbook convolution identities are gated at
each block's first row and reach the other rows through static multi-row
shifts.  The q quotients carry their worst-case offsets (2^257..2^259,
4, 8 — the reference kernels' `offset` headers) and get L+1 limbs; each
of the (up to) three active equations drives its own signed carry chain
(carry = lo + hi*2^lb - 2^(2lb-1), both limbs range-checked).

Two side arguments mirror the reference executor's guards:
  * selEq1 requires x2 != x1 (arith_executor.cpp xAreDifferent): a
    marker/inverse chain proves some limb differs;
  * x3/y3 must be alias-free (< p of the active curve,
    arith_executor.cpp chunkLtPrime/valueLtPrime): a most-significant-
    first lexicographic compare with an equality-prefix chain.

The Main SM binds {kind, x1, y1, x2, y2, x3, y3} at each block's first
row (zkevm_air; kind = arithEq flag index).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...fields import gl
from ...stark.air import AirBuilder, Col, Const

P_GL = gl.P
SECP_P = 2 ** 256 - 2 ** 32 - 977
BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583

STREAMS = ("x1", "y1", "x2", "y2", "x3", "y3", "s", "q0", "q1", "q2")
SELS = ("sel1", "sel2", "sel3", "selMul", "selAdd", "selSub")

# (family -> list of equations); each equation:
#   (sel, chain, [(coef, colA, colB-or-None), ...], (q_col, q_sign), p, offset)
# expressing:  sum(terms) + q_sign*(q*p) - q_sign*(offset*p) = 0
EQUATIONS = [
    ("sel1", 0, [(1, "s", "x2"), (-1, "s", "x1"), (-1, "y2", None),
                 (1, "y1", None)], ("q0", -1), SECP_P, 1 << 257),
    ("sel2", 0, [(2, "s", "y1"), (-3, "x1", "x1")],
     ("q0", 1), SECP_P, 1 << 258),
    ("sel3", 1, [(1, "s", "s"), (-1, "x1", None), (-1, "x2", None),
                 (-1, "x3", None)], ("q1", -1), SECP_P, 4),
    ("sel3", 2, [(1, "s", "x1"), (-1, "s", "x3"), (-1, "y1", None),
                 (-1, "y3", None)], ("q2", 1), SECP_P, 1 << 257),
    ("selMul", 1, [(1, "x1", "x2"), (-1, "y1", "y2"), (-1, "x3", None)],
     ("q1", 1), BN_P, 1 << 259),
    ("selMul", 2, [(1, "y1", "x2"), (1, "x1", "y2"), (-1, "y3", None)],
     ("q2", -1), BN_P, 8),
    ("selAdd", 1, [(1, "x1", None), (1, "x2", None), (-1, "x3", None)],
     ("q1", -1), BN_P, 8),
    ("selAdd", 2, [(1, "y1", None), (1, "y2", None), (-1, "y3", None)],
     ("q2", -1), BN_P, 8),
    ("selSub", 1, [(1, "x1", None), (-1, "x2", None), (-1, "x3", None)],
     ("q1", 1), BN_P, 8),
    ("selSub", 2, [(1, "y1", None), (-1, "y2", None), (-1, "y3", None)],
     ("q2", 1), BN_P, 8),
]

# Main SM kind -> (selectors on, prime for the alias check)
KINDS = {1: ("sel1", "sel3"), 2: ("sel2", "sel3"),
         3: ("selMul",), 4: ("selAdd",), 5: ("selSub",)}


@dataclasses.dataclass
class ArithEcLayout:
    limb_bits: int
    n_limbs: int
    rows_per_op: int
    fixed: dict
    witness: dict

    def kind_expr(self):
        w = self.witness
        return (w["sel1"] + w["sel2"] * 2 + w["selMul"] * 3
                + w["selAdd"] * 4 + w["selSub"] * 5)

    def limb32(self, name: str, j: int):
        """32-bit limb j of a stream, anchored at the block's first row."""
        cpl = 32 // self.limb_bits
        expr = None
        for k in range(cpl):
            sh = j * cpl + k
            col = self.witness[name].shifted(sh) if sh else self.witness[name]
            term = col * Const(1 << (self.limb_bits * k))
            expr = term if expr is None else expr + term
        return expr


def _chunks(v: int, lb: int, n: int):
    mask = (1 << lb) - 1
    return [(v >> (lb * j)) & mask for j in range(n)]


def _const_cols(p: int, offset: int, lb: int, n_cols: int):
    """offset*p decomposed into lb-bit column constants; the top column
    absorbs the remainder (constants may exceed lb bits)."""
    v = offset * p
    cols = _chunks(v, lb, n_cols - 1)
    cols.append(v >> (lb * (n_cols - 1)))
    assert sum(c << (lb * j) for j, c in enumerate(cols)) == v
    return cols


def build(b: AirBuilder, limb_bits: int, range_table: Col) -> ArithEcLayout:
    lb = limb_bits
    L = 256 // lb
    rpo = 2 * L
    base = 1 << lb

    fixed = {
        "EC_FIRST": b.fixed("EC_FIRST"),
        "EC_BLAST": b.fixed("EC_BLAST"),
        "EC_PSEC": b.fixed("EC_PSEC"),
        "EC_PBN": b.fixed("EC_PBN"),
    }
    w = {}
    for name in STREAMS + SELS:
        w[name] = b.witness(f"ec_{name}")
    for c in range(3):
        w[f"cLo{c}"] = b.witness(f"ec_cLo{c}")
        w[f"cHi{c}"] = b.witness(f"ec_cHi{c}")
    for name in ("isDiff", "dInv", "df", "scanVal", "isLt", "isEq",
                 "eqAcc", "ltDiff"):
        w[name] = b.witness(f"ec_{name}")

    one = Const(1)
    first = fixed["EC_FIRST"]
    blast = fixed["EC_BLAST"]

    def sh(name, j):
        return w[name].shifted(j) if j else w[name]

    # selector structure
    for s in SELS:
        b.constrain(w[s] * (w[s] - one))
        b.constrain((one - blast) * (w[s].shifted() - w[s]))
    b.constrain(w["sel1"] * w["sel2"])
    slope = w["sel1"] + w["sel2"]
    bn = w["selMul"] + w["selAdd"] + w["selSub"]
    b.constrain(slope * (one - w["sel3"]))       # slope eqs need eq3/eq4
    b.constrain(w["sel3"] * (one - slope))       # and vice versa
    b.constrain(w["sel3"] * bn)
    b.constrain(w["selMul"] * w["selAdd"])
    b.constrain(w["selMul"] * w["selSub"])
    b.constrain(w["selAdd"] * w["selSub"])

    # range checks
    for name in STREAMS:
        b.plookup([w[name]], [range_table])
    for c in range(3):
        b.plookup([w[f"cLo{c}"]], [range_table])
        b.plookup([w[f"cHi{c}"]], [range_table])

    carry_off = 1 << (2 * lb - 1)

    def carry(c, i):
        return (sh(f"cLo{c}", i) + sh(f"cHi{c}", i) * base
                - Const(carry_off))

    # the equation chains
    for sel, chain, terms, (qc, qsign), p, offset in EQUATIONS:
        p_ch = _chunks(p, lb, L)
        consts = _const_cols(p, offset, lb, rpo)
        gate = first * w[sel]
        for i in range(rpo):
            expr = Const(0)
            for coef, a, bb in terms:
                if bb is None:
                    if i < L:
                        expr = expr + Const(coef % P_GL) * sh(a, i)
                else:
                    for j in range(max(0, i - L + 1), min(L, i + 1)):
                        expr = expr + Const(coef % P_GL) * sh(a, j) \
                            * sh(bb, i - j)
            # q * p convolution (q has L+1 limbs)
            for j in range(max(0, i - L + 1), min(L + 1, i + 1)):
                k = i - j
                if k < L and p_ch[k]:
                    expr = expr + Const((qsign * p_ch[k]) % P_GL) * sh(qc, j)
            expr = expr + Const((-qsign * consts[i]) % P_GL)
            if i > 0:
                expr = expr + carry(chain, i)
            if i < rpo - 1:
                expr = expr - carry(chain, i + 1) * base
            b.constrain(gate * expr)

    # x2 != x1 for point addition (some limb differs)
    b.constrain(w["isDiff"] * (w["isDiff"] - one))
    b.constrain(w["isDiff"] * ((w["x2"] - w["x1"]) * w["dInv"] - one))
    b.constrain(first * (w["df"] - w["isDiff"]))
    for j in range(1, L):
        b.constrain(first * (sh("df", j) - sh("df", j - 1)
                             - (one - sh("df", j - 1)) * sh("isDiff", j)))
    b.constrain(first * w["sel1"] * (sh("df", L - 1) - one))

    # x3/y3 alias-free: lexicographic compare against the active prime,
    # scanning most-significant limb first (rows 0..L-1 = x3, L.. = y3)
    chk = w["sel3"] + bn
    pm = w["sel3"] * fixed["EC_PSEC"] + bn * fixed["EC_PBN"]
    for name in ("isLt", "isEq"):
        b.constrain(w[name] * (w[name] - one))
    b.constrain(w["isEq"] * (w["scanVal"] - pm))
    b.constrain(w["ltDiff"] - w["isLt"] * (pm - one - w["scanVal"])
                - (one - w["isLt"]) * (w["scanVal"] - pm))
    b.plookup([w["ltDiff"]], [range_table])
    for j in range(L):
        b.constrain(first * (sh("scanVal", j) - sh("x3", L - 1 - j)))
        b.constrain(first * (sh("scanVal", L + j) - sh("y3", L - 1 - j)))
    for half in (0, L):
        b.constrain(first * (sh("eqAcc", half) - sh("isEq", half)))
        for j in range(half + 1, half + L):
            b.constrain(first * (sh("eqAcc", j)
                                 - sh("eqAcc", j - 1) * sh("isEq", j)))
        lt_sum = sh("isLt", half)
        for j in range(half + 1, half + L):
            lt_sum = lt_sum + sh("eqAcc", j - 1) * sh("isLt", j)
        b.constrain(first * chk * (lt_sum - one))

    return ArithEcLayout(limb_bits=lb, n_limbs=L, rows_per_op=rpo,
                         fixed=fixed, witness=w)


def fill_fixed(layout: ArithEcLayout, const_np: np.ndarray):
    n = const_np.shape[0]
    f = layout.fixed
    lb, L, rpo = layout.limb_bits, layout.n_limbs, layout.rows_per_op
    idx = np.arange(n, dtype=np.uint64)
    const_np[:, f["EC_FIRST"].index] = (idx % rpo == 0)
    const_np[:, f["EC_BLAST"].index] = (idx % rpo == rpo - 1)
    sec = _chunks(SECP_P, lb, L)
    bnc = _chunks(BN_P, lb, L)
    scan = (L - 1 - (idx % rpo) % L).astype(np.int64)
    const_np[:, f["EC_PSEC"].index] = np.array(sec, dtype=np.uint64)[scan]
    const_np[:, f["EC_PBN"].index] = np.array(bnc, dtype=np.uint64)[scan]


def compute_witness(kind: int, x1: int, y1: int, x2: int, y2: int,
                    x3: int, y3: int):
    """Host oracle: (s, q0, q1, q2) with the reference offsets
    (arith_executor.cpp:137-355)."""
    s = q0 = q1 = q2 = 0
    if kind in (1, 2):
        p = SECP_P
        if kind == 1:
            assert (x2 - x1) % p != 0, "ECADD x1 == x2"
            s = ((y2 - y1) * pow(x2 - x1, -1, p)) % p
            pq0 = s * x2 - s * x1 - y2 + y1
            q0, r = divmod(pq0, p)
            assert r == 0
            q0 += 1 << 257
        else:
            s = (3 * x1 * x1 * pow(2 * y1, -1, p)) % p
            pq0 = 2 * s * y1 - 3 * x1 * x1
            q0, r = divmod(-pq0, p)
            assert r == 0
            q0 += 1 << 258
        pq1 = s * s - x1 - x2 - x3
        q1, r = divmod(pq1, p)
        assert r == 0
        q1 += 4
        pq2 = s * x1 - s * x3 - y1 - y3
        q2, r = divmod(-pq2, p)
        assert r == 0
        q2 += 1 << 257
    elif kind == 3:
        pq1 = x1 * x2 - y1 * y2 - x3
        q1, r = divmod(-pq1, BN_P)
        assert r == 0
        q1 += 1 << 259
        pq2 = y1 * x2 + x1 * y2 - y3
        q2, r = divmod(pq2, BN_P)
        assert r == 0
        q2 += 8
    elif kind == 4:
        q1, r = divmod(x1 + x2 - x3, BN_P)
        assert r == 0
        q1 += 8
        q2, r = divmod(y1 + y2 - y3, BN_P)
        assert r == 0
        q2 += 8
    elif kind == 5:
        q1, r = divmod(-(x1 - x2 - x3), BN_P)
        assert r == 0
        q1 += 8
        q2, r = divmod(-(y1 - y2 - y3), BN_P)
        assert r == 0
        q2 += 8
    else:
        raise ValueError(kind)
    assert q0 >= 0 and q1 >= 0 and q2 >= 0
    return s, q0, q1, q2


def expand_into(layout: ArithEcLayout, actions: List[tuple],
                cm1_np: np.ndarray):
    """actions: (kind, x1, y1, x2, y2, x3, y3), kind in 1..5 (1 = EC add
    different, 2 = EC double with x2 = x1, y2 = y1 already substituted,
    3/4/5 = BN254 complex mul/add/sub)."""
    n = cm1_np.shape[0]
    lb, L, rpo = layout.limb_bits, layout.n_limbs, layout.rows_per_op
    base = 1 << lb
    carry_off = 1 << (2 * lb - 1)
    assert len(actions) * rpo <= n, "too many EC arith actions"
    w = layout.witness
    sec = _chunks(SECP_P, lb, L)
    bnc = _chunks(BN_P, lb, L)

    for kk, (kind, x1, y1, x2, y2, x3, y3) in enumerate(actions):
        rb = kk * rpo
        s, q0, q1, q2 = compute_witness(kind, x1, y1, x2, y2, x3, y3)
        vals = {"x1": x1, "y1": y1, "x2": x2, "y2": y2, "x3": x3,
                "y3": y3, "s": s, "q0": q0, "q1": q1, "q2": q2}
        ch = {name: _chunks(v, lb, L + 1) for name, v in vals.items()}
        for name in STREAMS:
            nl = L + 1 if name.startswith("q") else L
            assert vals[name] < (1 << (lb * nl)), (name, kind)
            for j in range(nl):
                cm1_np[rb + j, w[name].index] = ch[name][j]
        sels = KINDS[kind]
        for sname in sels:
            cm1_np[rb:rb + rpo, w[sname].index] = 1

        # carries per active equation
        for sel, chain, terms, (qc, qsign), p, offset in EQUATIONS:
            if sel not in sels:
                continue
            p_ch = _chunks(p, lb, L)
            consts = _const_cols(p, offset, lb, rpo)
            c = 0
            for i in range(rpo):
                e = 0
                for coef, a, bb in terms:
                    if bb is None:
                        if i < L:
                            e += coef * ch[a][i]
                    else:
                        for j in range(max(0, i - L + 1), min(L, i + 1)):
                            e += coef * ch[a][j] * ch[bb][i - j]
                for j in range(max(0, i - L + 1), min(L + 1, i + 1)):
                    k = i - j
                    if k < L:
                        e += qsign * p_ch[k] * ch[qc][j]
                e -= qsign * consts[i]
                tot = e + c
                assert tot % base == 0, (sel, chain, i)
                c = tot // base
                if i < rpo - 1:
                    cp = c + carry_off
                    assert 0 <= cp < base * base, (sel, i, c)
                    cm1_np[rb + i + 1, w[f"cLo{chain}"].index] = cp % base
                    cm1_np[rb + i + 1, w[f"cHi{chain}"].index] = cp // base
            assert c == 0, (sel, chain, "final carry")

        # x2 != x1 marker chain (only constrained under sel1; fill always)
        df = 0
        for j in range(L):
            d = (ch["x2"][j] - ch["x1"][j]) % P_GL
            isd = 1 if d else 0
            cm1_np[rb + j, w["isDiff"].index] = isd
            if isd:
                cm1_np[rb + j, w["dInv"].index] = gl.host_inv(d)
            df = df or isd
            cm1_np[rb + j, w["df"].index] = df

        # alias-free scan
        pm_ch = sec if kind in (1, 2) else bnc
        for half, src in ((0, "x3"), (L, "y3")):
            eq_acc = 1
            for j in range(L):
                limb = ch[src][L - 1 - j]
                pmv = pm_ch[L - 1 - j]
                is_eq = 1 if limb == pmv else 0
                is_lt = 1 if limb < pmv else 0
                row = rb + half + j
                cm1_np[row, w["scanVal"].index] = limb
                cm1_np[row, w["isEq"].index] = is_eq
                cm1_np[row, w["isLt"].index] = is_lt
                cm1_np[row, w["ltDiff"].index] = \
                    (pmv - 1 - limb) if is_lt else (limb - pmv)
                eq_acc = eq_acc and is_eq
                cm1_np[row, w["eqAcc"].index] = eq_acc
                if is_lt:
                    # past the first strict-less limb nothing more counts;
                    # keep filling honestly (constraints stay satisfied)
                    pass

    # unused carry cells encode carry = 0
    used = len(actions) * rpo
    lo0 = carry_off % base
    hi0 = carry_off // base
    for c in range(3):
        col_lo, col_hi = w[f"cLo{c}"].index, w[f"cHi{c}"].index
        zero_lo = cm1_np[:used, col_lo] == 0
        zero_hi = cm1_np[:used, col_hi] == 0
        both = zero_lo & zero_hi
        cm1_np[:used, col_lo][both] = lo0
        cm1_np[:used, col_hi][both] = hi0
        cm1_np[used:, col_lo] = lo0
        cm1_np[used:, col_hi] = hi0
    return len(actions)
