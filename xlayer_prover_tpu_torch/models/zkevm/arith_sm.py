"""Arith SM: wide mul-add (A*B + C = D*2^W + E) as a provable circuit.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/arith_sm.py``.
Equivalent of the reference Arith SM's eq0 (src/sm/arith/, generated
sm_arith_eq0.cpp; the EC equations eq1..eq10 follow the same template):
operands decompose into L limbs of `limb_bits` spread over L rows per op
(one limb of every operand per row, like the reference's 16-bit x 16-row
layout), and the schoolbook convolution with carry propagation is enforced
by constraints *gated at each block's first row* that reach the block's
other rows through multi-row column shifts:

    for i in 0..2L-1:
      sum_{j+k=i} a_j*b_k + (c_i if i<L) + carry_{i-1}
          = rhs_i + carry_i * 2^limb_bits,
      rhs_i = e_i (i < L) or d_{i-L}

with carry_{-1} = carry_{2L-1} = 0 and every limb/carry range-checked by
plookup.  Shifts stay inside the block (max shift = rows-1), so the cyclic
domain wrap never crosses ops.  `total_bits=256, limb_bits=16` is the
production geometry; tests use a scaled-down instance of the same code.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...stark.air import AirBuilder, Const


@dataclasses.dataclass
class ArithLayout:
    total_bits: int
    limb_bits: int
    n_limbs: int
    rows_per_op: int
    fixed: dict
    witness: dict


def build(builder: AirBuilder, total_bits: int = 256,
          limb_bits: int = 16) -> ArithLayout:
    assert total_bits % limb_bits == 0
    L = total_bits // limb_bits
    rows_per_op = 2 * L     # carries i = 0..2L-1 live one per row
    base = 1 << limb_bits

    fixed = {
        "FIRST": builder.fixed("AR_FIRST"),
        "RANGE_LIMB": builder.fixed("AR_RANGE_LIMB"),
    }
    w = {name: builder.witness(f"ar_{name}")
         for name in ("a", "b", "c", "d", "e", "carry_lo", "carry_hi")}

    first = fixed["FIRST"]
    # limb range checks (values < 2^limb_bits); carries are bounded by
    # L * 2^limb_bits so they split into two range-checked limbs
    for name in ("a", "b", "c", "d", "e", "carry_lo", "carry_hi"):
        builder.plookup([w[name]], [fixed["RANGE_LIMB"]])

    def limb(col, j):
        return col.shifted(j) if j else col

    def carry_limb(j):
        return limb(w["carry_lo"], j) + limb(w["carry_hi"], j) * base

    for i in range(2 * L):
        conv = None
        for j in range(max(0, i - L + 1), min(L, i + 1)):
            k = i - j
            term = limb(w["a"], j) * limb(w["b"], k)
            conv = term if conv is None else conv + term
        if i < L:
            conv = (conv + limb(w["c"], i)) if conv is not None \
                else limb(w["c"], i)
        if conv is None:       # i = 2L-1: no products reach this column
            conv = Const(0)
        rhs = limb(w["e"], i) if i < L else limb(w["d"], i - L)
        carry_prev = carry_limb(i - 1) if i > 0 else Const(0)
        carry_cur = carry_limb(i)
        expr = conv + carry_prev - rhs - carry_cur * base
        builder.constrain(first * expr)
    # no explicit final-carry constraint needed: with all limbs and carries
    # range-checked, the i = 2L-1 chain equation forces carry_{2L-1} = 0
    # (the residual would be a multiple of 2^{2W} smaller than 2^{2W})
    return ArithLayout(total_bits=total_bits, limb_bits=limb_bits, n_limbs=L,
                       rows_per_op=rows_per_op, fixed=fixed, witness=w)


def fill_fixed(layout: ArithLayout, const_np: np.ndarray):
    n = const_np.shape[0]
    idx = np.arange(n)
    const_np[:, layout.fixed["FIRST"].index] = (idx % layout.rows_per_op == 0)
    base = 1 << layout.limb_bits
    assert base <= n, "range table larger than domain"
    const_np[:, layout.fixed["RANGE_LIMB"].index] = idx % base


def expand_trace(layout: ArithLayout, actions, cm1_np: np.ndarray):
    """actions: (a, b, c) with values < 2^total_bits.  Returns (d, e) per
    action where a*b + c = d*2^total_bits + e."""
    n = cm1_np.shape[0]
    L = layout.n_limbs
    lb = layout.limb_bits
    base = 1 << lb
    mask = base - 1
    rpo = layout.rows_per_op
    assert len(actions) * rpo <= n
    w = layout.witness
    results = []
    for kk, (a, b, c) in enumerate(actions):
        assert a < (1 << layout.total_bits) and b < (1 << layout.total_bits)
        full = a * b + c
        e = full & ((1 << layout.total_bits) - 1)
        d = full >> layout.total_bits
        rowbase = kk * rpo
        # limbs (rows 0..L-1 carry the operand limbs; L..2L-1 zero-padded)
        for r in range(rpo):
            if r < L:
                cm1_np[rowbase + r, w["a"].index] = (a >> (lb * r)) & mask
                cm1_np[rowbase + r, w["b"].index] = (b >> (lb * r)) & mask
                cm1_np[rowbase + r, w["c"].index] = (c >> (lb * r)) & mask
                cm1_np[rowbase + r, w["d"].index] = (d >> (lb * r)) & mask
                cm1_np[rowbase + r, w["e"].index] = (e >> (lb * r)) & mask
        # carries
        carry = 0
        for i in range(2 * L):
            conv = sum(((a >> (lb * j)) & mask) * ((b >> (lb * k)) & mask)
                       for j in range(max(0, i - L + 1), min(L, i + 1))
                       for k in [i - j])
            if i < L:
                conv += (c >> (lb * i)) & mask
            rhs = ((e >> (lb * i)) & mask) if i < L else \
                ((d >> (lb * (i - L))) & mask)
            total = conv + carry - rhs
            assert total % base == 0, (i, total)
            carry = total // base
            assert 0 <= carry < base * base
            cm1_np[rowbase + i, w["carry_lo"].index] = carry % base
            cm1_np[rowbase + i, w["carry_hi"].index] = carry // base
        assert carry == 0, "final carry must be zero"
        results.append((d, e))
    return results
