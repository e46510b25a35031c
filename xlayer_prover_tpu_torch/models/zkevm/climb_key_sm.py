"""ClimbKey SM: provable key-climbing table.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/climb_key_sm.py``,
the re-design of the reference ClimbKey SM (src/sm/climb_key/
climb_key_executor.cpp; consumed by the Storage SM through a lookup).  One
row per climb operation instead of the reference's chunked multi-row
layout: each row proves

    out[level % 4] = 2 * in[level % 4] + bit,   out[j] = in[j] otherwise,

with the climbed limb's pre-image range-bounded so the doubling is a true
INTEGER relation (no Goldilocks wrap): the reference guards
``limb > PRE_CLIMB_UP_LIMIT`` (storage_executor.cpp climbRkey handling);
here the selected input limb is proven <= LIMIT = (p-1)/2 via a dual
63-bit chunk decomposition — both ``in_sel`` and ``LIMIT - in_sel`` must
decompose into 3x16-bit + 1x15-bit chunks, which is satisfiable exactly
when 0 <= in_sel <= LIMIT as integers (any field wrap of either quantity
needs 64 bits).

Columns: in0..3 / out0..3 (quads), level, q + lsel0..3 (level = 4q + r,
one-hot r), bit, active, and the two chunk vectors.  The Storage SM's
CLIMB_RKEY / CLIMB_SIBLING_RKEY rows look up
(in, level, bit, out) against this table.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ...fields import gl
from ...stark.air import AirBuilder, Const

P = gl.P
LIMIT = (P - 1) // 2          # 0x7FFFFFFF80000000


@dataclasses.dataclass
class ClimbKeyLayout:
    fixed: dict
    witness: dict
    range_bits: int


def build(b: AirBuilder, n_bits: int,
          range_table=None) -> ClimbKeyLayout:
    """Add the ClimbKey column group + constraints.

    range_table: an existing 16-bit fixed range column to share (e.g. the
    Main SM's M_RANGE when n_bits >= 16); when None a dedicated
    min(16, n_bits)-bit table CK_RANGE is created.
    """
    rb = min(16, n_bits)
    fixed = {}
    if range_table is None:
        fixed["CK_RANGE"] = b.fixed("CK_RANGE")
        range_table = fixed["CK_RANGE"]
    w = {}
    for j in range(4):
        w[f"in{j}"] = b.witness(f"ck_in{j}")
        w[f"out{j}"] = b.witness(f"ck_out{j}")
        w[f"lsel{j}"] = b.witness(f"ck_lsel{j}")
    for name in ("level", "q", "bit", "active"):
        w[name] = b.witness(f"ck_{name}")
    n_chunks = -(-63 // rb)
    for k in range(n_chunks):
        w[f"c{k}"] = b.witness(f"ck_c{k}")
        w[f"d{k}"] = b.witness(f"ck_d{k}")

    one = Const(1)
    # booleans
    for name in ("bit", "active"):
        b.constrain(w[name] * (w[name] - one))
    sel_sum = None
    for j in range(4):
        s = w[f"lsel{j}"]
        b.constrain(s * (s - one))
        sel_sum = s if sel_sum is None else sel_sum + s
    b.constrain(sel_sum - w["active"])
    b.constrain(w["bit"] * (one - w["active"]))

    # level = 4q + r with one-hot r
    r_expr = None
    for j in range(4):
        t = w[f"lsel{j}"] * Const(j)
        r_expr = t if r_expr is None else r_expr + t
    b.constrain(w["level"] - Const(4) * w["q"] - r_expr)
    b.plookup([w["q"]], [range_table])

    # climb relation per limb
    for j in range(4):
        s = w[f"lsel{j}"]
        b.constrain(w[f"out{j}"] - s * (Const(2) * w[f"in{j}"] + w["bit"])
                    - (one - s) * w[f"in{j}"])

    # selected input limb and its range bound in_sel <= LIMIT
    in_sel = None
    for j in range(4):
        t = w[f"lsel{j}"] * w[f"in{j}"]
        in_sel = t if in_sel is None else in_sel + t
    c_acc = None
    d_acc = None
    for k in range(n_chunks):
        bits_k = min(rb, 63 - rb * k)
        c_acc = (w[f"c{k}"] * Const(1 << (rb * k))
                 if c_acc is None else c_acc
                 + w[f"c{k}"] * Const(1 << (rb * k)))
        d_acc = (w[f"d{k}"] * Const(1 << (rb * k))
                 if d_acc is None else d_acc
                 + w[f"d{k}"] * Const(1 << (rb * k)))
        if bits_k == rb:
            b.plookup([w[f"c{k}"]], [range_table])
            b.plookup([w[f"d{k}"]], [range_table])
        else:
            # top chunk is narrower: scale into the rb-bit window
            scale = 1 << (rb - bits_k)
            b.plookup([w[f"c{k}"] * Const(scale)], [range_table])
            b.plookup([w[f"d{k}"] * Const(scale)], [range_table])
    b.constrain(c_acc - in_sel)
    b.constrain(d_acc - (w["active"] * Const(LIMIT) - in_sel))
    return ClimbKeyLayout(fixed=fixed, witness=w, range_bits=rb)


def fill_fixed(layout: ClimbKeyLayout, const_np: np.ndarray):
    if "CK_RANGE" in layout.fixed:
        n = const_np.shape[0]
        const_np[:, layout.fixed["CK_RANGE"].index] = \
            np.arange(n, dtype=np.uint64) % (1 << layout.range_bits)


def expand_into(layout: ClimbKeyLayout,
                climbs: List[Tuple[tuple, int, int]],
                cm1_np: np.ndarray):
    """Fill one row per (in_quad, level, bit) climb request."""
    n = cm1_np.shape[0]
    rb = layout.range_bits
    n_chunks = -(-63 // rb)
    assert len(climbs) <= n, "too many climb requests"
    w = layout.witness
    mask = (1 << rb) - 1
    for i, (quad, level, bit) in enumerate(climbs):
        zl = level % 4
        in_sel = int(quad[zl])
        assert in_sel <= LIMIT, "climb input exceeds PRE_CLIMB_UP_LIMIT"
        for j in range(4):
            cm1_np[i, w[f"in{j}"].index] = quad[j]
            cm1_np[i, w[f"out{j}"].index] = \
                (2 * int(quad[j]) + bit) if j == zl else quad[j]
            cm1_np[i, w[f"lsel{j}"].index] = 1 if j == zl else 0
        cm1_np[i, w["level"].index] = level
        cm1_np[i, w["q"].index] = level // 4
        cm1_np[i, w["bit"].index] = bit
        cm1_np[i, w["active"].index] = 1
        d = LIMIT - in_sel
        for k in range(n_chunks):
            cm1_np[i, w[f"c{k}"].index] = (in_sel >> (rb * k)) & mask
            cm1_np[i, w[f"d{k}"].index] = (d >> (rb * k)) & mask
    # padding rows are all-zero and satisfy every constraint
