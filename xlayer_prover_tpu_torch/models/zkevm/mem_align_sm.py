"""MemAlign SM: unaligned 256-bit read/write across 32-byte words, as a
provable circuit.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/mem_align_sm.py``
(without ``expand_trace``, the byte-stream oracle of the JAX package's
tests).
Equivalent of the reference MemAlign SM (src/sm/mem_align/
mem_align_executor.cpp, mem_align.pil semantics): the EVM reads/writes
32-byte values at arbitrary byte offsets spanning two aligned machine
words (m0, m1).  Each action occupies 32 rows, one big-endian byte of the
pair per row:

  * ``inM0/inM1`` stream the pair bytes in straight scan order, so every
    32-bit limb of m0/m1 (and of the written words w0/w1 via the
    committed ``inW0/inW1`` bytes) is a *static shifted-byte sum* at the
    block's first row — no accumulator columns (the reference commits
    40 accumulator pols; the shifted-expression reconstruction replaces
    them);
  * ``inV`` streams the value bytes in the reference's rotated order
    vByte = (31 + offset + wr8 - STEP) mod 32 (mem_align_executor.cpp:9),
    accumulated into 8 little-endian limbs through the committed
    ``fV0..7`` factor columns, which a plookup binds to the fixed
    (STEP, offset, wr8) -> factor table — the offset-dependent rotation
    is the one thing static shifts cannot express;
  * ``before``/``isOff`` implement the j < offset / j == offset selectors
    (selM1) with a marker-and-chain argument; offset = 32 (legal per
    main_executor.cpp:4518 — the value lives entirely in m1) is handled
    by the ``is32`` escape on the marker-must-fire rule;
  * byte semantics: RD constrains inV to the selected pair byte; WR/WR8
    route inV/inM bytes into inW0/inW1 exactly as the reference's
    inW0/inW1 selection (mem_align_executor.cpp:66-69).

The Main SM binds {wr256, wr8, offset, m0, m1, v, w0, w1} limb tuples at
each block's first row (zkevm_air), one plookup per op kind.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ...stark.air import AirBuilder, Col, Const

M256 = (1 << 256) - 1
ROWS_PER_OP = 32
TABLE_ROWS = 32 * 33 * 2      # STEP x offset(0..32) x wr8


@dataclasses.dataclass
class MemAlignAction:
    op: str       # "RD" | "WR" | "WR8"
    m0: int       # aligned word at addr
    m1: int       # aligned word at addr+32
    offset: int   # byte offset 0..32
    value: int    # RD: result; WR: 256-bit value; WR8: single byte


def apply_action(a: MemAlignAction) -> Tuple[int, int, int]:
    """Host oracle: returns (result_value, new_m0, new_m1)."""
    assert 0 <= a.offset <= 32
    pair = (a.m0 << 256) | a.m1          # 64 bytes, big-endian semantics
    if a.op == "RD":
        shift = 8 * (32 - a.offset)
        val = (pair >> shift) & M256
        return val, a.m0, a.m1
    if a.op == "WR":
        shift = 8 * (32 - a.offset)
        mask = M256 << shift
        pair = (pair & ~mask) | ((a.value & M256) << shift)
        return a.value & M256, (pair >> 256) & M256, pair & M256
    if a.op == "WR8":
        byte_pos = 63 - a.offset          # byte index from LSB side
        shift = 8 * byte_pos
        pair = (pair & ~(0xFF << shift)) | ((a.value & 0xFF) << shift)
        return a.value & 0xFF, (pair >> 256) & M256, pair & M256
    raise ValueError(a.op)


# ---------------------------------------------------------------------------
# circuit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MemAlignLayout:
    fixed: dict
    witness: dict

    def m_limb(self, byte_col: Col, i: int):
        """Little-endian 32-bit limb i of a big-endian 32-byte stream,
        as a shifted-byte sum anchored at the block's first row."""
        expr = None
        for k in range(4):
            j = 28 - 4 * i + k
            col = byte_col.shifted(j) if j else byte_col
            term = col * Const(1 << (8 * (3 - k)))
            expr = term if expr is None else expr + term
        return expr

    def v_limb(self, i: int):
        return self.witness[f"vAcc{i}"].shifted(ROWS_PER_OP - 1)


def build(b: AirBuilder, n_bits: int) -> MemAlignLayout:
    n = 1 << n_bits
    assert n >= TABLE_ROWS, "domain too small for the factor table"

    fixed = {
        "STEP": b.fixed("MA_STEP"),
        "FIRST": b.fixed("MA_FIRST"),
        "LAST": b.fixed("MA_LAST"),
        "BYTE": b.fixed("MA_BYTE"),
        "T_SEL": b.fixed("MA_T_SEL"),
        "T_STEP": b.fixed("MA_T_STEP"),
        "T_OFF": b.fixed("MA_T_OFF"),
        "T_WR8": b.fixed("MA_T_WR8"),
    }
    for i in range(8):
        fixed[f"T_F{i}"] = b.fixed(f"MA_T_F{i}")

    w = {name: b.witness(f"ma_{name}")
         for name in ("inM0", "inM1", "inV", "inW0", "inW1", "selM1",
                      "isOff", "before", "is32", "wr8", "wr256", "offset")}
    for i in range(8):
        w[f"fV{i}"] = b.witness(f"ma_fV{i}")
        w[f"vAcc{i}"] = b.witness(f"ma_vAcc{i}")

    one = Const(1)
    first, last, step = fixed["FIRST"], fixed["LAST"], fixed["STEP"]
    wr8, wr256, off = w["wr8"], w["wr256"], w["offset"]

    for nm in ("wr8", "wr256", "isOff", "before", "is32"):
        b.constrain(w[nm] * (w[nm] - one))
    b.constrain(wr8 * wr256)
    for nm in ("wr8", "wr256", "offset"):
        b.constrain((one - last) * (w[nm].shifted() - w[nm]))

    # offset marker: isOff fires exactly at STEP == offset; `before` is
    # the j < offset region; offset = 32 never fires (is32 escape)
    b.constrain(w["isOff"] * (step - off))
    b.constrain(w["is32"] * (off - Const(32)))
    b.constrain(first * (w["before"] + w["isOff"] - one))
    b.constrain((one - last) * (w["before"].shifted()
                                - w["before"] * (one - w["isOff"].shifted())))
    b.constrain(last * w["before"] * (one - w["is32"]))

    # selM1: WR8 touches only the offset byte; RD/WR select m1 for j<offset
    b.constrain(w["selM1"] - wr8 * w["isOff"] - (one - wr8) * w["before"])

    # RD: the value byte IS the selected pair byte
    b.constrain((one - wr256 - wr8)
                * (w["inV"] - w["selM1"] * w["inM1"]
                   - (one - w["selM1"]) * w["inM0"]))

    # write streams (mem_align_executor.cpp:66-69)
    cond0 = wr256 * (one - w["selM1"]) + wr8 * w["selM1"]
    b.constrain(w["inW0"] - cond0 * w["inV"]
                - (one - cond0) * (wr256 + wr8) * w["inM0"])
    cond1 = wr256 * w["selM1"]
    b.constrain(w["inW1"] - cond1 * w["inV"]
                - (one - cond1) * (wr256 + wr8) * w["inM1"])

    # v limb accumulators driven by the factor columns
    for i in range(8):
        acc, fv = w[f"vAcc{i}"], w[f"fV{i}"]
        b.constrain(first * (acc - w["inV"] * fv))
        b.constrain((one - last) * (acc.shifted() - acc
                                    - w["inV"].shifted() * fv.shifted()))

    for nm in ("inM0", "inM1", "inV"):
        b.plookup([w[nm]], [fixed["BYTE"]])

    # factor binding: (STEP, offset, wr8) -> fV0..7 (also range-binds
    # offset to 0..32 and wr8 to the block kind on every row)
    b.plookup([step, off, wr8] + [w[f"fV{i}"] for i in range(8)],
              [fixed["T_STEP"], fixed["T_OFF"], fixed["T_WR8"]]
              + [fixed[f"T_F{i}"] for i in range(8)],
              t_sel=fixed["T_SEL"])

    return MemAlignLayout(fixed=fixed, witness=w)


def _factor_cols(step, off, wr8):
    """vByte rotation factors (vectorized): fV[i] = [vByte>>2 == i] *
    256^(vByte%4), vByte = (31 + off + wr8 - step) % 32."""
    vbyte = (31 + off + wr8 - step) % 32
    pow4 = (np.uint64(1) << (8 * (vbyte % 4)).astype(np.uint64))
    cols = []
    for i in range(8):
        cols.append(np.where((vbyte >> 2) == i, pow4, np.uint64(0)))
    return cols


def fill_fixed(layout: MemAlignLayout, const_np: np.ndarray):
    n = const_np.shape[0]
    f = layout.fixed
    idx = np.arange(n, dtype=np.uint64)
    step = idx % ROWS_PER_OP
    const_np[:, f["STEP"].index] = step
    const_np[:, f["FIRST"].index] = (step == 0)
    const_np[:, f["LAST"].index] = (step == ROWS_PER_OP - 1)
    const_np[:, f["BYTE"].index] = idx % 256

    # factor table: r = (wr8*33 + offset)*32 + step
    r = np.arange(TABLE_ROWS, dtype=np.uint64)
    t_step = r % 32
    t_off = (r >> 5) % 33
    t_wr8 = r // (33 * 32)
    const_np[:TABLE_ROWS, f["T_SEL"].index] = 1
    const_np[:TABLE_ROWS, f["T_STEP"].index] = t_step
    const_np[:TABLE_ROWS, f["T_OFF"].index] = t_off
    const_np[:TABLE_ROWS, f["T_WR8"].index] = t_wr8
    for i, col in enumerate(_factor_cols(t_step, t_off, t_wr8)):
        const_np[:TABLE_ROWS, f[f"T_F{i}"].index] = col


def expand_into(layout: MemAlignLayout, actions: List[MemAlignAction],
                cm1_np: np.ndarray):
    """Fill the committed columns; returns (v, w0, w1) per action."""
    n = cm1_np.shape[0]
    assert len(actions) * ROWS_PER_OP <= n, "too many memAlign actions"
    w = layout.witness
    idx = np.arange(n, dtype=np.uint64)
    step = idx % ROWS_PER_OP

    off_col = np.zeros(n, dtype=np.uint64)
    wr8_col = np.zeros(n, dtype=np.uint64)
    wr256_col = np.zeros(n, dtype=np.uint64)
    for k, a in enumerate(actions):
        sl = slice(k * ROWS_PER_OP, (k + 1) * ROWS_PER_OP)
        off_col[sl] = a.offset
        wr8_col[sl] = 1 if a.op == "WR8" else 0
        wr256_col[sl] = 1 if a.op == "WR" else 0

    is_off = (step == off_col).astype(np.uint64)
    before = (step < off_col).astype(np.uint64)
    is32 = (off_col == 32).astype(np.uint64)
    sel_m1 = np.where(wr8_col == 1, is_off, before)
    fv = _factor_cols(step, off_col, wr8_col)

    cm1_np[:, w["offset"].index] = off_col
    cm1_np[:, w["wr8"].index] = wr8_col
    cm1_np[:, w["wr256"].index] = wr256_col
    cm1_np[:, w["isOff"].index] = is_off
    cm1_np[:, w["before"].index] = before
    cm1_np[:, w["is32"].index] = is32
    cm1_np[:, w["selM1"].index] = sel_m1
    for i in range(8):
        cm1_np[:, w[f"fV{i}"].index] = fv[i]

    results = []
    for k, a in enumerate(actions):
        base = k * ROWS_PER_OP
        m0b = a.m0.to_bytes(32, "big")
        m1b = a.m1.to_bytes(32, "big")
        if a.op == "RD":
            val, w0, w1 = apply_action(a)
            vv = val
        else:
            val, w0, w1 = apply_action(a)
            vv = a.value & M256
        vacc = [0] * 8
        for j in range(ROWS_PER_OP):
            row = base + j
            s8 = 1 if a.op == "WR8" else 0
            vbyte = (31 + a.offset + s8 - j) % 32
            in_v = (vv >> (8 * vbyte)) & 0xFF
            sel = int(sel_m1[row])
            in_m0, in_m1 = m0b[j], m1b[j]
            if a.op == "WR":
                in_w0 = in_v if sel == 0 else in_m0
                in_w1 = in_v if sel == 1 else in_m1
            elif a.op == "WR8":
                in_w0 = in_v if sel == 1 else in_m0
                in_w1 = in_m1
            else:
                in_w0 = in_w1 = 0
            cm1_np[row, w["inM0"].index] = in_m0
            cm1_np[row, w["inM1"].index] = in_m1
            cm1_np[row, w["inV"].index] = in_v
            cm1_np[row, w["inW0"].index] = in_w0
            cm1_np[row, w["inW1"].index] = in_w1
            vacc[vbyte >> 2] += in_v << (8 * (vbyte % 4))
            for i in range(8):
                cm1_np[row, w[f"vAcc{i}"].index] = vacc[i]
        results.append((vv, w0, w1))

    # empty blocks already satisfy every rule: offset 0 makes the marker
    # fire on the first row (is_off above), and zeros pass the byte rules
    return results
