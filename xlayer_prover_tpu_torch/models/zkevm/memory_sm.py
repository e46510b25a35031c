"""Memory SM: provable sorted-access memory-consistency circuit + expander.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/memory_sm.py``
(``expand_trace`` fills whole columns with numpy instead of a row loop).
Equivalent of the reference Memory SM (src/sm/memory/memory_executor.cpp):
accesses sorted by (addr, step); consistency requires every read to return
the last written value and first reads to see zero.  Circuit design:

  columns (witness): addr, step, is_write, val0..7, last_access, active,
                     delta_lo, delta_hi
  fixed: RANGE (0..2^rb-1 repeating, for delta limb range checks)

  constraints (cyclic domain; wrap disabled via the last row of RANGE trick
  is not needed — transitions guard with the fixed NOTLAST selector):
    * booleans: last_access, is_write, active;
    * within a group (last_access=0): addr' = addr, and step delta
      step' - step = delta (two range-checked limbs, so address gaps from
      the CTX/STACK/MEM segmentation of main_executor.cpp:46-48 fit);
    * group change (last_access=1): addr' - addr - 1 = delta;
    * read after write/read in-group: val_j' = val_j when is_write' = 0;
    * first access of a new group that is a read sees zero;
    * active rows precede padding: active' <= active, and padding rows are
      reads (the expander repeats the last access), keeping consistency.

The Main SM binds its mOp rows to the ``active`` rows by a selected
permutation over (addr, step, is_write, val0..7).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...fields import gl
from ...stark.air import AirBuilder, Const

P = gl.P


@dataclasses.dataclass
class MemoryLayout:
    range_bits: int
    fixed: dict
    witness: dict


def build(builder: AirBuilder, n_bits: int,
          range_bits: int | None = None) -> MemoryLayout:
    rb = range_bits or min(16, n_bits)
    fixed = {
        "RANGE": builder.fixed("MEM_RANGE"),
        "NOTLAST": builder.fixed("MEM_NOTLAST"),
    }
    w = {
        "addr": builder.witness("mem_addr"),
        "step": builder.witness("mem_step"),
        "is_write": builder.witness("mem_is_write"),
        "last_access": builder.witness("mem_last_access"),
        "active": builder.witness("mem_active"),
        # range-checked delta limbs (bound by plookup into RANGE)
        "delta_lo": builder.witness("mem_delta_lo"),
        "delta_hi": builder.witness("mem_delta_hi"),
    }
    for j in range(8):
        w[f"val{j}"] = builder.witness(f"mem_val{j}")
    one = Const(1)
    la = w["last_access"]
    wr = w["is_write"]
    act = w["active"]
    addr, step = w["addr"], w["step"]
    not_wrap = fixed["NOTLAST"]

    builder.constrain(la * (la - one))                 # boolean
    builder.constrain(wr * (wr - one))                 # boolean
    builder.constrain(act * (act - one))               # boolean
    builder.constrain(not_wrap * (act.shifted() - act) * act.shifted())
    # in-group: same addr
    builder.constrain(not_wrap * (one - la) * (addr.shifted() - addr))
    # delta definition: in-group -> step'-step ; group change -> addr'-addr-1
    delta = w["delta_lo"] + w["delta_hi"] * Const(1 << rb)
    builder.constrain(not_wrap * (
        delta
        - (one - la) * (step.shifted() - step)
        - la * (addr.shifted() - addr - one)))
    builder.plookup([w["delta_lo"]], [fixed["RANGE"]])
    builder.plookup([w["delta_hi"]], [fixed["RANGE"]])
    for j in range(8):
        val = w[f"val{j}"]
        # read consistency within a group
        builder.constrain(not_wrap * (one - la) * (one - wr.shifted())
                          * (val.shifted() - val))
        # new group starting with a read sees zero
        builder.constrain(not_wrap * la * (one - wr.shifted())
                          * val.shifted())
    return MemoryLayout(range_bits=rb, fixed=fixed, witness=w)


def fill_fixed(layout: MemoryLayout, const_np: np.ndarray):
    n = const_np.shape[0]
    rb = layout.range_bits
    const_np[:, layout.fixed["RANGE"].index] = \
        np.arange(n, dtype=np.uint64) % (1 << rb)
    const_np[:, layout.fixed["NOTLAST"].index] = 1
    const_np[n - 1, layout.fixed["NOTLAST"].index] = 0


def expand_trace(layout: MemoryLayout, actions, cm1_np: np.ndarray):
    """actions: list of (kind, addr, value, step) from the Main SM
    (Required.memory; kind in {"R","W"}; value is an 8-limb list)."""
    n = cm1_np.shape[0]
    rb = layout.range_bits

    def limbs_of(v):
        if isinstance(v, (list, tuple)):
            return [int(x) for x in v]
        return [(int(v) >> (32 * j)) & 0xFFFFFFFF for j in range(8)]

    rows = sorted(((a, s, 1 if k == "W" else 0, limbs_of(v))
                   for (k, a, v, s) in actions), key=lambda r: (r[0], r[1]))
    assert len(rows) <= n
    w = layout.witness
    n_active = len(rows)
    # pad remaining rows by repeating the last access at increasing steps
    addr = np.zeros(n, dtype=np.int64)
    step = np.arange(n, dtype=np.int64)
    is_write = np.zeros(n, dtype=np.uint64)
    vals = np.zeros((n, 8), dtype=np.uint64)
    if rows:
        addr[:n_active] = [r[0] for r in rows]
        step[:n_active] = [r[1] for r in rows]
        is_write[:n_active] = [r[2] for r in rows]
        vals[:n_active] = [[x % P for x in r[3]] for r in rows]
        addr[n_active:] = addr[n_active - 1]
        step[n_active:] = step[n_active - 1] + 1 + np.arange(n - n_active)
        vals[n_active:] = vals[n_active - 1]
    nxt_addr = np.roll(addr, -1)
    la = nxt_addr != addr
    delta = np.where(la, nxt_addr - addr - 1, np.roll(step, -1) - step)[:-1]
    bad = (delta < 0) | (delta >= (1 << (2 * rb)))
    assert not bad.any(), \
        f"delta {delta[bad][0]} out of range at row {np.flatnonzero(bad)[0]}"
    cm1_np[:, w["addr"].index] = addr
    cm1_np[:, w["step"].index] = step
    cm1_np[:, w["is_write"].index] = is_write
    cm1_np[:n_active, w["active"].index] = 1
    for j in range(8):
        cm1_np[:, w[f"val{j}"].index] = vals[:, j]
    cm1_np[:, w["last_access"].index] = la
    cm1_np[:-1, w["delta_lo"].index] = delta & ((1 << rb) - 1)
    cm1_np[:-1, w["delta_hi"].index] = delta >> rb
