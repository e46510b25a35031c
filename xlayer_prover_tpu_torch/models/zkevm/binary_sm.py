"""Binary SM: provable 256-bit binary-op circuit + trace expander.

Equivalent of the reference Binary SM (src/sm/binary/binary_executor.cpp:
each 256-bit op is chunk-decomposed over a fixed number of rows with
FACTOR/RESET constant tables recomposing the 8 x 32-bit register limbs, and
per-chunk semantics verified against a lookup table).  Here the circuit is
authored in the AIR framework and proven by the STARK engine (the port's
own copy of ``xlayer_prover_tpu/models/zkevm/binary_sm.py``):

  * each op occupies ``rows_per_op`` rows of ``chunk_bits``-bit chunks
    (little-endian);
  * accumulator recurrence per 32-bit limb j:
      acc_j' = acc_j * (1 - RESET') + chunk' * FACTOR_j'
  * carry chain: c_in' = c_out * (1 - RESET')
  * opcode held constant within an op;
  * chunk semantics via an 8-tuple plookup
      (opcode, GEND, LAST, a_chunk, b_chunk, c_in, c_chunk, c_out) ∈ T
    where GEND marks 64-bit group boundaries (for LT4) and LAST the final
    chunk (where comparison ops place their 0/1 result).

Supported ops mirror the reference opcodes used by the fork_9 ROM
(binary_executor.cpp): ADD=0, SUB=1, LT=2, SLT=3, EQ=4, AND=5, OR=6, XOR=7,
LT4=8.  Carry-out semantics match MainExecutor (overflow/borrow for
ADD/SUB; the 0/1 result for LT/SLT/EQ/LT4; result-nonzero for AND).
The final carry is exposed at each op's LAST row for the Main SM binding.

The trace expander vectorizes over actions x chunks with numpy (device fill
is a later optimization; the prover consumes numpy columns anyway).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ...stark.air import AirBuilder, Col, Const

OPCODES = {"ADD": 0, "SUB": 1, "LT": 2, "SLT": 3, "EQ": 4, "AND": 5,
           "OR": 6, "XOR": 7, "LT4": 8}
OPNAMES = {v: k for k, v in OPCODES.items()}


@dataclasses.dataclass
class BinaryLayout:
    chunk_bits: int
    rows_per_op: int
    fixed: dict     # name -> Col
    witness: dict   # name -> Col


def _chunk_step(op: int, a: int, b: int, cin: int, gend: int, last: int,
                m: int, cb: int):
    """One chunk transition: returns (c_chunk, c_out).

    Carry encoding per op:
      ADD/SUB: arithmetic carry/borrow.
      LT: lt-so-far (little-endian scan: later chunks dominate).
      SLT: same, signed compare on the final (sign) chunk.
      EQ: bit0 = seen-difference; result = 1 - bit0 at LAST.
      AND: nonzero-so-far.
      LT4: bit0 = lt-so-far within the current 64-bit group; bit1 = some
           completed group NOT strictly less.  Result at LAST =
           not(bit1) and group-lt.
    """
    if op == 0:      # ADD
        s = a + b + (cin & 1)
        return s & m, s >> cb
    if op == 1:      # SUB
        d = a - b - (cin & 1)
        return d & m, int(d < 0)
    if op == 2 or op == 3:   # LT / SLT (result exposed via carry)
        if op == 3 and last:
            half = (m + 1) >> 1
            sa = a - (m + 1) if a >= half else a
            sb = b - (m + 1) if b >= half else b
        else:
            sa, sb = a, b
        lt = 1 if sa < sb else ((cin & 1) if sa == sb else 0)
        return 0, lt
    if op == 4:      # EQ: cin bit0 = difference seen so far
        diff = (cin & 1) | int(a != b)
        return 0, (1 - diff) if last else diff
    if op == 5:      # AND: carry = nonzero-so-far
        c = a & b
        return c, (cin & 1) | int(c != 0)
    if op == 6:      # OR
        return a | b, 0
    if op == 7:      # XOR
        return a ^ b, 0
    if op == 8:      # LT4
        bit0, bit1 = cin & 1, (cin >> 1) & 1
        lt = 1 if a < b else (bit0 if a == b else 0)
        if last:
            return 0, int(bit1 == 0 and lt == 1)
        if gend:
            return 0, 2 * (bit1 | (1 - lt))
        return 0, bit1 * 2 + lt
    raise ValueError(op)


_CIN_RANGE = {0: 2, 1: 2, 2: 2, 3: 2, 4: 2, 5: 2, 6: 1, 7: 1, 8: 4}

# comparison ops deliver their 0/1 result through the carry chain and the
# committed res* exposure (the reference Binary SM's useCarry pattern)
USE_CARRY = {2, 3, 4, 8}


@functools.lru_cache(maxsize=None)
def chunk_table(chunk_bits: int):
    """Enumerate T rows: (op, gend, last, a, b, cin, c, cout)."""
    m = (1 << chunk_bits) - 1
    rows = []
    for a in range(m + 1):
        for b in range(m + 1):
            for op in OPCODES.values():
                for cin in range(_CIN_RANGE[op]):
                    for gend, last in ((0, 0), (1, 0), (1, 1)):
                        c, cout = _chunk_step(op, a, b, cin, gend, last,
                                              m, chunk_bits)
                        uc = 1 if op in USE_CARRY else 0
                        rows.append((op, uc, gend, last, a, b, cin, c, cout))
    return sorted(set(rows))


def build(builder: AirBuilder, n_bits: int, chunk_bits: int = 4) -> BinaryLayout:
    """Add the Binary SM columns + constraints to a (possibly shared) builder."""
    rows_per_op = 256 // chunk_bits

    fixed = {}
    witness = {}
    fixed["RESET"] = builder.fixed("BIN_RESET")
    fixed["LAST"] = builder.fixed("BIN_LAST")
    fixed["GEND"] = builder.fixed("BIN_GEND")    # 64-bit group boundary
    for j in range(8):
        fixed[f"FACTOR{j}"] = builder.fixed(f"BIN_FACTOR{j}")
    for name in ("T_OP", "T_UC", "T_GEND", "T_LAST", "T_A", "T_B", "T_CIN",
                 "T_C", "T_COUT"):
        fixed[name] = builder.fixed(f"BIN_{name}")

    witness["op"] = builder.witness("bin_op")
    witness["use_carry"] = builder.witness("bin_use_carry")
    for v in ("a", "b", "c"):
        witness[f"{v}_chunk"] = builder.witness(f"bin_{v}_chunk")
    witness["c_in"] = builder.witness("bin_c_in")
    witness["c_out"] = builder.witness("bin_c_out")
    for v in ("a", "b", "c"):
        for j in range(8):
            witness[f"{v}{j}"] = builder.witness(f"bin_{v}{j}")
    # committed result exposure: res0 = result limb 0 (carry for
    # comparison ops), resj = result limb j (0 for comparison ops)
    for j in range(8):
        witness[f"res{j}"] = builder.witness(f"bin_res{j}")

    reset_p = fixed["RESET"].shifted()
    one = Const(1)
    for v in ("a", "b", "c"):
        ch = witness[f"{v}_chunk"]
        for j in range(8):
            acc = witness[f"{v}{j}"]
            builder.constrain(acc.shifted()
                              - acc * (one - reset_p)
                              - ch.shifted() * fixed[f"FACTOR{j}"].shifted())
    cin, cout = witness["c_in"], witness["c_out"]
    builder.constrain(cin.shifted() - cout * (one - reset_p))
    opc = witness["op"]
    builder.constrain((opc.shifted() - opc) * (one - reset_p))
    builder.constrain(fixed["RESET"] * cin)  # carry starts at 0

    uc = witness["use_carry"]
    builder.constrain((uc.shifted() - uc) * (one - reset_p))
    builder.constrain(witness["res0"] - uc * cout
                      - (one - uc) * witness["c0"])
    for j in range(1, 8):
        builder.constrain(witness[f"res{j}"]
                          - (one - uc) * witness[f"c{j}"])
    builder.plookup(
        [opc, uc, fixed["GEND"], fixed["LAST"], witness["a_chunk"],
         witness["b_chunk"], cin, witness["c_chunk"], cout],
        [fixed["T_OP"], fixed["T_UC"], fixed["T_GEND"], fixed["T_LAST"],
         fixed["T_A"], fixed["T_B"], fixed["T_CIN"], fixed["T_C"],
         fixed["T_COUT"]],
    )
    return BinaryLayout(chunk_bits=chunk_bits, rows_per_op=rows_per_op,
                        fixed=fixed, witness=witness)


def fill_fixed(layout: BinaryLayout, const_np: np.ndarray):
    """Fill the fixed columns (RESET/FACTOR/table) for N rows."""
    n = const_np.shape[0]
    rpo = layout.rows_per_op
    cb = layout.chunk_bits
    cpl = 32 // cb  # chunks per 32-bit limb
    gpl = 64 // cb  # chunks per 64-bit group
    idx = np.arange(n)
    const_np[:, layout.fixed["RESET"].index] = (idx % rpo == 0)
    const_np[:, layout.fixed["LAST"].index] = (idx % rpo == rpo - 1)
    const_np[:, layout.fixed["GEND"].index] = (idx % gpl == gpl - 1)
    pos = idx % rpo
    limb = pos // cpl
    within = pos % cpl
    for j in range(8):
        f = np.where(limb == j, (1 << (cb * within)), 0)
        const_np[:, layout.fixed[f"FACTOR{j}"].index] = f
    table = chunk_table(cb)
    assert len(table) <= n, f"table ({len(table)}) larger than domain ({n})"
    cols = ["T_OP", "T_UC", "T_GEND", "T_LAST", "T_A", "T_B", "T_CIN",
            "T_C", "T_COUT"]
    arr = np.zeros((n, 9), dtype=np.uint64)
    arr[:len(table)] = np.array(table, dtype=np.uint64)
    # pad with the all-zero ADD row (0,0,0,0,0,0,0,0) which is a valid entry
    for k, name in enumerate(cols):
        const_np[:, layout.fixed[name].index] = arr[:, k]


def compute_op(opname: str, a: int, b: int):
    """(result, carry) of a 256-bit op, via the chunk semantics (bit-exact
    with MainExecutor._binary_result; cross-checked in tests)."""
    op = OPCODES[opname]
    cb = 8
    m = (1 << cb) - 1
    gpl = 64 // cb
    rpo = 256 // cb
    cin = 0
    c_val = 0
    for r in range(rpo):
        c, cout = _chunk_step(op, (a >> (cb * r)) & m, (b >> (cb * r)) & m,
                              cin, int(r % gpl == gpl - 1),
                              int(r == rpo - 1), m, cb)
        c_val |= c << (cb * r)
        cin = cout
    return (cin if op in USE_CARRY else c_val), cin


def expand_trace(layout: BinaryLayout, actions, cm1_np: np.ndarray):
    """actions: list of (opname, a, b) with 256-bit a,b.  Fills cm1 columns
    and returns the list of (result, carry_out) per action."""
    n = cm1_np.shape[0]
    rpo = layout.rows_per_op
    cb = layout.chunk_bits
    m = (1 << cb) - 1
    cpl = 32 // cb
    gpl = 64 // cb
    assert len(actions) * rpo <= n, "too many binary actions for the domain"
    results = []
    w = layout.witness
    for k, (opname, a, b) in enumerate(actions):
        opcode = OPCODES[opname]
        use_carry = 1 if opcode in USE_CARRY else 0
        base = k * rpo
        cin = 0
        c_val = 0
        for r in range(rpo):
            a_ch = (a >> (cb * r)) & m
            b_ch = (b >> (cb * r)) & m
            gend = int(r % gpl == gpl - 1)
            last = int(r == rpo - 1)
            c_ch, cout = _chunk_step(opcode, a_ch, b_ch, cin, gend, last,
                                     m, cb)
            row = base + r
            cm1_np[row, w["op"].index] = opcode
            cm1_np[row, w["use_carry"].index] = use_carry
            cm1_np[row, w["a_chunk"].index] = a_ch
            cm1_np[row, w["b_chunk"].index] = b_ch
            cm1_np[row, w["c_chunk"].index] = c_ch
            cm1_np[row, w["c_in"].index] = cin
            cm1_np[row, w["c_out"].index] = cout
            c_val |= c_ch << (cb * r)
            cin = cout
            for vname, val in (("a", a), ("b", b), ("c", c_val)):
                for j in range(8):
                    limb_acc = (val >> (32 * j)) & 0xFFFFFFFF
                    # mask to chunks written so far within this limb
                    limb_idx = r // cpl
                    if j < limb_idx:
                        pass  # full limb already accumulated
                    elif j == limb_idx:
                        written = (r % cpl) + 1
                        limb_acc &= (1 << (cb * written)) - 1
                    else:
                        limb_acc = 0
                    cm1_np[base + r, w[f"{vname}{j}"].index] = limb_acc
            res_val = cin if use_carry else c_val
            for j in range(8):
                cm1_np[row, w[f"res{j}"].index] = \
                    (res_val >> (32 * j)) & 0xFFFFFFFF
        results.append((cin if use_carry else c_val, cin))
    # remaining rows: all-zero ADD ops (valid table rows, acc stays 0)
    return results


SEEDED_OPS = ("ADD", "SUB", "AND", "OR", "XOR", "LT", "EQ")


def seeded_case(n_bits: int = 20, n_actions: int = 4096, seed: int = 20261016,
                chunk_bits: int = 4):
    """The Binary SM as its own AIR with the zkEVM's proof settings (8
    queries, FRI fold 3 bits; ``models/zkevm/zkevm_air.py:67-80`` of the
    JAX package) and a trace of `n_actions` seeded 256-bit actions cycling
    over SEEDED_OPS; the other rows stay zero, which the table admits.
    The defaults are the full-size case that ``chip_smoke.py`` and
    ``profile_proof.py`` prove.

    -> (air, layout, const_np, cm1_np, actions, results)"""
    b = AirBuilder("binary-sm", n_bits, n_queries=8, fri_fold_bits=3)
    layout = build(b, n_bits, chunk_bits=chunk_bits)
    air = b.compile()
    rng = np.random.default_rng(seed)
    const_np = np.zeros((air.n, air.const_width), dtype=np.uint64)
    fill_fixed(layout, const_np)
    cm1_np = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
    actions = []
    for k in range(n_actions):
        limbs = rng.integers(0, 1 << 63, size=8, dtype=np.uint64)
        a = sum(int(v) << (64 * i) for i, v in enumerate(limbs[:4]))
        bb = sum(int(v) << (64 * i) for i, v in enumerate(limbs[4:]))
        actions.append((SEEDED_OPS[k % len(SEEDED_OPS)], a, bb))
    results = expand_trace(layout, actions, cm1_np)
    return air, layout, const_np, cm1_np, actions, results
