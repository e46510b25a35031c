"""Provable gate-circuit AIR: KeccakF / Sha256F SM core.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/gate_sm.py`` (the
sigma columns are filled with one numpy scatter over every wire cycle;
the wire values come from ``gates.execute_all_wires_np`` on the host, as
in the JAX package).

A re-design of the reference KeccakF/Sha256F state machines
(src/sm/keccak_f/keccak_f_executor.cpp, src/sm/sha256_f/; PIL shape of
keccak_f.pil): a hash permutation compiled to XOR/ANDP gates
(gates.GateBuilder) becomes one committed row per gate —

  * witness a_k/b_k/c_k: the two operands and the result, bit-packed
    ``pack_bits`` instances wide and split into ``chunk_bits``-bit chunks
    (the reference packs 44 instances as 4x11-bit chunks, keccak mask
    0x7FF per chunk, keccak_f_executor.cpp:154,234-245);
  * per-chunk bitwise semantics by a plookup of (GOP, a_k, b_k, c_k) into
    a fixed op/x/y/result table (2 * 4^chunk_bits rows) — the AIR analogue
    of the reference's 2^22 xor/andp tables; the table also range-bounds
    every chunk;
  * gate wiring (refa/refb pin routing, keccak_f_executor.cpp:176-207)
    by ONE PlonK-style connection argument over the 3*n_chunks columns:
    all cells carrying the same (wire, chunk) sit on one sigma cycle — the
    reference's ConnA/ConnB/ConnC constant pols;
  * row 0 pins the constant wires: a = 0, b = pack mask (the reference
    zeroRef row, keccak_f_executor.cpp:151-156).

Multiple slots (permutation instances) tile the domain; inputs are free
wires per slot (bound upstream by the padding chain / digest lookups via
``input_cells``/``output_cells``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List

import numpy as np

from ...fields import gl
from ...stark.air import AirBuilder, Const, FirstRowSelector
from .gates import OP_XOR, GateScript, execute_all_wires_np

P = gl.P


@dataclasses.dataclass
class GateSmLayout:
    script: GateScript
    n_bits: int
    pack_bits: int
    chunk_bits: int
    n_chunks: int
    n_slots: int
    table_rows: int
    fixed: dict
    witness: dict
    k_coeffs: list
    wire_cells: dict       # (slot, wire) -> [(row, col_index)]
    prefix: str

    def slot_row0(self, slot: int) -> int:
        return 1 + slot * len(self.script.gates)

    def join(self, slot: int, wire: int, chunk: int, row: int,
             extra_idx: int):
        """Join an external cell (``row`` of connection column position
        3*n_chunks + extra_idx) into the (slot, wire, chunk) sigma cycle.
        Must be called before fill_fixed."""
        key = (None, wire, chunk) if wire in (0, 1) else (slot, wire, chunk)
        self.wire_cells.setdefault(key, []).append(
            (row, 3 * self.n_chunks + extra_idx))

    def input_cells(self, slot: int):
        """Input wire i -> [(row, col) first-use cell per chunk].
        Returns entries only for used inputs."""
        out = {}
        for i in range(self.script.n_inputs):
            per_chunk = [self.wire_cells.get((slot, 2 + i, k))
                         for k in range(self.n_chunks)]
            if per_chunk[0]:
                out[i] = [c[0] for c in per_chunk]
        return out

    def output_cells(self, slot: int):
        """Output wires: [(row, col) cell per chunk] per output bit."""
        return [[self.wire_cells[(slot, int(wv), k)][0]
                 for k in range(self.n_chunks)]
                for wv in self.script.outputs]


def build(b: AirBuilder, script: GateScript, n_bits: int,
          pack_bits: int = 44, chunk_bits: int = 11,
          prefix: str = "KF", extra_cols=None) -> GateSmLayout:
    """``extra_cols``: committed columns of OTHER SMs included in the
    connection argument so their cells can join wire cycles (the
    bits2field-style packing binding) via ``GateSmLayout.join``."""
    n = 1 << n_bits
    assert pack_bits % chunk_bits == 0, \
        "pack_bits must be a multiple of chunk_bits (no headroom bits)"
    nc = pack_bits // chunk_bits
    n_gates = len(script.gates)
    n_slots = (n - 1) // n_gates
    assert n_slots >= 1, f"domain 2^{n_bits} below one {n_gates}-gate slot"
    table_rows = 2 * (1 << (2 * chunk_bits))
    # strict: at least one non-table row must exist so unselected lookup
    # rows can resolve to the selector default-value sentinel
    assert table_rows < n, "bitwise chunk table does not fit the domain"

    fixed = {name: b.fixed(f"{prefix}_{name}")
             for name in ("GOP", "ROWSEL", "TSEL", "TOP", "TA", "TB", "TC")}
    w = {}
    cols = []
    for role in ("a", "b", "c"):
        for k in range(nc):
            w[f"{role}{k}"] = b.witness(f"{prefix.lower()}_{role}{k}")
            cols.append(w[f"{role}{k}"])
    extra_cols = list(extra_cols or [])
    cols = cols + extra_cols
    sigs = [b.fixed(f"{prefix}_SIG{j}") for j in range(len(cols))]
    for j, s in enumerate(sigs):
        fixed[f"SIG{j}"] = s

    # row 0: constant pins (zero wire in a, all-ones wire in b)
    l1 = FirstRowSelector()
    chunk_mask = (1 << chunk_bits) - 1
    for k in range(nc):
        b.constrain(l1 * w[f"a{k}"])
        b.constrain(l1 * (w[f"b{k}"] - Const(chunk_mask)))

    # per-chunk bitwise lookup (gate rows incl. row 0)
    for k in range(nc):
        b.plookup([fixed["GOP"], w[f"a{k}"], w[f"b{k}"], w[f"c{k}"]],
                  [fixed["TOP"], fixed["TA"], fixed["TB"], fixed["TC"]],
                  f_sel=fixed["ROWSEL"], t_sel=fixed["TSEL"])

    # wiring: one wide connection argument
    k_coeffs = [pow(7, j, P) for j in range(len(cols))]
    b.connection(cols, sigs, k_coeffs)

    # wire -> cells map (built once; fill_fixed turns it into sigma
    # cycles).  Cycles are keyed (slot, wire, chunk) — each chunk carries
    # a distinct bit range and routes independently; the constant wires
    # 0/1 are global — every slot's uses chain through the row-0 pins.
    wire_cells = {}

    def add_cell(slot, wire, row, col, k):
        key = (None, wire, k) if wire in (0, 1) else (slot, wire, k)
        wire_cells.setdefault(key, []).append((row, col))

    for k in range(nc):
        add_cell(None, 0, 0, k, k)
        add_cell(None, 1, 0, nc + k, k)
        # row 0's c = xor(0, ones) = ones joins the one-wire cycle
        add_cell(None, 1, 0, 2 * nc + k, k)
    # add_cell inlined over the gate rows (millions of cells at 2^18),
    # appending in the same order
    cells_of = wire_cells.setdefault
    for s in range(n_slots):
        r0 = 1 + s * n_gates
        for gi, (_op, ga, gb, gr) in enumerate(script.gates):
            row = r0 + gi
            sa, sb, sr = (None if w_ < 2 else s for w_ in (ga, gb, gr))
            for k in range(nc):
                cells_of((sa, ga, k), []).append((row, k))
                cells_of((sb, gb, k), []).append((row, nc + k))
                cells_of((sr, gr, k), []).append((row, 2 * nc + k))

    return GateSmLayout(script=script, n_bits=n_bits, pack_bits=pack_bits,
                        chunk_bits=chunk_bits, n_chunks=nc, n_slots=n_slots,
                        table_rows=table_rows, fixed=fixed, witness=w,
                        k_coeffs=k_coeffs, wire_cells=wire_cells,
                        prefix=prefix)


def fill_fixed(layout: GateSmLayout, const_np: np.ndarray):
    n = const_np.shape[0]
    fx = layout.fixed
    cb = layout.chunk_bits
    nc = layout.n_chunks
    n_gates = len(layout.script.gates)

    # bitwise table: op-major, then x-major
    side = 1 << cb
    xs = np.repeat(np.arange(side, dtype=np.uint64), side)
    ys = np.tile(np.arange(side, dtype=np.uint64), side)
    half = side * side
    const_np[:2 * half, fx["TSEL"].index] = 1
    const_np[half:2 * half, fx["TOP"].index] = 1
    const_np[:half, fx["TA"].index] = xs
    const_np[:half, fx["TB"].index] = ys
    const_np[:half, fx["TC"].index] = xs ^ ys
    const_np[half:2 * half, fx["TA"].index] = xs
    const_np[half:2 * half, fx["TB"].index] = ys
    mask = np.uint64(side - 1)
    const_np[half:2 * half, fx["TC"].index] = (~xs) & ys & mask

    # gate rows: op + row selector; row 0 is the constant row (xor)
    const_np[0, fx["ROWSEL"].index] = 1
    const_np[0, fx["GOP"].index] = 0
    gop = np.array([op != OP_XOR for (op, _a, _b, _r) in
                    layout.script.gates], dtype=np.uint64)
    for s in range(layout.n_slots):
        r0 = 1 + s * n_gates
        const_np[r0:r0 + n_gates, fx["ROWSEL"].index] = 1
        const_np[r0:r0 + n_gates, fx["GOP"].index] = gop

    # sigma columns: identity mapping x^i * k_j, then rotate each wire
    # cycle: a cell takes the identity value of the next cell of its cycle
    wgen = gl.host_w(layout.n_bits)
    x = [1] * n
    for i in range(1, n):
        x[i] = x[i - 1] * wgen % P
    sig = [fx[f"SIG{j}"].index for j in range(len(layout.k_coeffs))]
    ident = np.empty((n, len(sig)), dtype=np.uint64)
    for j, k in enumerate(layout.k_coeffs):
        ident[:, j] = [v * k % P for v in x]
    const_np[:, sig] = ident
    cycles = [cells for cells in layout.wire_cells.values()
              if len(cells) >= 2]
    lens = np.fromiter(map(len, cycles), dtype=np.int64, count=len(cycles))
    m = int(lens.sum())
    cells = np.fromiter(itertools.chain.from_iterable(
        itertools.chain.from_iterable(cycles)), dtype=np.int64,
        count=2 * m).reshape(m, 2)
    start = np.repeat(np.cumsum(lens) - lens, lens)
    nxt = np.arange(1, m + 1)
    ends = nxt == start + np.repeat(lens, lens)
    nxt[ends] = start[ends]
    const_np[cells[:, 0], np.asarray(sig)[cells[:, 1]]] = \
        ident[cells[nxt, 0], cells[nxt, 1]]


def expand_into(layout: GateSmLayout, slot_inputs: List[np.ndarray],
                cm1_np: np.ndarray):
    """Fill committed chunk columns from per-slot packed input bits.

    slot_inputs: up to n_slots arrays of (n_inputs,) uint64 pack_bits-
    packed bits; missing slots run on all-zero inputs.  Returns the list
    of per-slot output arrays (n_outputs,) uint64."""
    nc = layout.n_chunks
    cb = layout.chunk_bits
    n_gates = len(layout.script.gates)
    assert len(slot_inputs) <= layout.n_slots, "too many gate slots"
    w = layout.witness
    mask = np.uint64((1 << cb) - 1)

    # constant row
    for k in range(nc):
        cm1_np[0, w[f"b{k}"].index] = int(mask)
        cm1_np[0, w[f"c{k}"].index] = int(mask)

    outs = []
    zero_in = np.zeros(layout.script.n_inputs, dtype=np.uint64)
    gates_arr = np.asarray(layout.script.gates, dtype=np.int64)
    ga = gates_arr[:, 1]
    gb = gates_arr[:, 2]
    gr = gates_arr[:, 3]
    for s in range(layout.n_slots):
        inp = slot_inputs[s] if s < len(slot_inputs) else zero_in
        wires = execute_all_wires_np(layout.script, inp, layout.pack_bits)
        r0 = 1 + s * n_gates
        va, vb, vr = wires[ga], wires[gb], wires[gr]
        for k in range(nc):
            sh = np.uint64(cb * k)
            cm1_np[r0:r0 + n_gates, w[f"a{k}"].index] = (va >> sh) & mask
            cm1_np[r0:r0 + n_gates, w[f"b{k}"].index] = (vb >> sh) & mask
            cm1_np[r0:r0 + n_gates, w[f"c{k}"].index] = (vr >> sh) & mask
        if s < len(slot_inputs):
            outs.append(wires[layout.script.outputs])
    return outs
