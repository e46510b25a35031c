"""The compression AIR: 12-wire PlonK-ish rows proving a traced gate
circuit (recursion/circuit.py) with the STARK engine.

The port's own copy of ``xlayer_prover_tpu/recursion/gate_air.py``: the
same AIR and the same constant and committed columns, filled from arrays
instead of cell by cell.  The connection's k*x columns, the Poseidon
round rows and the S-box ladder are ``fields/gl.py`` ops on tensors on the
engine's device (``gl.mul`` is the ``gl_mul`` kernel on the card).

Equivalent of the reference's c12a/recursive compression circuits
("compression, 12 wires": the circom verifier circuits are laid out on
12-wire rows with copy constraints and a Poseidon custom gate, then proven
by Starks::genProof — prover.cpp:591-645, starkInfo c12a).  Row forms:

  * arith rows: four 3-wire gates (w[3s], w[3s+1], w[3s+2]) with per-slot
    coefficient columns: qM*a*b + qL*a + qR*b + qO*c + qC = 0;
  * Poseidon rows: 31-row blocks; row r holds the permutation state before
    round r in w0..11; committed S-box ladder columns (t2 = s^2, t4 =
    t2^2, t6 = t4*t2, sb = s or s*t6) keep every constraint at degree <=
    3; the official round schedule matches ops/poseidon_gl.py;
  * public rows: the first rows pin circuit publics to wire cells;
  * copy constraints: one wide connection argument over w0..11 with
    sigma columns (im-chain committed products keep degree <= 3).

The same blowup-2 geometry serves recursive1/recursive2 — circuits
differ only in their gate programs (verifier_circuit.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from .. import device as dev
from ..fields import gl
from ..ops import poseidon_constants as pc
from ..ops import poseidon_gl
from ..stark.air import AirBuilder, Const
from .circuit import Gate, PoseidonOp, Tracer

P = gl.P
N_WIRES = 12
GATES_PER_ROW = 4
POS_ROWS = 31          # 30 rounds + output row
N_ROUNDS = POS_ROWS - 1


@dataclasses.dataclass
class GateLayout:
    tracer: Tracer
    n_bits: int
    n_pub_rows: int
    pos_blocks: List[PoseidonOp]
    pos_row0: int
    arith_gates: List[Gate]
    arith_row0: int
    n_rows_used: int
    fixed: dict
    witness: dict
    # every wire cell, in the reference's order: cells[k] = (wire, row,
    # col); the copy cycle of a wire visits its cells in this order
    cells: np.ndarray
    k_coeffs: list


def plan(tracer: Tracer, n_bits: int | None = None) -> dict:
    """Row plan: publics first, then Poseidon blocks, then arith rows."""
    n_pub_rows = -(-len(tracer.public_wires) // N_WIRES) \
        if tracer.public_wires else 0
    pos_ops = [op for op in tracer.ops if isinstance(op, PoseidonOp)]
    gates = [op for op in tracer.ops if isinstance(op, Gate)]
    pos_row0 = n_pub_rows
    arith_row0 = pos_row0 + POS_ROWS * len(pos_ops)
    n_arith_rows = -(-len(gates) // GATES_PER_ROW)
    used = arith_row0 + n_arith_rows
    need_bits = max(4, used.bit_length())
    if n_bits is None:
        n_bits = need_bits
    if used >= 1 << n_bits:
        raise ValueError(f"circuit needs {used} rows > domain 2^{n_bits}")
    return {"n_pub_rows": n_pub_rows, "pos_ops": pos_ops, "gates": gates,
            "pos_row0": pos_row0, "arith_row0": arith_row0, "used": used,
            "n_bits": n_bits}


def _cells(tracer: Tracer, pl: dict) -> np.ndarray:
    """(n_cells, 3) int64 [wire, row, col]: publics, then each Poseidon
    block's inputs (row r0) and outputs (row r0 + 30) lane by lane, then
    each gate's a, b and c."""
    pub = np.array(tracer.public_wires, dtype=np.int64)
    i = np.arange(len(pub))
    parts = [np.stack([pub, i // N_WIRES, i % N_WIRES], axis=1)]
    ops = pl["pos_ops"]
    if ops:
        io = np.array([[op.inputs, op.outputs] for op in ops],
                      dtype=np.int64).transpose(0, 2, 1)     # (b, 12, 2)
        r0 = pl["pos_row0"] + POS_ROWS * np.arange(len(ops))
        rows = r0[:, None, None] + np.array([0, POS_ROWS - 1])[None, None]
        cols = np.broadcast_to(np.arange(N_WIRES)[None, :, None], io.shape)
        parts.append(np.stack([io.ravel(), np.broadcast_to(
            rows, io.shape).ravel(), cols.ravel()], axis=1))
    gates = pl["gates"]
    if gates:
        abc = np.array([(g.a, g.b, -1 if g.c is None else g.c)
                        for g in gates], dtype=np.int64)
        gi = np.arange(len(gates))
        rows = np.broadcast_to((pl["arith_row0"] + gi // GATES_PER_ROW)
                               [:, None], abc.shape)
        cols = 3 * (gi % GATES_PER_ROW)[:, None] + np.arange(3)[None]
        keep = abc.ravel() >= 0
        parts.append(np.stack([abc.ravel()[keep], rows.ravel()[keep],
                               cols.ravel()[keep]], axis=1))
    return np.concatenate(parts).astype(np.int64)


def build(tracer: Tracer, n_bits: int | None = None, n_queries: int = 8,
          fri_fold_bits: int = 3):
    pl = plan(tracer, n_bits)
    n_bits = pl["n_bits"]
    b = AirBuilder("recursion-gates", n_bits, n_queries=n_queries,
                   fri_fold_bits=fri_fold_bits)

    fixed = {}
    witness = {}
    for j in range(N_WIRES):
        witness[f"w{j}"] = b.witness(f"gw{j}")
    for name in ("t2", "t4", "t6", "sb"):
        for j in range(N_WIRES):
            witness[f"{name}{j}"] = b.witness(f"g{name}{j}")
    for s in range(GATES_PER_ROW):
        for q in ("qM", "qL", "qR", "qO", "qC"):
            fixed[f"{q}{s}"] = b.fixed(f"G_{q}{s}")
    fixed["POSROW"] = b.fixed("G_POSROW")
    fixed["FULLROW"] = b.fixed("G_FULLROW")
    for j in range(N_WIRES):
        fixed[f"PC{j}"] = b.fixed(f"G_PC{j}")
    for j in range(N_WIRES):
        fixed[f"SIG{j}"] = b.fixed(f"G_SIG{j}")
    for r in range(pl["n_pub_rows"]):
        fixed[f"PUBROW{r}"] = b.fixed(f"G_PUBROW{r}")

    one = Const(1)

    # ---- arith gates ---------------------------------------------------
    for s in range(GATES_PER_ROW):
        wa = witness[f"w{3 * s}"]
        wb = witness[f"w{3 * s + 1}"]
        wc = witness[f"w{3 * s + 2}"]
        b.constrain(fixed[f"qM{s}"] * wa * wb + fixed[f"qL{s}"] * wa
                    + fixed[f"qR{s}"] * wb + fixed[f"qO{s}"] * wc
                    + fixed[f"qC{s}"])

    # ---- Poseidon S-box ladder (all rows; s_k = w_k + PC_k) ------------
    _consts, mds = pc.get_params()
    for j in range(N_WIRES):
        s_j = witness[f"w{j}"] + fixed[f"PC{j}"]
        t2, t4, t6 = witness[f"t2{j}"], witness[f"t4{j}"], witness[f"t6{j}"]
        sb = witness[f"sb{j}"]
        b.constrain(t2 - s_j * s_j)
        b.constrain(t4 - t2 * t2)
        b.constrain(t6 - t4 * t2)
        if j == 0:
            b.constrain(sb - s_j * t6)
        else:
            b.constrain(sb - fixed["FULLROW"] * s_j * t6
                        - (one - fixed["FULLROW"]) * s_j)

    # ---- Poseidon round transition (out_j = sum_i mds[i][j] * sb_i) ----
    for j in range(N_WIRES):
        acc = None
        for i in range(N_WIRES):
            term = witness[f"sb{i}"] * Const(mds[i][j])
            acc = term if acc is None else acc + term
        b.constrain(fixed["POSROW"]
                    * (witness[f"w{j}"].shifted() - acc))

    # ---- publics -------------------------------------------------------
    for i in range(len(tracer.public_wires)):
        p = b.public_value()
        r, c = divmod(i, N_WIRES)
        b.constrain(fixed[f"PUBROW{r}"] * (witness[f"w{c}"] - p))

    # ---- copy constraints ----------------------------------------------
    k_coeffs = [pow(7, j, P) for j in range(N_WIRES)]
    b.connection([witness[f"w{j}"] for j in range(N_WIRES)],
                 [fixed[f"SIG{j}"] for j in range(N_WIRES)],
                 k_coeffs)

    air = b.compile()
    layout = GateLayout(
        tracer=tracer, n_bits=n_bits, n_pub_rows=pl["n_pub_rows"],
        pos_blocks=pl["pos_ops"], pos_row0=pl["pos_row0"],
        arith_gates=pl["gates"], arith_row0=pl["arith_row0"],
        n_rows_used=pl["used"], fixed=fixed, witness=witness,
        cells=_cells(tracer, pl), k_coeffs=k_coeffs)
    return air, layout


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _round_rows(layout: GateLayout):
    """(rows, round) of every Poseidon round row, block by block."""
    r = np.arange(N_ROUNDS)
    r0 = layout.pos_row0 + POS_ROWS * np.arange(len(layout.pos_blocks))
    return (r0[:, None] + r[None]).ravel(), np.tile(r, len(r0))


def _full_round(r):
    return (r < pc.FULL_ROUNDS // 2) | \
        (r >= pc.FULL_ROUNDS // 2 + pc.PARTIAL_ROUNDS)


def _round_constants() -> np.ndarray:
    consts, _ = pc.get_params()
    return np.array(consts, dtype=np.uint64).reshape(N_ROUNDS, N_WIRES)


def fill_fixed(layout: GateLayout, const_np: np.ndarray, device=None):
    """The gate AIR's constant columns into `const_np` (n, const_width);
    the sigma columns are computed on `device` (None: the GPU)."""
    device = dev.resolve(device)
    n = const_np.shape[0]
    fx = layout.fixed

    # gate coefficients
    gates = layout.arith_gates
    if gates:
        q = np.array([(g.qM % P, g.qL % P, g.qR % P, g.qO % P, g.qC % P)
                      for g in gates], dtype=np.uint64)
        gi = np.arange(len(gates))
        rows = layout.arith_row0 + gi // GATES_PER_ROW
        slot = gi % GATES_PER_ROW
        for k, name in enumerate(("qM", "qL", "qR", "qO", "qC")):
            cols = np.array([fx[f"{name}{s}"].index
                             for s in range(GATES_PER_ROW)])[slot]
            const_np[rows, cols] = q[:, k]

    # poseidon rows
    rows, r = _round_rows(layout)
    const_np[rows, fx["POSROW"].index] = 1
    const_np[rows[_full_round(r)], fx["FULLROW"].index] = 1
    pc_cols = [fx[f"PC{j}"].index for j in range(N_WIRES)]
    const_np[rows[:, None], np.array(pc_cols)[None]] = _round_constants()[r]

    # publics rows
    for pr in range(layout.n_pub_rows):
        const_np[pr, fx[f"PUBROW{pr}"].index] = 1

    # sigma: cycles through each wire's cells; untouched cells self-map
    x = gl.powers_device(gl.host_w(layout.n_bits), n, device)
    k = gl.from_u64_np(np.array(layout.k_coeffs, dtype=np.uint64), device)
    sig = gl.mul(x[:, None].expand(n, N_WIRES), k[None].expand(n, N_WIRES))
    # each cell maps to its wire's next cell, the last to the first
    wire, row, col = layout.cells.T
    order = np.argsort(wire, kind="stable")    # cells by wire, in order
    w_sorted = wire[order]
    pos = np.arange(len(order))
    first = np.r_[True, w_sorted[1:] != w_sorted[:-1]]
    last = np.r_[first[1:], True]
    nxt = np.where(last, np.maximum.accumulate(np.where(first, pos, 0)),
                   pos + 1)
    cyc = ~(first & last)                  # wires with two or more cells
    src, dst = order[cyc], order[nxt[cyc]]
    sig[_index(row[src], device), _index(col[src], device)] = gl.mul(
        x[_index(row[dst], device)], k[_index(col[dst], device)])
    sig_cols = np.array([fx[f"SIG{j}"].index for j in range(N_WIRES)])
    const_np[:, sig_cols] = dev.to_u64_np(sig)


def fill_witness(layout: GateLayout, input_values, cm1_np: np.ndarray,
                 device=None, timings: dict | None = None):
    """Execute the circuit and lay wire values + aux columns out on rows;
    the Poseidon round rows and the S-box ladder are computed on `device`
    (None: the GPU).  Returns the wire values; `timings` receives the
    seconds of ``Tracer.run`` (``run_s``)."""
    device = dev.resolve(device)
    n = cm1_np.shape[0]
    wt = layout.witness
    t0 = time.perf_counter()
    vals = layout.tracer.run(input_values)
    if timings is not None:
        timings["run_s"] = time.perf_counter() - t0
    vals_np = np.array(vals, dtype=np.uint64)

    wcols_np = np.zeros((n, N_WIRES), dtype=np.uint64)
    wire, row, col = layout.cells.T
    wcols_np[row, col] = vals_np[wire]
    wcols = gl.from_u64_np(wcols_np, device)

    # poseidon internal state rows: all blocks at once, round by round
    rows, r = _round_rows(layout)
    consts, mds = poseidon_gl._tables(device)
    blocks = layout.pos_blocks
    if blocks:
        r0 = rows[::N_ROUNDS]
        state = gl.from_u64_np(vals_np[np.array([op.inputs for op in blocks])],
                               device)
        for rr in range(N_ROUNDS):
            s = gl.add(state, consts[rr])
            if _full_round(rr):
                s = _sbox(s)
            else:
                s = torch.cat([_sbox(s[:, :1]), s[:, 1:]], dim=1)
            state = poseidon_gl._mds_plain(s, mds)
            wcols[_index(r0 + rr + 1, device)] = state
        expect = vals_np[np.array([op.outputs for op in blocks])]
        if not np.array_equal(dev.to_u64_np(state), expect):
            raise ValueError("poseidon block mismatch")

    # aux S-box ladder columns for every row
    pc_cols = torch.zeros_like(wcols)
    fullrow = torch.zeros(n, dtype=torch.bool, device=device)
    if blocks:
        pc_cols[_index(rows, device)] = consts[_index(r, device)]
        fullrow[_index(rows[_full_round(r)], device)] = True
    s = gl.add(wcols, pc_cols)
    t2 = gl.mul(s, s)
    t4 = gl.mul(t2, t2)
    t6 = gl.mul(t4, t2)
    st6 = gl.mul(s, t6)
    sb = torch.where(fullrow[:, None], st6, s)
    sb[:, 0] = st6[:, 0]
    for name, t in (("w", wcols), ("t2", t2), ("t4", t4), ("t6", t6),
                    ("sb", sb)):
        cols = np.array([wt[f"{name}{j}"].index for j in range(N_WIRES)])
        cm1_np[:, cols] = dev.to_u64_np(t)
    return vals


def _sbox(x):
    x2 = gl.mul(x, x)
    x4 = gl.mul(x2, x2)
    return gl.mul(gl.mul(x4, x2), x)


def publics_of(layout: GateLayout, vals) -> list:
    return [vals[w] for w in layout.tracer.public_wires]
