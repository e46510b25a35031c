"""Storage SM as a provable AIR: the micro-ROM replay committed as
polynomials with the register algebra as constraints.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/storage_sm.py``
(``expand_into`` fills a column at a time, and the zero-test inverses come
from ``fields/gl.py`` on CPU tensors), the equivalent of the reference
Storage SM (storage.pil semantics;
columns mirror commit_pols.hpp StorageCommitPols; row semantics follow
src/sm/storage/storage_executor.cpp, replayed host-side by
executor/storage_executor.py):

  * row i commits the quad register file BEFORE micro-instruction i
    (RKEY, SIBLING_RKEY, VALUE_LOW/HIGH, OLD_ROOT, NEW_ROOT, HASH_LEFT,
    HASH_RIGHT, SIBLING_VALUE_HASH; scalars RKEY_BIT, LEVEL), the pc, the
    free input quad and the op accumulator quad;
  * the micro-instruction at row i (selectors, CONST, setters, HASH /
    CLIMB / LATCH / jump flags — storage_rom_line.hpp:10-60) is committed
    per row and bound to the storage micro-ROM program by a plookup;
  * op accumulation, setter updates and pc transitions (JMPZ/JMPNZ/JMP on
    op[0]) are algebraic constraints; the trace closes cyclically because
    the ROM's end-of-polynomial row N-1 jumps back to pc 0;
  * HASH rows bind (HASH_LEFT || HASH_RIGHT || capacity(hashType)) -> free
    to real PoseidonG SM permutation blocks by a plookup;
  * CLIMB rows bind (source key, LEVEL, effective bit) -> free to the
    ClimbKey SM table (climb_key_sm.py), which proves the integer
    bit-injection with overflow guarding.

Free inputs (mode predicates, sibling hashes, values) are unconstrained
witness exactly as in the reference: soundness comes from the Poseidon
climb chain reproducing OLD_ROOT/NEW_ROOT and from the LATCH rows, which
expose (OLD_ROOT, NEW_ROOT, RKEY, VALUE, LEVEL==0) for the Main SM's
sRD/sWR binding.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...executor.storage_executor import SmtAction, StorageExecutor
from ...executor.storage_rom import StorageRom
from ...fields import gl
from ...stark.air import AirBuilder, Const
from . import climb_key_sm, poseidon_g_sm

P = gl.P

QUAD_REGS = ["RKEY", "SIBLING_RKEY", "VALUE_LOW", "VALUE_HIGH", "OLD_ROOT",
             "NEW_ROOT", "HASH_LEFT", "HASH_RIGHT", "SIBLING_VALUE_HASH"]
# in* selector fields present in the micro-ROM (quad sources + LEVEL + FREE)
INS_QUAD = ["RKEY", "SIBLING_RKEY", "VALUE_LOW", "VALUE_HIGH", "OLD_ROOT",
            "NEW_ROOT", "SIBLING_VALUE_HASH"]
SET_FIELDS = ["RKEY", "SIBLING_RKEY", "VALUE_LOW", "VALUE_HIGH", "OLD_ROOT",
              "NEW_ROOT", "HASH_LEFT", "HASH_RIGHT", "SIBLING_VALUE_HASH",
              "RKEY_BIT", "LEVEL"]
FLAGS = ["hash", "hashType", "latchGet", "latchSet", "climbRkey",
         "climbSiblingRkey", "climbBitN", "jmp", "jmpz", "jmpnz"]

INSTR_FIELDS = ([f"in{f}" for f in INS_QUAD]
                + ["inROTL_VH", "inLEVEL", "inFREE", "CONST"]
                + [f"set{f}" for f in SET_FIELDS] + FLAGS + ["jmpAddress"])


def encode_line(line) -> dict:
    enc = {}
    for f in INS_QUAD:
        enc[f"in{f}"] = line.ins.get(f, 0) % P
    enc["inROTL_VH"] = line.ins.get("ROTL_VH", 0) % P
    enc["inLEVEL"] = line.ins.get("LEVEL", 0) % P
    enc["inFREE"] = line.ins.get("FREE", 0) % P
    enc["CONST"] = (line.const or 0) % P
    for f in SET_FIELDS:
        enc[f"set{f}"] = 1 if f in line.sets else 0
    enc["hash"] = int(line.hash)
    enc["hashType"] = int(line.hash_type)
    enc["latchGet"] = int(line.latch_get)
    enc["latchSet"] = int(line.latch_set)
    enc["climbRkey"] = int(line.climb_rkey)
    enc["climbSiblingRkey"] = int(line.climb_sibling_rkey)
    enc["climbBitN"] = int(line.climb_bit_n)
    enc["jmp"] = int(line.jmp is not None)
    enc["jmpz"] = int(line.jmpz is not None)
    enc["jmpnz"] = int(line.jmpnz is not None)
    enc["jmpAddress"] = (line.jmp if line.jmp is not None else
                         line.jmpz if line.jmpz is not None else
                         line.jmpnz if line.jmpnz is not None else 0)
    return enc


@dataclasses.dataclass
class StorageLayout:
    rom: StorageRom
    fixed: dict
    witness: dict


def build(b: AirBuilder, rom: StorageRom, n_bits: int) -> StorageLayout:
    n = 1 << n_bits
    assert len(rom.lines) <= n, "storage ROM larger than domain"
    fixed = {"S_ROMSEL": b.fixed("S_ROMSEL"), "S_PC": b.fixed("S_PC")}
    for f in INSTR_FIELDS:
        fixed[f"S_{f}"] = b.fixed(f"S_{f}")

    w = {}
    for r in QUAD_REGS:
        for j in range(4):
            w[f"{r}{j}"] = b.witness(f"st_{r}{j}")
    for name in ("RKEY_BIT", "LEVEL", "pc"):
        w[name] = b.witness(f"st_{name}")
    for j in range(4):
        w[f"free{j}"] = b.witness(f"st_free{j}")
        w[f"op{j}"] = b.witness(f"st_op{j}")
    w["isZero"] = b.witness("st_isZero")
    w["invOp0"] = b.witness("st_invOp0")
    w["incCounter"] = b.witness("st_incCounter")
    for f in INSTR_FIELDS:
        w[f] = b.witness(f"si_{f}")

    one = Const(1)

    # ---- micro-ROM binding -------------------------------------------
    b.plookup([w["pc"]] + [w[f] for f in INSTR_FIELDS],
              [fixed["S_PC"]] + [fixed[f"S_{f}"] for f in INSTR_FIELDS],
              t_sel=fixed["S_ROMSEL"])

    # ---- op accumulator ----------------------------------------------
    vh_rot = {0: w["VALUE_HIGH3"], 1: w["VALUE_HIGH0"],
              2: w["VALUE_HIGH1"], 3: w["VALUE_HIGH2"]}
    for j in range(4):
        acc = w["inFREE"] * w[f"free{j}"] + w["inROTL_VH"] * vh_rot[j]
        for r in INS_QUAD:
            acc = acc + w[f"in{r}"] * w[f"{r}{j}"]
        if j == 0:
            acc = acc + w["CONST"] + w["inLEVEL"] * w["LEVEL"]
        b.constrain(w[f"op{j}"] - acc)

    # ---- op0 zero test (for JMPZ/JMPNZ) ------------------------------
    op0 = w["op0"]
    b.constrain(w["isZero"] + op0 * w["invOp0"] - one)
    b.constrain(w["isZero"] * op0)

    # ---- pc transition (cyclic; the ROM's row N-1 jumps to pc 0) -----
    nxt = w["pc"] + one
    target = (w["jmp"] * w["jmpAddress"]
              + w["jmpz"] * (w["isZero"] * w["jmpAddress"]
                             + (one - w["isZero"]) * nxt)
              + w["jmpnz"] * ((one - w["isZero"]) * w["jmpAddress"]
                              + w["isZero"] * nxt)
              + (one - w["jmp"] - w["jmpz"] - w["jmpnz"]) * nxt)
    b.constrain(w["pc"].shifted() - target)

    # ---- setter updates (cyclic) -------------------------------------
    for r in QUAD_REGS:
        s = w[f"set{r}"]
        for j in range(4):
            b.constrain(w[f"{r}{j}"].shifted()
                        - s * w[f"op{j}"] - (one - s) * w[f"{r}{j}"])
    for r in ("RKEY_BIT", "LEVEL"):
        s = w[f"set{r}"]
        b.constrain(w[r].shifted() - s * w["op0"] - (one - s) * w[r])

    # ---- incCounter (reference storage_executor.cpp:1246-1254): +1 on
    # hash rows, reset after a latch, hold otherwise; latch rows expose it
    # for the Main SM's cntPoseidonG binding (proofHashCounter) ----------
    latch = w["latchGet"] + w["latchSet"]
    inc = w["incCounter"]
    b.constrain(inc.shifted() - w["hash"] * (inc + one)
                - (one - w["hash"] - latch) * inc)
    # LATCH rows sit at tree level 0 (reference LATCH semantics)
    b.constrain(latch * w["LEVEL"])

    return StorageLayout(rom=rom, fixed=fixed, witness=w)


def bind(b: AirBuilder, sl: StorageLayout,
         cl: climb_key_sm.ClimbKeyLayout,
         pl: poseidon_g_sm.PoseidonGLayout):
    """Cross-SM lookups: HASH rows -> PoseidonG blocks, CLIMB rows ->
    ClimbKey table.  Requires poseidon_g_sm.build to expose PG_FIRST."""
    w, cw, pw = sl.witness, cl.witness, pl.witness

    f_cols = ([w[f"HASH_LEFT{j}"] for j in range(4)]
              + [w[f"HASH_RIGHT{j}"] for j in range(4)]
              + [w["hashType"], Const(0), Const(0), Const(0)]
              + [w[f"free{j}"] for j in range(4)])
    t_cols = ([pw[f"ps{j}"] for j in range(12)]
              + [pw[f"ps{j}"].shifted(poseidon_g_sm.ROWS_PER_PERM - 1)
                 for j in range(4)])
    b.plookup(f_cols, t_cols, f_sel=w["hash"], t_sel=pl.fixed["PFIRST"])

    climb_sel = w["climbRkey"] + w["climbSiblingRkey"]
    src = {}
    for j in range(4):
        src[j] = (w["climbRkey"] * w[f"RKEY{j}"]
                  + w["climbSiblingRkey"] * w[f"SIBLING_RKEY{j}"])
    bit_eff = (w["RKEY_BIT"] + w["climbBitN"]
               - Const(2) * w["climbBitN"] * w["RKEY_BIT"])
    f_cols = ([src[j] for j in range(4)] + [w["LEVEL"], bit_eff]
              + [w[f"free{j}"] for j in range(4)])
    t_cols = ([cw[f"in{j}"] for j in range(4)] + [cw["level"], cw["bit"]]
              + [cw[f"out{j}"] for j in range(4)])
    b.plookup(f_cols, t_cols, f_sel=climb_sel, t_sel=cw["active"])


def fill_fixed(layout: StorageLayout, const_np: np.ndarray):
    rom = layout.rom
    for i, line in enumerate(rom.lines):
        const_np[i, layout.fixed["S_ROMSEL"].index] = 1
        const_np[i, layout.fixed["S_PC"].index] = i
        enc = encode_line(line)
        for f in INSTR_FIELDS:
            const_np[i, layout.fixed[f"S_{f}"].index] = enc[f]


def expand_into(layout: StorageLayout, actions: List[SmtAction],
                cm1_np: np.ndarray):
    """Replay the actions through the micro-ROM, padded to the domain, and
    fill the committed columns.  Returns (poseidon_required,
    climb_key_required) for the sibling SM expanders."""
    n = cm1_np.shape[0]
    rom = layout.rom
    rows, pg, ck = StorageExecutor(rom).execute(actions, n_rows=n)
    assert len(rows) == n
    assert rows[-1]["pc"] == 284 or rom.lines[rows[-1]["pc"]].jmp == 0, \
        "trace does not close cyclically (domain too small?)"
    w = layout.witness

    def col(name, values):
        cm1_np[:, w[name].index] = np.array(values, dtype=np.uint64)

    pcs = np.array([r["pc"] for r in rows], dtype=np.int64)
    col("pc", pcs)
    # incCounter before each row: +1 after a hash row, 0 after a latch
    col("incCounter", [r["incCounter"] for r in rows])
    for reg in QUAD_REGS:
        quads = np.array([r[reg] for r in rows], dtype=np.uint64)
        for j in range(4):
            cm1_np[:, w[f"{reg}{j}"].index] = quads[:, j]
    col("RKEY_BIT", [r["RKEY_BIT"] for r in rows])
    col("LEVEL", [r["LEVEL"] for r in rows])
    free = np.array([r["free"] for r in rows], dtype=np.uint64)
    op = np.array([r["op"] for r in rows], dtype=np.uint64)
    for j in range(4):
        cm1_np[:, w[f"free{j}"].index] = free[:, j]
        cm1_np[:, w[f"op{j}"].index] = op[:, j]
    encs = [encode_line(line) for line in rom.lines]
    table = np.array([[e[f] for f in INSTR_FIELDS] for e in encs],
                     dtype=np.uint64)[pcs]
    for k, f in enumerate(INSTR_FIELDS):
        cm1_np[:, w[f].index] = table[:, k]
    # zero-test helpers: invOp0 = op0^-1 (0 for zero), isZero = [op0 == 0]
    op0s = op[:, 0]
    nonzero = op0s != 0
    cm1_np[:, w["invOp0"].index] = gl.to_u64_np(
        gl.inv(gl.from_u64_np(op0s, "cpu")))
    cm1_np[:, w["isZero"].index] = (~nonzero).astype(np.uint64)
    return pg, ck
