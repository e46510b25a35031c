"""Main SM as a provable AIR: committed registers + instruction columns
bound to the ROM by a plookup, with the rom_line register-update algebra as
constraints.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/main_sm_air.py``
(``expand_trace`` fills the halt rows that pad execution to the domain in
one assignment a column instead of a row loop).  It is the equivalent of
the reference's Main SM polynomial commitment (fork_9 main.pil semantics; columns mirror
src/main_sm/fork_9/pols_generated/commit_pols.hpp MainCommitPols and the
per-step fill of main_executor.cpp:297-320):

  * row i commits the register file BEFORE step i (A..E, SR as 8x32-bit
    limbs; CTX, SP, PC, GAS, RR, HASHPOS, RCX, zkPC; the 7 SM counters);
  * the instruction word executed at row i (selectors, CONST limbs,
    setters, operation flags, jump targets — rom_line.hpp:15-117) is
    committed per row and bound to the ROM program by a plookup
    (zkPC, instruction...) ∈ RomTable, the AIR analogue of the reference
    main.pil Rom lookup;
  * the op accumulator, setter updates, jump resolution (JMP/JMPN/JMPC/
    JMPZ/call/return/repeat — main_executor.cpp:5072-5160), carry
    propagation and counter updates are algebraic constraints;
  * JMPN sign tests range-check op0 + isNeg*2^32 against the 32-bit window
    through range-table limb decomposition;
  * execution pads to the domain with a synthetic self-loop at the stop
    label (the reference instead relies on the ROM's own finalizeExecution
    wait loop closing the 2^23 cycle).

Storage (sRD/sWR), hash chains (hashK/P/S), memAlign, Binary/Memory,
Arith eq0 and the EC arith equations (eq1-5) all bind through their own
SM circuits (zkevm_air).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...executor.rom import IN_FIELDS, SET_FIELDS, Rom, RomLine
from ...fields import gl
from ...ops.poseidon_gl import host_permute
from ...stark.air import AirBuilder, Const, FirstRowSelector

P = gl.P
MASK32 = (1 << 32) - 1
STACK_OFFSET = 0x10000
MEM_OFFSET = 0x20000
CTX_OFFSET = 0x40000
FR_FIRST_32_NEGATIVE = P - (1 << 32)

# 256-bit registers committed as 8 limbs
WIDE_REGS = ["A", "B", "C", "D", "E", "SR"]
SCALAR_REGS = ["CTX", "SP", "PC", "GAS", "RR", "HASHPOS", "RCX"]
COUNTERS = ["cntArith", "cntBinary", "cntKeccakF", "cntSha256F",
            "cntMemAlign", "cntPaddingPG", "cntPoseidonG"]

INSTR_FLAGS = [
    "JMP", "JMPN", "JMPC", "JMPZ", "call", "return", "useJmpAddr",
    "useElseAddr", "repeat", "assert", "mOp", "mWR", "isStack", "isMem",
    "useCTX", "ind", "indRR", "bin", "sRD", "sWR",
    "arithEq0", "arithEq1", "arithEq2", "arithEq3", "arithEq4", "arithEq5",
    "hashK", "hashK1", "hashKLen", "hashKDigest",
    "hashP", "hashP1", "hashPLen", "hashPDigest",
    "hashS", "hashS1", "hashSLen", "hashSDigest",
    "memAlignRD", "memAlignWR", "memAlignWR8",
]
INSTR_VALUES = ["offset", "jmpAddr", "elseAddr", "binOpcode"]
INSTR_DERIVED = ["isEq0", "incArith", "incMemAlign"]

# full committed instruction-word field list (order is the table encoding)
INSTR_FIELDS = (list(IN_FIELDS) + [f"CONST{i}" for i in range(8)]
                + list(SET_FIELDS) + INSTR_FLAGS + INSTR_VALUES
                + INSTR_DERIVED)


def encode_line(line: RomLine) -> dict:
    """RomLine -> instruction field values (the ROM-table row encoding)."""
    enc = {}
    for f in IN_FIELDS:
        enc[f] = line.ins.get(f, 0) % P
    if line.has_constl:
        c = line.constl % (1 << 256)
        for i in range(8):
            enc[f"CONST{i}"] = (c >> (32 * i)) & MASK32
    else:
        for i in range(8):
            enc[f"CONST{i}"] = 0
        if line.has_const:
            enc["CONST0"] = line.const % P
    for f in SET_FIELDS:
        enc[f] = 1 if f in line.sets else 0
    for f in INSTR_FLAGS:
        enc[f] = 1 if line.flag(f) else 0
    enc["offset"] = line.offset % P
    enc["jmpAddr"] = (line.jmp_addr or 0) % P
    enc["elseAddr"] = (line.else_addr or 0) % P
    enc["binOpcode"] = line.bin_opcode if line.flag("bin") else 0
    any_arith = any(line.flag(f"arithEq{i}") for i in range(6)) \
        or line.flag("arith")
    only_eq0 = line.flag("arithEq0") or not any(
        line.flag(f"arithEq{i}") for i in range(1, 6))
    enc["isEq0"] = 1 if (any_arith and only_eq0) else 0
    enc["incArith"] = 1 if any_arith else 0
    enc["incMemAlign"] = (enc["memAlignRD"] + enc["memAlignWR"]
                          + enc["memAlignWR8"])
    return enc


def halt_encoding(stop_pc: int) -> dict:
    """Synthetic self-loop row used to pad execution to the domain."""
    enc = {f: 0 for f in INSTR_FIELDS}
    enc["JMP"] = 1
    enc["useJmpAddr"] = 1
    enc["jmpAddr"] = stop_pc
    return enc


@dataclasses.dataclass
class MainLayout:
    rom: Rom
    start_pc: int
    stop_pc: int
    range_bits: int
    n_jmpn_limbs: int
    fixed: dict       # M_STEP, M_NOTLAST, M_LAST, M_RANGE, R_ZKPC, R_<field>
    witness: dict     # register/helper/instruction columns
    publics: dict     # name -> Public


def build(b: AirBuilder, rom: Rom, n_bits: int,
          start_label: str = "start",
          stop_label: str = "finalizeExecution") -> MainLayout:
    n = 1 << n_bits
    rb = min(16, n_bits)
    n_jmpn = -(-33 // rb)     # limbs covering the 33-bit JMPN window
    start_pc = rom.label(start_label)
    stop_pc = rom.label(stop_label)
    assert len(rom.program) + 1 <= n, "ROM larger than domain"
    # the RR update below folds call/setRR linearly; valid because no ROM
    # line sets both (checked here, enforced by the ROM plookup)
    assert not any(l.flag("call") and "setRR" in l.sets
                   for l in rom.program)

    fixed = {
        "M_STEP": b.fixed("M_STEP"),
        "M_NOTLAST": b.fixed("M_NOTLAST"),
        "M_LAST": b.fixed("M_LAST"),
        "M_RANGE": b.fixed("M_RANGE"),
        "R_ZKPC": b.fixed("R_ZKPC"),
    }
    for f in INSTR_FIELDS:
        fixed[f"R_{f}"] = b.fixed(f"R_{f}")

    w = {}
    for r in WIDE_REGS:
        for i in range(8):
            w[f"{r}{i}"] = b.witness(f"main_{r}{i}")
    for r in SCALAR_REGS + ["zkPC"] + COUNTERS:
        w[r] = b.witness(f"main_{r}")
    for i in range(8):
        w[f"FREE{i}"] = b.witness(f"main_FREE{i}")
    for i in range(8):
        w[f"op{i}"] = b.witness(f"main_op{i}")
    for name in ("carry", "binCarry", "isNeg", "invOp0", "isZero", "addr",
                 "jmpDest", "elseDest", "zkPCjump", "zkPCnext", "rcxPre",
                 "rcxZero1", "rcxInv1", "rcxZero2", "rcxInv2", "hashBytes",
                 "incCnt"):
        w[name] = b.witness(f"main_{name}")
    # storage-key pipeline (reference sKeyI/sKey committed columns):
    # sCap = Poseidon(C||0)[0:4], sKey = Poseidon(A0..5,B0,B1||sCap)[0:4],
    # each bound to real PoseidonG blocks by zkevm_air's key lookups
    for j in range(4):
        w[f"sCap{j}"] = b.witness(f"main_sCap{j}")
        w[f"sKey{j}"] = b.witness(f"main_sKey{j}")
    for i in range(n_jmpn):
        w[f"jmpnLimb{i}"] = b.witness(f"main_jmpnLimb{i}")
    for f in INSTR_FIELDS:
        w[f] = b.witness(f"i_{f}")

    one = Const(1)
    l1 = FirstRowSelector()
    last = fixed["M_LAST"]
    notlast = fixed["M_NOTLAST"]
    zkpc = w["zkPC"]

    # ---- ROM binding -------------------------------------------------
    b.plookup([zkpc] + [w[f] for f in INSTR_FIELDS],
              [fixed["R_ZKPC"]] + [fixed[f"R_{f}"] for f in INSTR_FIELDS])

    # ---- op accumulator ---------------------------------------------
    rotl = {0: w["C7"]}
    for i in range(1, 8):
        rotl[i] = w[f"C{i-1}"]
    scalar_sources = [("inCTX", w["CTX"]), ("inSP", w["SP"]),
                      ("inPC", w["PC"]), ("inGAS", w["GAS"]),
                      ("inSTEP", fixed["M_STEP"]), ("inRR", w["RR"]),
                      ("inHASHPOS", w["HASHPOS"]), ("inRCX", w["RCX"]),
                      ("inCntArith", w["cntArith"]),
                      ("inCntBinary", w["cntBinary"]),
                      ("inCntKeccakF", w["cntKeccakF"]),
                      ("inCntSha256F", w["cntSha256F"]),
                      ("inCntMemAlign", w["cntMemAlign"]),
                      ("inCntPaddingPG", w["cntPaddingPG"]),
                      ("inCntPoseidonG", w["cntPoseidonG"])]
    for i in range(8):
        acc = w[f"CONST{i}"] + w["inFREE"] * w[f"FREE{i}"] \
            + w["inROTL_C"] * rotl[i]
        for r in WIDE_REGS:
            acc = acc + w[f"in{r}"] * w[f"{r}{i}"]
        if i == 0:
            for sel, src in scalar_sources:
                acc = acc + w[sel] * src
            acc = acc + w["inFREE0"] * w["FREE0"]
        b.constrain(w[f"op{i}"] - acc)

    # ---- address ------------------------------------------------------
    b.constrain(w["addr"] - (w["offset"]
                             + w["isStack"] * (w["SP"] + Const(STACK_OFFSET))
                             + w["ind"] * w["E0"] + w["indRR"] * w["RR"]
                             + w["useCTX"] * w["CTX"] * Const(CTX_OFFSET)
                             + w["isMem"] * Const(MEM_OFFSET)))

    # ---- jump destinations -------------------------------------------
    b.constrain(w["jmpDest"] - w["useJmpAddr"] * w["jmpAddr"]
                - (one - w["useJmpAddr"]) * w["addr"])
    b.constrain(w["elseDest"] - w["useElseAddr"] * w["elseAddr"]
                - (one - w["useElseAddr"]) * (zkpc + one))

    # ---- op0 zero test ------------------------------------------------
    op0 = w["op0"]
    b.constrain(w["isZero"] + op0 * w["invOp0"] - one)
    b.constrain(w["isZero"] * op0)

    # ---- JMPN sign test ----------------------------------------------
    isneg = w["isNeg"]
    b.constrain(isneg * (isneg - one))
    b.constrain((one - w["JMPN"]) * isneg)
    decomp = None
    for i in range(n_jmpn):
        term = w[f"jmpnLimb{i}"] * Const(1 << (rb * i))
        decomp = term if decomp is None else decomp + term
        b.plookup([w[f"jmpnLimb{i}"]], [fixed["M_RANGE"]])
    b.constrain(w["JMPN"] * (op0 + isneg * Const(1 << 32) - decomp))

    # ---- carry chain --------------------------------------------------
    carry = w["carry"]
    b.constrain(l1 * (carry - w["bin"] * w["binCarry"]))
    b.constrain(notlast * (carry.shifted()
                           - w["bin"].shifted() * w["binCarry"].shifted()
                           - (one - w["bin"].shifted()) * carry))

    # ---- RCX / repeat -------------------------------------------------
    rcx = w["RCX"]
    b.constrain(w["rcxPre"] - w["setRCX"] * op0
                - (one - w["setRCX"]) * rcx)
    b.constrain(w["rcxZero1"] + w["rcxPre"] * w["rcxInv1"] - one)
    b.constrain(w["rcxZero1"] * w["rcxPre"])
    b.constrain(notlast * (rcx.shifted() - w["rcxPre"]
                           + w["repeat"] * (one - w["rcxZero1"])))
    b.constrain(notlast * (w["rcxZero2"] + rcx.shifted() * w["rcxInv2"]
                           - one))
    b.constrain(notlast * w["rcxZero2"] * rcx.shifted())

    # ---- zkPC resolution ---------------------------------------------
    rr_used = w["setRR"] * op0 + (one - w["setRR"]) * w["RR"]
    jump_sum = (w["JMPN"] * (isneg * w["jmpDest"]
                             + (one - isneg) * w["elseDest"])
                + w["JMPC"] * (carry * w["jmpDest"]
                               + (one - carry) * w["elseDest"])
                + w["JMPZ"] * (w["isZero"] * w["jmpDest"]
                               + (one - w["isZero"]) * w["elseDest"])
                + (w["JMP"] + w["call"]) * w["jmpDest"]
                + w["return"] * rr_used)
    no_jump = (one - w["JMP"] - w["JMPN"] - w["JMPC"] - w["JMPZ"]
               - w["call"] - w["return"])
    b.constrain(w["zkPCjump"] - jump_sum - no_jump * (zkpc + one))
    b.constrain(w["zkPCnext"] - w["zkPCjump"]
                - w["repeat"] * (one - w["rcxZero2"])
                * (zkpc - w["zkPCjump"]))
    b.constrain(notlast * (zkpc.shifted() - w["zkPCnext"]))

    # ---- register updates --------------------------------------------
    for r in WIDE_REGS:
        setr = w[f"set{r}"]
        for i in range(8):
            reg = w[f"{r}{i}"]
            b.constrain(notlast * (reg.shifted() - setr * w[f"op{i}"]
                                   - (one - setr) * reg))
    for r in ("CTX", "SP", "PC", "GAS"):
        setr = w[f"set{r}"]
        reg = w[r]
        b.constrain(notlast * (reg.shifted() - setr * op0
                               - (one - setr) * reg))
    # RR: setters run before control flow; call then overwrites (no ROM
    # line has both, asserted above)
    b.constrain(notlast * (w["RR"].shifted()
                           - w["call"] * (zkpc + one)
                           - w["setRR"] * op0
                           - (one - w["setRR"] - w["call"]) * w["RR"]))
    # HASHPOS: hash data ops advance by hashBytes before a setter overrides
    b.constrain(notlast * (w["HASHPOS"].shifted()
                           - w["setHASHPOS"] * op0
                           - (one - w["setHASHPOS"])
                           * (w["HASHPOS"] + w["hashBytes"])))
    hash_any = (w["hashK"] + w["hashK1"] + w["hashP"] + w["hashP1"]
                + w["hashS"] + w["hashS1"])
    b.constrain((one - hash_any) * w["hashBytes"])

    # ---- counters -----------------------------------------------------
    # Unit counters step by ROM-bound flags; hash/storage counters step by
    # the committed incCnt at the Digest / sRD / sWR row (reference
    # main.pil incCounter: padded-block count at hashKDigest/hashSDigest/
    # hashPDigest, proofHashCounter+2 at sRD/sWR — main_executor.cpp:2906,
    # :3219, :3478, :2557).  On storage rows incCnt is bound to the
    # Storage SM's own incCounter through the latch lookup (zkevm_air).
    inc_cnt = w["incCnt"]
    incs = {"cntArith": w["incArith"], "cntBinary": w["bin"],
            "cntKeccakF": w["hashKDigest"] * inc_cnt,
            "cntSha256F": w["hashSDigest"] * inc_cnt,
            "cntMemAlign": w["incMemAlign"],
            "cntPaddingPG": w["hashPDigest"] * inc_cnt,
            "cntPoseidonG": (w["sRD"] + w["sWR"] + w["hashPDigest"])
            * inc_cnt}
    for cnt in COUNTERS:
        c = w[cnt]
        b.constrain(notlast * (c.shifted() - c - incs[cnt]))
        b.constrain(l1 * c)

    # ---- assert op ----------------------------------------------------
    for i in range(8):
        b.constrain(w["assert"] * (w[f"A{i}"] - w[f"op{i}"]))

    # ---- boundary conditions / publics -------------------------------
    b.constrain(l1 * (zkpc - Const(start_pc)))
    publics = {}
    for i in range(8):
        publics[f"oldStateRoot{i}"] = b.public(w[f"B{i}"], 0)
        b.constrain(l1 * (w[f"SR{i}"] - publics[f"oldStateRoot{i}"]))
    for i in range(8):
        publics[f"oldAccInputHash{i}"] = b.public(w[f"C{i}"], 0)
    publics["oldBatchNum"] = b.public(w["SP"], 0)
    publics["chainID"] = b.public(w["GAS"], 0)
    publics["forkID"] = b.public(w["CTX"], 0)
    for r in ("A", "D", "E"):
        for i in range(8):
            b.constrain(l1 * w[f"{r}{i}"])
    for r in ("PC", "RR", "HASHPOS", "RCX"):
        b.constrain(l1 * w[r])
    for i in range(8):
        p = b.public_value()
        publics[f"newStateRoot{i}"] = p
        b.constrain(last * (w[f"SR{i}"] - p))
    # full reference publics surface (prover.cpp:494-543): newAccInputHash
    # = D(lastN), newLocalExitRoot = E(lastN), newBatchNum = PC(lastN) —
    # 44 publics total, same slot order
    for i in range(8):
        p = b.public_value()
        publics[f"newAccInputHash{i}"] = p
        b.constrain(last * (w[f"D{i}"] - p))
    for i in range(8):
        p = b.public_value()
        publics[f"newLocalExitRoot{i}"] = p
        b.constrain(last * (w[f"E{i}"] - p))
    p = b.public_value()
    publics["newBatchNum"] = p
    b.constrain(last * (w["PC"] - p))

    return MainLayout(rom=rom, start_pc=start_pc, stop_pc=stop_pc,
                      range_bits=rb, n_jmpn_limbs=n_jmpn, fixed=fixed,
                      witness=w, publics=publics)


def fill_fixed(layout: MainLayout, const_np: np.ndarray):
    n = const_np.shape[0]
    idx = np.arange(n, dtype=np.uint64)
    const_np[:, layout.fixed["M_STEP"].index] = idx
    const_np[:, layout.fixed["M_NOTLAST"].index] = 1
    const_np[n - 1, layout.fixed["M_NOTLAST"].index] = 0
    const_np[n - 1, layout.fixed["M_LAST"].index] = 1
    const_np[:, layout.fixed["M_RANGE"].index] = \
        idx % (1 << layout.range_bits)

    # ROM table: program lines, then the synthetic halt row (self-loop at
    # the stop label), then halt-row padding
    rows = [(zkpc, encode_line(line))
            for zkpc, line in enumerate(layout.rom.program)]
    halt = (layout.stop_pc, halt_encoding(layout.stop_pc))
    rows.append(halt)
    const_np[:, layout.fixed["R_ZKPC"].index] = halt[0]
    for f in INSTR_FIELDS:
        const_np[:, layout.fixed[f"R_{f}"].index] = halt[1][f]
    for r, (zkpc, enc) in enumerate(rows):
        const_np[r, layout.fixed["R_ZKPC"].index] = zkpc
        for f in INSTR_FIELDS:
            const_np[r, layout.fixed[f"R_{f}"].index] = enc[f]


def _row_values(layout: MainLayout, rec, next_counters, final_regs):
    """name -> value of the Main SM committed columns on one row: a step's
    trace record `rec`, or (rec None) a halt row after the last step."""
    rb = layout.range_bits
    if rec is not None:
        regs = rec["regs"]
        enc = rec["enc"]
        op = rec["op"]
        free = rec["free"]
        carry = rec["carry"]
        bin_carry = rec["binCarry"]
        counters = rec["counters"]
        hash_bytes = rec["hashBytes"]
        zkpc = rec["zkPC"]
        rcx_next = rec["rcxNext"]
    else:
        regs = final_regs
        enc = halt_encoding(layout.stop_pc)
        op = [0] * 8
        free = [0] * 8
        carry = final_regs["carry"]
        bin_carry = 0
        counters = final_regs["counters"]
        hash_bytes = 0
        zkpc = layout.stop_pc
        rcx_next = regs["RCX"]

    vals = {}
    for r in WIDE_REGS:
        for i in range(8):
            vals[f"{r}{i}"] = regs[r][i]
    for r in SCALAR_REGS:
        vals[r] = regs[r]
    vals["zkPC"] = zkpc
    for k, cnt in enumerate(COUNTERS):
        vals[cnt] = counters[k]
    for i in range(8):
        vals[f"FREE{i}"] = free[i]
        vals[f"op{i}"] = op[i]
    for f in INSTR_FIELDS:
        vals[f] = enc[f]
    vals["carry"] = carry
    vals["binCarry"] = bin_carry
    vals["hashBytes"] = hash_bytes

    # helper columns, from the committed algebra
    inv = gl.host_inv
    op0 = op[0] % P
    vals["invOp0"] = inv(op0) if op0 else 0
    vals["isZero"] = 0 if op0 else 1
    is_neg = 1 if (enc["JMPN"] and op0 >= FR_FIRST_32_NEGATIVE) else 0
    vals["isNeg"] = is_neg
    if enc["JMPN"]:
        window = (op0 + is_neg * (1 << 32)) % P
        assert window < (1 << (rb * layout.n_jmpn_limbs))
    else:
        window = 0
    for i in range(layout.n_jmpn_limbs):
        vals[f"jmpnLimb{i}"] = (window >> (rb * i)) & ((1 << rb) - 1)
    addr = (enc["offset"]
            + enc["isStack"] * ((regs["SP"] + STACK_OFFSET) % P)
            + enc["ind"] * regs["E"][0] + enc["indRR"] * regs["RR"]
            + enc["useCTX"] * regs["CTX"] * CTX_OFFSET
            + enc["isMem"] * MEM_OFFSET) % P
    vals["addr"] = addr
    jmp_dest = enc["jmpAddr"] if enc["useJmpAddr"] else addr
    else_dest = enc["elseAddr"] if enc["useElseAddr"] else (zkpc + 1) % P
    vals["jmpDest"] = jmp_dest
    vals["elseDest"] = else_dest
    rr_used = op0 if enc["setRR"] else regs["RR"]
    if enc["JMPN"]:
        jump = jmp_dest if is_neg else else_dest
    elif enc["JMPC"]:
        jump = jmp_dest if carry else else_dest
    elif enc["JMPZ"]:
        jump = jmp_dest if op0 == 0 else else_dest
    elif enc["JMP"] or enc["call"]:
        jump = jmp_dest
    elif enc["return"]:
        jump = rr_used
    else:
        jump = (zkpc + 1) % P
    vals["zkPCjump"] = jump
    # variable counter increment + storage-key pipeline
    if rec is not None:
        cur = rec["counters"]
        if enc["hashKDigest"]:
            vals["incCnt"] = next_counters[2] - cur[2]
        elif enc["hashSDigest"]:
            vals["incCnt"] = next_counters[3] - cur[3]
        elif enc["hashPDigest"]:
            vals["incCnt"] = next_counters[5] - cur[5]
        elif enc["sRD"] or enc["sWR"]:
            vals["incCnt"] = next_counters[6] - cur[6]
        if enc["sRD"] or enc["sWR"]:
            kin0 = [int(v) for v in regs["C"]] + [0, 0, 0, 0]
            cap = host_permute(kin0)[:4]
            kin1 = [int(v) for v in regs["A"][0:6]] \
                + [int(regs["B"][0]), int(regs["B"][1])] + list(cap)
            key = host_permute(kin1)[:4]
            for j in range(4):
                vals[f"sCap{j}"] = cap[j]
                vals[f"sKey{j}"] = key[j]

    rcx_pre = op0 if enc["setRCX"] else regs["RCX"]
    vals["rcxPre"] = rcx_pre
    vals["rcxZero1"] = 0 if rcx_pre else 1
    vals["rcxInv1"] = inv(rcx_pre) if rcx_pre else 0
    vals["rcxZero2"] = 0 if rcx_next else 1
    vals["rcxInv2"] = inv(rcx_next) if rcx_next else 0
    vals["zkPCnext"] = zkpc if (enc["repeat"] and rcx_next) else jump
    return vals


def expand_trace(layout: MainLayout, records, final_regs, cm1_np: np.ndarray):
    """Fill the Main SM committed columns from execution trace records.

    records: list of per-step dicts captured by MainExecutor when tracing
    (see executor/main_sm.py); final_regs: register dict after the last
    step.  Rows past the last step are identical halt rows (the
    synthetic self-loop at the stop label), filled once a column.
    """
    n = cm1_np.shape[0]
    w = layout.witness
    n_steps = len(records)
    assert n_steps < n, "trace does not fit the domain"
    final_counters = final_regs["counters"]
    for row, rec in enumerate(records):
        next_counters = records[row + 1]["counters"] \
            if row + 1 < n_steps else final_counters
        for name, val in _row_values(layout, rec, next_counters,
                                     final_regs).items():
            cm1_np[row, w[name].index] = val % P
    for name, val in _row_values(layout, None, None, final_regs).items():
        cm1_np[n_steps:, w[name].index] = val % P


def publics_list(layout: MainLayout, records, final_regs):
    """Public input vector in declaration order (the reference's 44-slot
    layout, prover.cpp:494-543)."""
    first = records[0]["regs"]
    pubs = []
    pubs += [first["B"][i] for i in range(8)]       # oldStateRoot
    pubs += [first["C"][i] for i in range(8)]       # oldAccInputHash
    pubs += [first["SP"], first["GAS"], first["CTX"]]
    pubs += [final_regs["SR"][i] for i in range(8)]  # newStateRoot
    pubs += [final_regs["D"][i] for i in range(8)]   # newAccInputHash
    pubs += [final_regs["E"][i] for i in range(8)]   # newLocalExitRoot
    pubs += [final_regs["PC"]]                       # newBatchNum
    return pubs
