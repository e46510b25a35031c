"""The zkEVM circuit: Main SM + Binary SM + Memory SM + Arith SM +
Storage SM + ClimbKey SM + PoseidonG SM in ONE AIR over a shared domain,
with cross-SM arguments binding them.

This is the architecture of the reference's full zkevm STARK (751 committed
polynomials over one 2^23 domain, commit_pols.hpp:1735-1737; the Executor
fills per-SM column groups, executor.cpp:487-704; PIL lookups bind Main
rows to each secondary SM):

  * Main SM commits registers + ROM-bound instruction columns per step
    (models/zkevm/main_sm_air.py);
  * every Main `bin` row looks up (binOpcode, A, B, op, carry) among the
    Binary SM's completed ops;
  * every Main `arithEq0` row looks up (A, B, C, D, op) among the Arith
    SM's proven A*B + C = D*2^256 + op relations (the 32-bit tuple limbs
    recompose the Arith SM's 16-bit-limb rows through multi-row shifts);
  * Main memory rows bind to the Memory SM's sorted-access consistency
    argument by a selected permutation over (addr, step, wr, value);
  * Main sRD/sWR rows derive the SMT key through two real PoseidonG
    permutations (sCap = H(C||0), sKey = H(A[0:6],B[0:2]||sCap) — the
    reference key_utils.cpp derivation) bound by plookups into the
    PoseidonG SM table, then look up (oldRoot, [newRoot,] sKey, value,
    incCounter+2) among the Storage SM's LATCH rows (reference main.pil
    storage lookups; storage_executor.cpp:899-1035 latch semantics);
  * the Storage SM replays the SMT micro-ROM with its own Poseidon and
    ClimbKey bindings (storage_sm.bind).

Hash chains: Main hashP/hashK/hashS rows bind to the PaddingPG /
PaddingKK->KeccakF / PaddingSha256->Sha256F chain circuits (data access,
length, digest + block-count lookups); the chains themselves prove the
padding, sponge/Merkle-Damgard chaining and the gate-level permutations
(chains need n_bits >= 18 for a gate slot).  Main memAlignRD/WR/WR8 rows
bind operand limb tuples to the MemAlign SM blocks (mem_align_sm); Main
arithEq1-5 rows bind (kind, operands) tuples to the Arith EC circuit
(arith_ec_sm) — with these, every Main operation class is circuit-bound.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/zkevm_air.py``,
with every state machine and binding of the JAX package's: Storage and
ClimbKey when a ``storage_rom`` is given, the Keccak-F and SHA-256-F
chains from n_bits 18 (one gate slot each).  The expanders run one after
the other (they fill disjoint column ranges).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ...stark.air import AirBuilder, Const
from . import (arith_ec_sm, arith_sm, binary_sm, climb_key_sm,
               keccak_chain_sm, main_sm_air, mem_align_sm, memory_sm,
               padding_pg_sm, poseidon_g_sm, sha_chain_sm, storage_sm)


@dataclasses.dataclass
class ZkevmLayout:
    main: main_sm_air.MainLayout
    binary: binary_sm.BinaryLayout
    memory: memory_sm.MemoryLayout
    arith: arith_sm.ArithLayout
    poseidon: poseidon_g_sm.PoseidonGLayout
    storage: Optional[storage_sm.StorageLayout] = None
    climb_key: Optional[climb_key_sm.ClimbKeyLayout] = None
    padding_pg: Optional[padding_pg_sm.PaddingPGLayout] = None
    keccak: Optional[keccak_chain_sm.KeccakChainLayout] = None
    sha: Optional[sha_chain_sm.ShaChainLayout] = None
    mem_align: Optional[mem_align_sm.MemAlignLayout] = None
    arith_ec: Optional[arith_ec_sm.ArithEcLayout] = None


def build(rom, n_bits: int = 16, chunk_bits: int = 4, limb_bits: int = 16,
          n_queries: int = 8, start_label: str = "start",
          stop_label: str = "finalizeExecution", storage_rom=None,
          with_padding_pg: bool = True, with_keccak: bool = None,
          with_sha: bool = None):
    # the keccak gate slot needs >153k rows (one 48-lane permutation);
    # the sha256 slot needs >186k
    if with_keccak is None:
        with_keccak = n_bits >= 18
    if with_sha is None:
        with_sha = n_bits >= 18
    b = AirBuilder("zkevm", n_bits, n_queries=n_queries, fri_fold_bits=3)
    main = main_sm_air.build(b, rom, n_bits, start_label, stop_label)
    binl = binary_sm.build(b, n_bits, chunk_bits)
    meml = memory_sm.build(b, n_bits)
    aril = arith_sm.build(b, 256, limb_bits)
    posl = poseidon_g_sm.build(b, n_bits)
    storl = ckl = None
    if storage_rom is not None:
        storl = storage_sm.build(b, storage_rom, n_bits)
        ckl = climb_key_sm.build(b, n_bits,
                                 range_table=main.fixed["M_RANGE"])
        storage_sm.bind(b, storl, ckl, posl)
    ppl = padding_pg_sm.build(b, n_bits) if with_padding_pg else None
    kcl = keccak_chain_sm.build(b, n_bits) if with_keccak else None
    scl = sha_chain_sm.build(b, n_bits) if with_sha else None
    # memAlign factor table needs 2112 rows
    mal = mem_align_sm.build(b, n_bits) if n_bits >= 12 else None
    ecl = arith_ec_sm.build(b, limb_bits, aril.fixed["RANGE_LIMB"])

    mw, mf = main.witness, main.fixed

    # ---- Main -> Binary ----------------------------------------------
    f_cols = [mw["binOpcode"]]
    t_cols = [binl.witness["op"]]
    for reg, v in (("A", "a"), ("B", "b")):
        f_cols += [mw[f"{reg}{j}"] for j in range(8)]
        t_cols += [binl.witness[f"{v}{j}"] for j in range(8)]
    f_cols += [mw[f"op{j}"] for j in range(8)] + [mw["binCarry"]]
    t_cols += [binl.witness[f"res{j}"] for j in range(8)] \
        + [binl.witness["c_out"]]
    b.plookup(f_cols, t_cols, f_sel=mw["bin"], t_sel=binl.fixed["LAST"])

    # ---- Main -> Arith (eq0) -----------------------------------------
    cp32 = 32 // aril.limb_bits      # arith limbs per 32-bit tuple limb
    f_cols = []
    t_cols = []
    for reg, acol in (("A", "a"), ("B", "b"), ("C", "c"), ("D", "d")):
        for j in range(8):
            f_cols.append(mw[f"{reg}{j}"])
            expr = None
            for k in range(cp32):
                limb = aril.witness[acol].shifted(j * cp32 + k) \
                    if (j * cp32 + k) else aril.witness[acol]
                term = limb * (1 << (aril.limb_bits * k))
                expr = term if expr is None else expr + term
            t_cols.append(expr)
    for j in range(8):
        f_cols.append(mw[f"op{j}"])
        expr = None
        for k in range(cp32):
            sh = j * cp32 + k
            limb = aril.witness["e"].shifted(sh) if sh else aril.witness["e"]
            term = limb * (1 << (aril.limb_bits * k))
            expr = term if expr is None else expr + term
        t_cols.append(expr)
    b.plookup(f_cols, t_cols, f_sel=mw["isEq0"], t_sel=aril.fixed["FIRST"])

    # ---- Main <-> Memory ---------------------------------------------
    f_cols = [mw["addr"], mf["M_STEP"], mw["mWR"]] \
        + [mw[f"op{j}"] for j in range(8)]
    t_cols = [meml.witness["addr"], meml.witness["step"],
              meml.witness["is_write"]] \
        + [meml.witness[f"val{j}"] for j in range(8)]
    b.permutation(f_cols, t_cols, f_sel=mw["mOp"],
                  t_sel=meml.witness["active"])

    # ---- Main -> PoseidonG: SMT key derivation -----------------------
    # (reference key_utils.cpp keyEthAddrBalance/...: two chained
    # permutations; requests recorded by main_sm._storage_key)
    s_sel = mw["sRD"] + mw["sWR"]
    pg_table = ([posl.witness[f"ps{j}"] for j in range(12)]
                + [posl.witness[f"ps{j}"]
                   .shifted(poseidon_g_sm.ROWS_PER_PERM - 1)
                   for j in range(4)])
    f_cols = [mw[f"C{j}"] for j in range(8)] + [Const(0)] * 4 \
        + [mw[f"sCap{j}"] for j in range(4)]
    b.plookup(f_cols, pg_table, f_sel=s_sel, t_sel=posl.fixed["PFIRST"])
    f_cols = [mw[f"A{j}"] for j in range(6)] + [mw["B0"], mw["B1"]] \
        + [mw[f"sCap{j}"] for j in range(4)] \
        + [mw[f"sKey{j}"] for j in range(4)]
    b.plookup(f_cols, pg_table, f_sel=s_sel, t_sel=posl.fixed["PFIRST"])

    # ---- Main -> Storage latch rows ----------------------------------
    if storl is not None:
        sw = storl.witness
        two32 = Const(1 << 32)

        def sr_quad(j):
            return mw[f"SR{2 * j}"] + two32 * mw[f"SR{2 * j + 1}"]

        def op_quad(j):
            return mw[f"op{2 * j}"] + two32 * mw[f"op{2 * j + 1}"]

        # sRD: {oldRoot, key, value, incCounter} in latchGet rows
        f_cols = ([sr_quad(j) for j in range(4)]
                  + [mw[f"sKey{j}"] for j in range(4)]
                  + [mw[f"op{j}"] for j in range(8)]
                  + [mw["incCnt"]])
        t_cols = ([sw[f"OLD_ROOT{j}"] for j in range(4)]
                  + [sw[f"RKEY{j}"] for j in range(4)]
                  + [sw[f"VALUE_LOW{j}"] for j in range(4)]
                  + [sw[f"VALUE_HIGH{j}"] for j in range(4)]
                  + [sw["incCounter"] + Const(2)])
        b.plookup(f_cols, t_cols, f_sel=mw["sRD"], t_sel=sw["latchGet"])

        # sWR: {oldRoot, newRoot=op, key, value=D, incCounter}
        f_cols = ([sr_quad(j) for j in range(4)]
                  + [op_quad(j) for j in range(4)]
                  + [mw[f"sKey{j}"] for j in range(4)]
                  + [mw[f"D{j}"] for j in range(8)]
                  + [mw["incCnt"]])
        t_cols = ([sw[f"OLD_ROOT{j}"] for j in range(4)]
                  + [sw[f"NEW_ROOT{j}"] for j in range(4)]
                  + [sw[f"RKEY{j}"] for j in range(4)]
                  + [sw[f"VALUE_LOW{j}"] for j in range(4)]
                  + [sw[f"VALUE_HIGH{j}"] for j in range(4)]
                  + [sw["incCounter"] + Const(2)])
        b.plookup(f_cols, t_cols, f_sel=mw["sWR"], t_sel=sw["latchSet"])

    # ---- Main -> PaddingPG (hashP chain) -----------------------------
    if ppl is not None:
        pw = ppl.witness
        two32 = Const(1 << 32)
        # data access rows: (addr, start pos, byte count, value)
        f_cols = [mw["addr"], mw["HASHPOS"], mw["hashBytes"]] \
            + [mw[f"op{j}"] for j in range(8)]
        t_cols = [pw["addr"], ppl.pos_expr(), pw["crLen"]] \
            + [pw[f"crV{j}"] for j in range(8)]
        b.plookup(f_cols, t_cols, f_sel=mw["hashP"] + mw["hashP1"],
                  t_sel=pw["crLatch"])
        # hashPLen: (addr, length)
        b.plookup([mw["addr"], mw["op0"]], [pw["addr"], pw["len"]],
                  f_sel=mw["hashPLen"], t_sel=pw["lastHash"])
        # hashPDigest: (addr, curHash quads, block count) — op limb pairs
        # recompose the 4x64-bit digest (fea2scalar packing); incCnt is
        # the counter bump ceil((len+1)/56)
        f_cols = [mw["addr"]] \
            + [mw[f"op{2 * j}"] + two32 * mw[f"op{2 * j + 1}"]
               for j in range(4)] + [mw["incCnt"]]
        t_cols = [pw["addr"]] + [pw[f"curHash{j}"] for j in range(4)] \
            + [pw["incCounter"]]
        b.plookup(f_cols, t_cols, f_sel=mw["hashPDigest"],
                  t_sel=pw["lastHash"])
        # block rows -> PoseidonG permutation instances
        f_cols, f_sel = padding_pg_sm.poseidon_lookup_cols(ppl)
        b.plookup(f_cols, pg_table, f_sel=f_sel, t_sel=posl.fixed["PFIRST"])

    # ---- Main -> PaddingKK (hashK chain) -----------------------------
    if kcl is not None:
        kw = kcl.kk.witness
        two32 = Const(1 << 32)
        f_cols = [mw["addr"], mw["HASHPOS"], mw["hashBytes"]] \
            + [mw[f"op{j}"] for j in range(8)]
        t_cols = [kw["addr"], kcl.kk.pos_expr(), kw["crLen"]] \
            + [kw[f"crV{j}"] for j in range(8)]
        b.plookup(f_cols, t_cols, f_sel=mw["hashK"] + mw["hashK1"],
                  t_sel=kw["crLatch"])
        b.plookup([mw["addr"], mw["op0"]], [kw["addr"], kw["len"]],
                  f_sel=mw["hashKLen"], t_sel=kw["lastHash"])
        # digest: op limbs are already 32-bit — direct limb match, plus
        # the incCounter block count driving cntKeccakF
        f_cols = [mw["addr"]] + [mw[f"op{j}"] for j in range(8)] \
            + [mw["incCnt"]]
        t_cols = [kw["addr"]] + [kw[f"hash{j}"] for j in range(8)] \
            + [kw["incCounter"]]
        b.plookup(f_cols, t_cols, f_sel=mw["hashKDigest"],
                  t_sel=kw["lastHash"])

    # ---- Main -> PaddingSha256 (hashS chain) -------------------------
    if scl is not None:
        sw = scl.ps.witness
        f_cols = [mw["addr"], mw["HASHPOS"], mw["hashBytes"]] \
            + [mw[f"op{j}"] for j in range(8)]
        t_cols = [sw["addr"], scl.ps.pos_expr(), sw["crLen"]] \
            + [sw[f"crV{j}"] for j in range(8)]
        b.plookup(f_cols, t_cols, f_sel=mw["hashS"] + mw["hashS1"],
                  t_sel=sw["crLatch"])
        b.plookup([mw["addr"], mw["op0"]], [sw["addr"], sw["len"]],
                  f_sel=mw["hashSLen"], t_sel=sw["lastHash"])
        # digest: op limbs are 32-bit big-endian sha words (op_j =
        # word_{7-j}); incCounter block count drives cntSha256F
        f_cols = [mw["addr"]] + [mw[f"op{j}"] for j in range(8)] \
            + [mw["incCnt"]]
        t_cols = [sw["addr"]] + [sw[f"hash{j}"] for j in range(8)] \
            + [sw["incCounter"]]
        b.plookup(f_cols, t_cols, f_sel=mw["hashSDigest"],
                  t_sel=sw["lastHash"])

    # ---- Main -> MemAlign --------------------------------------------
    # One t-side tuple per 32-row block at its first row: the op kind,
    # offset, and the five 256-bit operands as shifted-byte-sum limbs
    # (v through the rotation accumulators).  C1..C7 bind to zero so the
    # offset is exactly C (main_executor.cpp:4510-4521).
    if mal is not None:
        maw = mal.witness
        t_cols = [maw["wr256"], maw["wr8"], maw["offset"]]
        for col in ("inM0", "inM1"):
            t_cols += [mal.m_limb(maw[col], j) for j in range(8)]
        t_cols += [mal.v_limb(j) for j in range(8)]
        for col in ("inW0", "inW1"):
            t_cols += [mal.m_limb(maw[col], j) for j in range(8)]
        t_cols += [Const(0)] * 7
        zero8 = [Const(0)] * 8
        a_limbs = [mw[f"A{j}"] for j in range(8)]
        b_limbs = [mw[f"B{j}"] for j in range(8)]
        op_limbs = [mw[f"op{j}"] for j in range(8)]
        d_limbs = [mw[f"D{j}"] for j in range(8)]
        e_limbs = [mw[f"E{j}"] for j in range(8)]
        c_rest = [mw[f"C{j}"] for j in range(1, 8)]
        ma_first = mal.fixed["FIRST"]
        b.plookup([Const(0), Const(0), mw["C0"]] + a_limbs + b_limbs
                  + op_limbs + zero8 + zero8 + c_rest,
                  t_cols, f_sel=mw["memAlignRD"], t_sel=ma_first)
        b.plookup([Const(1), Const(0), mw["C0"]] + a_limbs + b_limbs
                  + op_limbs + d_limbs + e_limbs + c_rest,
                  t_cols, f_sel=mw["memAlignWR"], t_sel=ma_first)
        # WR8 leaves m1 untouched (w1 = m1; Main only checks D = w0)
        b.plookup([Const(0), Const(1), mw["C0"]] + a_limbs + b_limbs
                  + op_limbs + d_limbs + b_limbs + c_rest,
                  t_cols, f_sel=mw["memAlignWR8"], t_sel=ma_first)

    # ---- Main -> Arith EC (eq1-5) -------------------------------------
    # One binding tuple per 2L-row block at its first row: a kind tag
    # (1=ECADD, 2=ECDBL, 3/4/5=BN254 mul/add/sub) plus the six 256-bit
    # operands as limb recombinations.  ECDBL substitutes x2=A, y2=B.
    t_cols = [ecl.kind_expr()]
    for name in ("x1", "y1", "x2", "y2", "x3", "y3"):
        t_cols += [ecl.limb32(name, j) for j in range(8)]
    a_limbs = [mw[f"A{j}"] for j in range(8)]
    b_limbs = [mw[f"B{j}"] for j in range(8)]
    kind_f = (mw["arithEq1"] + mw["arithEq3"] * 3 + mw["arithEq4"] * 4
              + mw["arithEq5"] * 5)
    f_cols = [kind_f] + a_limbs + b_limbs \
        + [mw[f"C{j}"] for j in range(8)] + [mw[f"D{j}"] for j in range(8)] \
        + [mw[f"E{j}"] for j in range(8)] + [mw[f"op{j}"] for j in range(8)]
    ec_sel = (mw["arithEq1"] + mw["arithEq3"] + mw["arithEq4"]
              + mw["arithEq5"])
    b.plookup(f_cols, t_cols, f_sel=ec_sel, t_sel=ecl.fixed["EC_FIRST"])
    f_dbl = [Const(2)] + a_limbs + b_limbs + a_limbs + b_limbs \
        + [mw[f"E{j}"] for j in range(8)] + [mw[f"op{j}"] for j in range(8)]
    b.plookup(f_dbl, t_cols, f_sel=mw["arithEq2"],
              t_sel=ecl.fixed["EC_FIRST"])

    air = b.compile()
    return air, ZkevmLayout(main=main, binary=binl, memory=meml, arith=aril,
                            poseidon=posl, storage=storl, climb_key=ckl,
                            padding_pg=ppl, keccak=kcl, sha=scl,
                            mem_align=mal, arith_ec=ecl)


def fill_fixed(air, layout: ZkevmLayout) -> np.ndarray:
    """Input-independent constant polynomials for the circuit."""
    const_np = np.zeros((air.n, air.const_width), dtype=np.uint64)
    main_sm_air.fill_fixed(layout.main, const_np)
    binary_sm.fill_fixed(layout.binary, const_np)
    memory_sm.fill_fixed(layout.memory, const_np)
    arith_sm.fill_fixed(layout.arith, const_np)
    poseidon_g_sm.fill_fixed(layout.poseidon, const_np)
    if layout.storage is not None:
        storage_sm.fill_fixed(layout.storage, const_np)
        climb_key_sm.fill_fixed(layout.climb_key, const_np)
    if layout.padding_pg is not None:
        padding_pg_sm.fill_fixed(layout.padding_pg, const_np)
    if layout.keccak is not None:
        keccak_chain_sm.fill_fixed(layout.keccak, const_np)
    if layout.sha is not None:
        sha_chain_sm.fill_fixed(layout.sha, const_np)
    if layout.mem_align is not None:
        mem_align_sm.fill_fixed(layout.mem_align, const_np)
    arith_ec_sm.fill_fixed(layout.arith_ec, const_np)
    return const_np


def gen_trace(air, layout: ZkevmLayout, records, final_regs, required,
              const_np=None):
    """Fill const + cm1 for the full circuit from an execution.

    records/final_regs: the Main SM trace (main_sm.py Context.trace);
    required: the secondary-SM action vectors (Required); const_np: the
    constant columns when already filled (``fill_fixed``).
    Returns (const_np, cm1_np, publics).
    """
    if const_np is None:
        const_np = fill_fixed(air, layout)
    cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)

    bin_actions = [(binary_sm.OPNAMES[op], a, b)
                   for (op, a, b, _res, _carry) in required.binary]
    eq0_actions = [(a, b, c) for (kind, a, b, c, *_rest) in required.arith
                   if kind == 0]
    ec_actions = [act for act in required.arith if act[0] != 0]

    main_sm_air.expand_trace(layout.main, records, final_regs, cm1)
    binary_sm.expand_trace(layout.binary, bin_actions, cm1)
    memory_sm.expand_trace(layout.memory, list(required.memory), cm1)
    arith_sm.expand_trace(layout.arith, eq0_actions, cm1)
    arith_ec_sm.expand_into(layout.arith_ec, ec_actions, cm1)
    if layout.mem_align is not None:
        ma_actions = [mem_align_sm.MemAlignAction(op, m0, m1, off, v)
                      for (op, m0, m1, off, v) in required.mem_align]
        mem_align_sm.expand_into(layout.mem_align, ma_actions, cm1)
    if layout.keccak is not None:
        keccak_chain_sm.expand_into(layout.keccak,
                                    list(required.padding_kk), cm1)
    if layout.sha is not None:
        sha_chain_sm.expand_into(layout.sha, list(required.padding_sha), cm1)
    # PoseidonG absorbs the Main SM's requests, then the Storage SM's
    # hashes (whose climbs fill ClimbKey), then PaddingPG's blocks
    pg_actions = [list(r) for r in required.poseidon]
    if layout.storage is not None:
        spg, sck = storage_sm.expand_into(layout.storage,
                                          list(required.storage), cm1)
        pg_actions += [list(t[0]) for t in spg]
        climb_key_sm.expand_into(layout.climb_key, sck, cm1)
    if layout.padding_pg is not None:
        pg_actions += padding_pg_sm.expand_into(
            layout.padding_pg, list(required.padding_pg), cm1)
    poseidon_g_sm.expand_into(layout.poseidon, pg_actions, cm1)

    publics = main_sm_air.publics_list(layout.main, records, final_regs)
    return const_np, cm1, publics
