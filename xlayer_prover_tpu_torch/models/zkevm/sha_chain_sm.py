"""SHA-256 hash chain: PaddingSha256 bytes -> bit region -> Sha256F gates.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/sha_chain_sm.py``.

Sibling of keccak_chain_sm for the hashS chain (reference PaddingSha256 ->
PaddingSha256Bit -> Bits2FieldSha256 -> Sha256F, src/sm/padding_sha256*/,
sha256_f/).  SHA-256 is Merkle-Damgard, so the bit region differs from
the keccak sponge:

  * instance = one compression: 1024 rows — 768 input-bit rows (256
    chaining-state bits + 512 message-block bits, MSB-first per 32-bit
    word as the gate script expects) then 256 output-bit rows (the
    feed-forward digest words);
  * chaining rule ``state = connected ? prev_out : IV`` reaches the
    previous instance's output bit at a static 256-row stride (output
    row r of instance k is exactly 256 rows before state row of k+1);
  * ONE packing accumulator column serves both directions (input rows
    join gate input wire cycles, output rows join output wire cycles —
    they never share a row);
  * d0..7 accumulate the output bits into Main's op limb packing
    (op_j = big-endian digest word 7-j).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...stark.air import AirBuilder, Const, FirstRowSelector
from . import gate_sm, padding_sha_sm, sha256_gates

IN_BITS = 768
OUT_BITS = 256
INST_ROWS = IN_BITS + OUT_BITS     # 1024
PACK = 48
CHUNK = 8
N_CHUNKS = PACK // CHUNK


@dataclasses.dataclass
class ShaChainLayout:
    n_bits: int
    n_slots: int
    n_instances: int
    ps: padding_sha_sm.PaddingShaLayout
    gate: gate_sm.GateSmLayout
    fixed: dict
    witness: dict


def build(b: AirBuilder, n_bits: int) -> ShaChainLayout:
    n = 1 << n_bits
    script = sha256_gates.build_script()
    n_slots = (n - 1) // script.n_gates
    assert n_slots >= 1, \
        f"sha chain needs 2^{n_bits} >= {script.n_gates + 1} rows"
    ni = PACK * n_slots
    assert ni * INST_ROWS <= n, "bit region exceeds the domain"

    fixed = {name: b.fixed(f"SC_{name}")
             for name in ("ACTIVE", "INOTLAST", "IFIRST", "BYTESTART",
                          "BYTECH", "BYTEEND", "FBYTE", "IVBIT", "CHOUT",
                          "INST0STATE", "DIGROW", "INSTID", "BYTEIDX",
                          "FPACK", "SPANCH", "SPANSTART")}
    for j in range(8):
        fixed[f"FD{j}"] = b.fixed(f"SC_FD{j}")

    w = {"bit": b.witness("sc_bit"),
         "connected": b.witness("sc_connected"),
         "byteAcc": b.witness("sc_byteAcc"),
         "acc": b.witness("sc_acc")}
    for j in range(8):
        w[f"d{j}"] = b.witness(f"sc_d{j}")

    one = Const(1)
    l1 = FirstRowSelector()

    gl_ = gate_sm.build(b, script, n_bits, pack_bits=PACK,
                        chunk_bits=CHUNK, prefix="SF",
                        extra_cols=[w["acc"]])
    assert gl_.n_slots == n_slots

    ps = padding_sha_sm.build(b, n_bits, n_blocks=ni)

    # ---- bit semantics ----------------------------------------------
    b.constrain(w["bit"] * (one - w["bit"]))
    b.constrain(l1 * w["connected"])
    b.constrain(fixed["INOTLAST"] * (w["connected"].shifted()
                                     - w["connected"]))
    c256 = w["connected"].shifted(OUT_BITS)
    b.constrain(fixed["CHOUT"]
                * (w["bit"].shifted(OUT_BITS) - c256 * w["bit"]
                   - (one - c256) * fixed["IVBIT"].shifted(OUT_BITS)))
    b.constrain(fixed["INST0STATE"] * (w["bit"] - fixed["IVBIT"]))

    # ---- byte recomposition (MSB-first within each byte) ------------
    b.constrain(fixed["BYTESTART"] * (w["byteAcc"]
                                      - w["bit"] * fixed["FBYTE"]))
    b.constrain(fixed["BYTECH"] * (w["byteAcc"].shifted() - w["byteAcc"]
                                   - w["bit"].shifted()
                                   * fixed["FBYTE"].shifted()))

    # ---- lane packing over 8-instance chunk spans -------------------
    b.constrain(fixed["SPANSTART"] * (w["acc"] - w["bit"]))
    b.constrain(fixed["SPANCH"]
                * (w["acc"].shifted(INST_ROWS) - w["acc"]
                   - w["bit"].shifted(INST_ROWS)
                   * fixed["FPACK"].shifted(INST_ROWS)))

    # ---- digest accumulators ----------------------------------------
    for j in range(8):
        b.constrain(fixed["IFIRST"] * w[f"d{j}"])
        b.constrain(fixed["INOTLAST"]
                    * (w[f"d{j}"].shifted() - w[f"d{j}"]
                       - w["bit"].shifted() * fixed[f"FD{j}"].shifted()))

    # ---- PaddingSha256 <-> bit region bindings ----------------------
    pw, pf = ps.witness, ps.fixed
    b.plookup([pf["BLOCKID"], pf["POSB"], pw["freeIn"]],
              [fixed["INSTID"], fixed["BYTEIDX"], w["byteAcc"]],
              f_sel=pf["ACTIVE"], t_sel=fixed["BYTEEND"])
    b.plookup([pf["BLOCKID"], pw["connected"]],
              [fixed["INSTID"], w["connected"]],
              f_sel=pf["BFIRST"], t_sel=fixed["IFIRST"])
    b.plookup([pf["BLOCKID"]] + [pw[f"hash{j}"] for j in range(8)],
              [fixed["INSTID"]] + [w[f"d{j}"] for j in range(8)],
              f_sel=pw["lastHash"], t_sel=fixed["DIGROW"])

    # ---- join packing cells into the gate wire cycles ---------------
    outs = script.outputs
    for g in range(n_slots):
        for c in range(N_CHUNKS):
            span_end = g * PACK + CHUNK * c + CHUNK - 1
            base = span_end * INST_ROWS
            for i in range(IN_BITS):
                gl_.join(g, 2 + i, c, base + i, 0)
            for i in range(OUT_BITS):
                gl_.join(g, int(outs[i]), c, base + IN_BITS + i, 0)

    return ShaChainLayout(n_bits=n_bits, n_slots=n_slots, n_instances=ni,
                          ps=ps, gate=gl_, fixed=fixed, witness=w)


def fill_fixed(layout: ShaChainLayout, const_np: np.ndarray):
    padding_sha_sm.fill_fixed(layout.ps, const_np)
    gate_sm.fill_fixed(layout.gate, const_np)
    fx = layout.fixed
    ni = layout.n_instances
    na = ni * INST_ROWS
    r = np.arange(na)
    off = r % INST_ROWS
    inst = r // INST_ROWS
    data = (off >= 256) & (off < IN_BITS)
    out = off >= IN_BITS
    state = off < 256
    const_np[:na, fx["ACTIVE"].index] = 1
    const_np[:na, fx["INOTLAST"].index] = (off < INST_ROWS - 1)
    const_np[:na, fx["IFIRST"].index] = (off == 0)
    di = off - 256
    const_np[:na, fx["BYTESTART"].index] = data & (di % 8 == 0)
    const_np[:na, fx["BYTECH"].index] = data & (di % 8 < 7)
    const_np[:na, fx["BYTEEND"].index] = data & (di % 8 == 7)
    const_np[:na, fx["FBYTE"].index] = \
        np.where(data, np.uint64(1) << (7 - di % 8).astype(np.uint64), 0)
    # IV bits, MSB-first per word
    word = off // 32
    z = off % 32
    iv = np.array(sha256_gates.IV, dtype=np.uint64)
    const_np[:na, fx["IVBIT"].index] = \
        np.where(state, (iv[np.minimum(word, 7)]
                         >> (31 - z).astype(np.uint64)) & np.uint64(1), 0)
    const_np[:na, fx["CHOUT"].index] = out & (inst < ni - 1)
    const_np[:na, fx["INST0STATE"].index] = state & (inst == 0)
    const_np[:na, fx["DIGROW"].index] = (off == INST_ROWS - 1)
    const_np[:na, fx["INSTID"].index] = inst
    const_np[:na, fx["BYTEIDX"].index] = np.where(data, di // 8, 0)
    const_np[:na, fx["FPACK"].index] = \
        np.uint64(1) << (inst % 8).astype(np.uint64)
    const_np[:na, fx["SPANCH"].index] = (inst < ni - 1) & (inst % 8 < 7)
    const_np[:na, fx["SPANSTART"].index] = (inst % 8 == 0)
    # digest limb factors on output rows: word k = (off-768)//32 maps to
    # op limb 7-k with weight 2^(31 - bit)
    ow = (off - IN_BITS) // 32
    oz = (off - IN_BITS) % 32
    for j in range(8):
        const_np[:na, fx[f"FD{j}"].index] = \
            np.where(out & (7 - ow == j),
                     np.uint64(1) << (31 - oz).astype(np.uint64), 0)


def expand_into(layout: ShaChainLayout,
                inputs: List[padding_sha_sm.PaddingShaInput],
                cm1_np: np.ndarray):
    ni = layout.n_instances
    instances = padding_sha_sm.expand_into(layout.ps, inputs, cm1_np)
    w = layout.witness
    col = {name: c.index for name, c in w.items()}

    # compression replay: per-instance (state_in8, block16, state_out8)
    st_in = np.zeros((ni, 8), dtype=np.uint64)
    blk_w = np.zeros((ni, 16), dtype=np.uint64)
    st_out = np.zeros((ni, 8), dtype=np.uint64)
    iv = list(sha256_gates.IV)
    st = list(iv)
    for b_i, (blk, connected) in enumerate(instances):
        if not connected:
            st = list(iv)
        words = [int.from_bytes(blk[4 * k:4 * k + 4], "big")
                 for k in range(16)]
        st_in[b_i] = st
        blk_w[b_i] = words
        st = _compress_host(st, words)
        st_out[b_i] = st

    na = ni * INST_ROWS
    r = np.arange(na)
    off = r % INST_ROWS
    inst = r // INST_ROWS

    # bit column: state (MSB-first), data words, output words
    z31 = (31 - off % 32).astype(np.uint64)
    bits = np.zeros(na, dtype=np.uint64)
    sel = off < 256
    bits[sel] = (st_in[inst[sel], off[sel] // 32] >> z31[sel]) & 1
    sel = (off >= 256) & (off < IN_BITS)
    bits[sel] = (blk_w[inst[sel], (off[sel] - 256) // 32]
                 >> (31 - (off[sel] - 256) % 32).astype(np.uint64)) & 1
    sel = off >= IN_BITS
    bits[sel] = (st_out[inst[sel], (off[sel] - IN_BITS) // 32]
                 >> (31 - (off[sel] - IN_BITS) % 32).astype(np.uint64)) & 1
    cm1_np[:na, col["bit"]] = bits
    conn = np.array([1 if c else 0 for (_, c) in instances],
                    dtype=np.uint64)[inst]
    cm1_np[:na, col["connected"]] = conn

    # byteAcc (MSB-first within data bytes)
    di = off - 256
    data_sel = (off >= 256) & (off < IN_BITS)
    cur = np.zeros(na, dtype=np.uint64)
    idx0 = np.nonzero(data_sel & (di % 8 == 0))[0]
    cur[idx0] = bits[idx0] << np.uint64(7)
    for m in range(1, 8):
        idx = np.nonzero(data_sel & (di % 8 == m))[0]
        cur[idx] = cur[idx - 1] + (bits[idx] << np.uint64(7 - m))
    cm1_np[:na, col["byteAcc"]] = np.where(data_sel, cur, 0)

    # packing accumulator over 8-instance spans
    cur = np.zeros(na, dtype=np.uint64)
    sel0 = (inst % 8) == 0
    cur[sel0] = bits[sel0]
    for m in range(1, 8):
        idx = np.nonzero((inst % 8) == m)[0]
        cur[idx] = cur[idx - INST_ROWS] + (bits[idx] << np.uint64(m))
    cm1_np[:na, col["acc"]] = cur

    # digest accumulators
    out_sel = off >= IN_BITS
    ow = np.where(out_sel, (off - IN_BITS) // 32, 0)
    factor = np.where(out_sel,
                      np.uint64(1) << (31 - (off - IN_BITS) % 32)
                      .astype(np.uint64), 0)
    contrib = bits * factor
    for j in range(8):
        cj = np.where(out_sel & (7 - ow == j), contrib, 0) \
            .reshape(ni, INST_ROWS)
        dj = np.cumsum(cj, axis=1).reshape(na)
        cm1_np[:na, col[f"d{j}"]] = dj

    # gate columns
    slot_inputs = []
    idx = np.arange(IN_BITS)
    for g in range(layout.n_slots):
        packed = np.zeros(IN_BITS, dtype=np.uint64)
        for l in range(PACK):
            b_i = g * PACK + l
            sbits = np.where(
                idx < 256,
                (st_in[b_i][np.minimum(idx // 32, 7)]
                 >> (31 - idx % 32).astype(np.uint64)) & 1,
                (blk_w[b_i][np.maximum(idx - 256, 0) // 32]
                 >> (31 - (idx - 256) % 32).astype(np.uint64)) & 1)
            packed |= sbits << np.uint64(l)
        slot_inputs.append(packed)
    gate_sm.expand_into(layout.gate, slot_inputs, cm1_np)


def _compress_host(state, words):
    """One SHA-256 compression (host reference)."""
    K = sha256_gates.K
    M32 = 0xFFFFFFFF

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M32

    w = list(words)
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = [int(x) for x in state]
    for t in range(64):
        S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g & M32)
        t1 = (h + S1 + ch + K[t] + w[t]) & M32
        S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, \
            (t1 + t2) & M32
    return [(int(s) + v) & M32
            for s, v in zip(state, [a, b, c, d, e, f, g, h])]
