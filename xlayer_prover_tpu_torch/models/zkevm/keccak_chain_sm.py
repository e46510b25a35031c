"""Keccak hash chain: PaddingKK bytes -> sponge bit region -> KeccakF gates.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/keccak_chain_sm.py``.

A collapse of the reference's four-SM chain PaddingKK ->
PaddingKKBit -> Bits2Field -> KeccakF (src/sm/padding_kkbit/,
bits2field/, keccak_f/): the KKBit sponge-bit bookkeeping and the
Bits2Field instance packing merge into ONE instance-major bit region that
binds directly into the gate circuit's connection argument.

Geometry: the gate SM proves keccak-f over ``pack_bits`` = 48 packed
lanes per slot; permutation instance ``g*48 + l`` is lane ``l`` of slot
``g``, and PaddingKK block b IS instance b (static 1:1 mapping).  The bit
region has one row per (instance, state bit): row = inst*1600 + i, with

  * sIn/sOut/data bit columns; the sponge rule
    ``sIn = data XOR (connected * prev_sOut)`` reaches the previous
    instance's bit at a static row distance of 1600 (reference
    PaddingKKBit sOut->sIn chaining with the connected flag);
  * byteAcc: recomposes 8 consecutive data bits into the padded stream
    byte, looked up against PaddingKK's (BLOCKID, POSB, freeIn) rows
    (bit i of byte k is state bit 8k+m — rate bytes are bit-linear);
  * accIn/accOut: lane-packing accumulators over 8-instance chunk spans
    (stride-1600 transitions); the span-end cells JOIN the gate wire
    sigma cycles through the shared connection argument — the Bits2Field
    equivalent, done with copy constraints instead of a separate SM;
  * d0..7: digest accumulators over the first 256 output bits with
    fixed per-bit factors laid out so d_j equals the j-th 32-bit limb of
    the big-endian keccak-256 scalar (Main's op packing); PaddingKK's
    lastHash rows look their hash0..7 up against these.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...ops.keccak import _host_keccak_f
from ...stark.air import AirBuilder, Const, FirstRowSelector
from . import gate_sm, keccak_gates, padding_kk_sm

STATE_BITS = 1600
RATE_BITS = 1088
PACK = 48
CHUNK = 8
N_CHUNKS = PACK // CHUNK


@dataclasses.dataclass
class KeccakChainLayout:
    n_bits: int
    n_slots: int
    n_instances: int
    kk: padding_kk_sm.PaddingKKLayout
    gate: gate_sm.GateSmLayout
    fixed: dict        # bit-region fixed (KC_*)
    witness: dict      # bit-region witness (kc_*)


def build(b: AirBuilder, n_bits: int) -> KeccakChainLayout:
    n = 1 << n_bits
    script = keccak_gates.build_script()
    n_slots = (n - 1) // script.n_gates
    assert n_slots >= 1, \
        f"keccak chain needs 2^{n_bits} >= {script.n_gates + 1} rows"
    ni = PACK * n_slots
    assert ni * STATE_BITS <= n, "bit region exceeds the domain"

    fixed = {name: b.fixed(f"KC_{name}")
             for name in ("ACTIVE", "INOTLAST", "IFIRST", "DATAOK",
                          "BYTESTART", "BYTECH", "BYTEEND", "FBYTE",
                          "FPACK", "DIGROW", "INSTID", "BYTEIDX", "INST0",
                          "CH1600", "SPANCH", "SPANSTART")}
    for j in range(8):
        fixed[f"FD{j}"] = b.fixed(f"KC_FD{j}")

    w = {}
    for name in ("sIn", "sOut", "data", "connected", "byteAcc",
                 "accIn", "accOut"):
        w[name] = b.witness(f"kc_{name}")
    for j in range(8):
        w[f"d{j}"] = b.witness(f"kc_d{j}")

    one = Const(1)
    act = fixed["ACTIVE"]
    l1 = FirstRowSelector()

    # gate SM shares its connection argument with accIn/accOut
    gl_ = gate_sm.build(b, script, n_bits, pack_bits=PACK,
                        chunk_bits=CHUNK, prefix="KF",
                        extra_cols=[w["accIn"], w["accOut"]])
    assert gl_.n_slots == n_slots

    kk = padding_kk_sm.build(b, n_bits, n_blocks=ni)

    # ---- bit semantics ----------------------------------------------
    for name in ("sIn", "sOut", "data"):
        b.constrain(w[name] * (one - w[name]))
    b.constrain(w["data"] * (one - fixed["DATAOK"]))
    b.constrain(l1 * w["connected"])
    b.constrain(fixed["INOTLAST"] * (w["connected"].shifted()
                                     - w["connected"]))
    # sponge chaining: instance k+1 reads instance k's sOut 1600 rows up
    d1600 = w["data"].shifted(STATE_BITS)
    b.constrain(fixed["CH1600"]
                * (w["sIn"].shifted(STATE_BITS) - d1600
                   - w["connected"].shifted(STATE_BITS) * w["sOut"]
                   * (one - Const(2) * d1600)))
    b.constrain(fixed["INST0"] * (w["sIn"] - w["data"]))

    # ---- byte recomposition -----------------------------------------
    b.constrain(fixed["BYTESTART"] * (w["byteAcc"] - w["data"]))
    b.constrain(fixed["BYTECH"] * (w["byteAcc"].shifted() - w["byteAcc"]
                                   - w["data"].shifted()
                                   * fixed["FBYTE"].shifted()))

    # ---- lane packing over 8-instance chunk spans -------------------
    for acc, bit in (("accIn", "sIn"), ("accOut", "sOut")):
        b.constrain(fixed["SPANSTART"] * (w[acc] - w[bit]))
        b.constrain(fixed["SPANCH"]
                    * (w[acc].shifted(STATE_BITS) - w[acc]
                       - w[bit].shifted(STATE_BITS)
                       * fixed["FPACK"].shifted(STATE_BITS)))

    # ---- digest accumulators ----------------------------------------
    for j in range(8):
        b.constrain(fixed["IFIRST"] * (w[f"d{j}"]
                                       - w["sOut"] * fixed[f"FD{j}"]))
        b.constrain(fixed["INOTLAST"]
                    * (w[f"d{j}"].shifted() - w[f"d{j}"]
                       - w["sOut"].shifted() * fixed[f"FD{j}"].shifted()))

    # ---- PaddingKK <-> bit region bindings --------------------------
    kw, kf = kk.witness, kk.fixed
    b.plookup([kf["BLOCKID"], kf["POSB"], kw["freeIn"]],
              [fixed["INSTID"], fixed["BYTEIDX"], w["byteAcc"]],
              f_sel=kf["ACTIVE"], t_sel=fixed["BYTEEND"])
    b.plookup([kf["BLOCKID"], kw["connected"]],
              [fixed["INSTID"], w["connected"]],
              f_sel=kf["BFIRST"], t_sel=fixed["IFIRST"])
    b.plookup([kf["BLOCKID"]] + [kw[f"hash{j}"] for j in range(8)],
              [fixed["INSTID"]] + [w[f"d{j}"] for j in range(8)],
              f_sel=kw["lastHash"], t_sel=fixed["DIGROW"])

    # ---- join packing cells into the gate wire cycles ---------------
    outs = script.outputs
    for g in range(n_slots):
        for c in range(N_CHUNKS):
            span_end = g * PACK + CHUNK * c + CHUNK - 1
            for i in range(STATE_BITS):
                row = span_end * STATE_BITS + i
                gl_.join(g, 2 + i, c, row, 0)            # accIn
                gl_.join(g, int(outs[i]), c, row, 1)     # accOut

    return KeccakChainLayout(n_bits=n_bits, n_slots=n_slots,
                             n_instances=ni, kk=kk, gate=gl_,
                             fixed=fixed, witness=w)


def fill_fixed(layout: KeccakChainLayout, const_np: np.ndarray):
    padding_kk_sm.fill_fixed(layout.kk, const_np)
    gate_sm.fill_fixed(layout.gate, const_np)
    fx = layout.fixed
    ni = layout.n_instances
    na = ni * STATE_BITS
    r = np.arange(na)
    i = r % STATE_BITS
    inst = r // STATE_BITS
    const_np[:na, fx["ACTIVE"].index] = 1
    const_np[:na, fx["INOTLAST"].index] = (i < STATE_BITS - 1)
    const_np[:na, fx["IFIRST"].index] = (i == 0)
    const_np[:na, fx["DATAOK"].index] = (i < RATE_BITS)
    const_np[:na, fx["BYTESTART"].index] = (i % 8 == 0) & (i < RATE_BITS)
    const_np[:na, fx["BYTECH"].index] = (i % 8 < 7) & (i < RATE_BITS)
    const_np[:na, fx["BYTEEND"].index] = (i % 8 == 7) & (i < RATE_BITS)
    const_np[:na, fx["FBYTE"].index] = \
        np.where(i < RATE_BITS, np.uint64(1) << (i % 8).astype(np.uint64),
                 0)
    const_np[:na, fx["DIGROW"].index] = (i == 255)
    const_np[:na, fx["INSTID"].index] = inst
    const_np[:na, fx["BYTEIDX"].index] = np.where(i < RATE_BITS, i // 8, 0)
    const_np[:na, fx["INST0"].index] = (inst == 0)
    const_np[:na, fx["CH1600"].index] = (inst < ni - 1)
    const_np[:na, fx["SPANCH"].index] = (inst < ni - 1) & (inst % 8 < 7)
    const_np[:na, fx["SPANSTART"].index] = (inst % 8 == 0)
    const_np[:na, fx["FPACK"].index] = \
        np.uint64(1) << (inst % 8).astype(np.uint64)
    # digest factors: bit i (byte k=i//8, bit m) contributes
    # 2^(8*(31-k)+m) to the big-endian scalar; limb j = (31-k)//4
    byte_k = i // 8
    m = i % 8
    jj = (31 - byte_k) // 4
    factor = np.uint64(1) << (8 * ((31 - byte_k) % 4) + m).astype(np.uint64)
    for j in range(8):
        const_np[:na, fx[f"FD{j}"].index] = \
            np.where((i < 256) & (jj == j), factor, 0)


def replay(instances):
    """The sponge replay of PaddingKK's instance list [(block, connected)]
    -> (s_in, s_out, data) (n, 25) uint64 lanes: each instance's input
    state, output state and absorbed block."""
    ni = len(instances)
    s_in = np.zeros((ni, 25), dtype=np.uint64)
    s_out = np.zeros((ni, 25), dtype=np.uint64)
    data_l = np.zeros((ni, 25), dtype=np.uint64)
    st = [0] * 25
    for b_i, (blk, connected) in enumerate(instances):
        if not connected:
            st = [0] * 25
        lanes = [int.from_bytes(blk[8 * k:8 * k + 8], "little")
                 for k in range(len(blk) // 8)]
        for k, v in enumerate(lanes):
            st[k] ^= v
            data_l[b_i, k] = v
        s_in[b_i] = st
        st = _host_keccak_f(st)
        s_out[b_i] = st
    return s_in, s_out, data_l


def slot_states(inputs: List[padding_kk_sm.PaddingKKInput],
                n_instances: int) -> np.ndarray:
    """The (n_instances, 25) Keccak-f input states that ``expand_into``
    packs into the gate slots for the hashK streams `inputs`: each
    stream's blocks in address order, then one empty stream a block (as
    ``padding_kk_sm.expand_into`` fills the idle rows)."""
    instances = []
    for s in sorted(inputs, key=lambda s: s.addr):
        padded = padding_kk_sm.pad_bytes(s.data)
        instances += [(padded[k:k + padding_kk_sm.BLOCK], k > 0)
                      for k in range(0, len(padded), padding_kk_sm.BLOCK)]
    idle = (padding_kk_sm.pad_bytes(b""), False)
    instances += [idle] * (n_instances - len(instances))
    return replay(instances)[0]


def expand_into(layout: KeccakChainLayout,
                inputs: List[padding_kk_sm.PaddingKKInput],
                cm1_np: np.ndarray):
    """Fill PaddingKK + bit region + gate columns from the hashK
    streams."""
    ni = layout.n_instances
    instances = padding_kk_sm.expand_into(layout.kk, inputs, cm1_np)
    w = layout.witness
    col = {name: c.index for name, c in w.items()}

    # sponge replay -> per-instance in/out states and data bits
    s_in, s_out, data_l = replay(instances)

    # bit region columns (vectorized over rows)
    na = ni * STATE_BITS
    r = np.arange(na)
    i = r % STATE_BITS
    inst = r // STATE_BITS
    lane = i // 64
    z = i % 64

    def bits_of(mat):
        return (mat[inst, lane] >> z.astype(np.uint64)) & np.uint64(1)

    bin_ = bits_of(s_in)
    bout = bits_of(s_out)
    bdat = bits_of(data_l)
    conn = np.array([1 if c else 0 for (_, c) in instances],
                    dtype=np.uint64)[inst]
    cm1_np[:na, col["sIn"]] = bin_
    cm1_np[:na, col["sOut"]] = bout
    cm1_np[:na, col["data"]] = bdat
    cm1_np[:na, col["connected"]] = conn

    # byteAcc: cumulative within each 8-bit group (rate region)
    cur = np.zeros(na, dtype=np.uint64)
    cur[i % 8 == 0] = bdat[i % 8 == 0]
    for m in range(1, 8):
        idx = np.nonzero((i % 8) == m)[0]
        cur[idx] = cur[idx - 1] + (bdat[idx] << np.uint64(m))
    cm1_np[:na, col["byteAcc"]] = np.where(i < RATE_BITS, cur, 0)

    # accIn/accOut: cumulative over instance spans (stride 1600)
    for acc_name, bits in (("accIn", bin_), ("accOut", bout)):
        cur = np.zeros(na, dtype=np.uint64)
        sel0 = (inst % 8) == 0
        cur[sel0] = bits[sel0]
        for m in range(1, 8):
            sel = (inst % 8) == m
            idx = np.nonzero(sel)[0]
            cur[idx] = cur[idx - STATE_BITS] + (bits[idx] << np.uint64(m))
        cm1_np[:na, col[acc_name]] = cur

    # digest accumulators
    byte_k = i // 8
    jj = np.where(i < 256, (31 - byte_k) // 4, 0)
    factor = np.where(
        i < 256,
        np.uint64(1) << (8 * ((31 - byte_k) % 4) + (i % 8)).astype(
            np.uint64), 0)
    contrib = bout * factor
    for j in range(8):
        cj = np.where(jj == j, contrib, 0).reshape(ni, STATE_BITS)
        dj = np.cumsum(cj, axis=1).reshape(na)
        cm1_np[:na, col[f"d{j}"]] = dj

    # gate columns: packed input states per slot
    slot_inputs = [slot_input(s_in, g) for g in range(layout.n_slots)]
    gate_sm.expand_into(layout.gate, slot_inputs, cm1_np)


def slot_input(s_in: np.ndarray, g: int) -> np.ndarray:
    """Gate slot `g`'s input wires: state bit i of instance g*PACK + l in
    bit l of word i.  -> (1600,) uint64"""
    idx = np.arange(STATE_BITS)
    lane_i = idx // 64
    z_i = (idx % 64).astype(np.uint64)
    packed = np.zeros(STATE_BITS, dtype=np.uint64)
    for l in range(PACK):
        bits = (s_in[g * PACK + l][lane_i] >> z_i) & np.uint64(1)
        packed |= bits << np.uint64(l)
    return packed
