"""ROM free-input function registry (reference: eval_command.cpp:20-92).

The port's own copy of ``xlayer_prover_tpu/executor/rom_functions.py``
(the BN254 base-field prime is a constant here).

Implements the fork_9 ROM's functionCall surface host-side: transaction
data access, secp256k1 point arithmetic (the ECRecover support ops), BN254
Fp/Fp2 helpers for the modexp/pairing precompiles, memAlign write helpers,
L1-info/batch metadata reads (from input vars), and FullTracer event stubs.
``register_all(executor)`` wires everything into MainExecutor.functions.

Conventions: functions receive (ctx, *evaluated_params) and return either a
256-bit int (split into 32-bit limbs) or an 8-element field list (for
values like -1 that exceed 32-bit limbs, e.g. cond/beforeLast).
"""

from __future__ import annotations

from ..fields import gl
from .main_sm import Context, fea_to_scalar

P = gl.P
# the BN254 base field (fields/bn254.py of the JAX package)
BN254_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
NEG1 = [P - 1, 0, 0, 0, 0, 0, 0, 0]
ZERO8 = [0] * 8

# secp256k1
SECP_P = 2 ** 256 - 2 ** 32 - 977
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def _batch_data(ctx: Context) -> bytes:
    h = ctx.input_vars.get("batchL2Data", "")
    if isinstance(h, bytes):
        return h
    return bytes.fromhex(h.removeprefix("0x")) if h else b""


def _ba2fea(data: bytes) -> list:
    """bytes (big-endian) -> 8x32-bit limbs of the left-padded scalar."""
    v = int.from_bytes(data, "big")
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


# ---------------------------------------------------------------------------
# batch metadata / tx data
# ---------------------------------------------------------------------------

def get_txs(ctx, offset, length):
    data = _batch_data(ctx)
    return _ba2fea(data[int(offset):int(offset) + int(length)])


def get_txs_len(ctx):
    return len(_batch_data(ctx))


def _input_var(name, default=0):
    def fn(ctx, *params):
        v = ctx.input_vars.get(name, default)
        if params and isinstance(v, (list, tuple)):   # indexed variants
            return int(v[int(params[0])])
        return int(v)
    return fn


def cond(ctx, v):
    return NEG1 if int(v) != 0 else ZERO8


def before_last(ctx):
    # 0 once the execution is at the last two steps, else -1 (field)
    n = ctx.rom and getattr(ctx, "max_steps", None)
    limit = (n if n is not None else (1 << 23)) - 2
    return ZERO8 if ctx.step >= limit else NEG1


def _eval_simple(ctx, tree):
    """Tiny evaluator for eventLog param trees (getReg/getVar/number)."""
    op = tree.get("op")
    if op == "getReg":
        r = getattr(ctx.regs, tree["regName"])
        if isinstance(r, list):
            try:
                return fea_to_scalar(r)
            except Exception:
                return 0
        return int(r)
    if op == "getVar":
        return ctx.vars.get(tree["varName"], 0)
    if op == "number":
        return int(tree["num"])
    return 0


def event_log(ctx, *params):
    """FullTracer event hook (eval_command.cpp eval_eventLog): the first
    param names the event (getVar onX, or a functionCall onX(args))."""
    ctx.vars.setdefault("_events", 0)
    ctx.vars["_events"] += 1
    tracer = getattr(ctx, "full_tracer", None)
    if tracer is None or not params:
        return 0
    p0 = params[0]
    if p0.get("op") == "functionCall":
        name = p0.get("funcName", "")
        values = [_eval_simple(ctx, a) for a in p0.get("params", [])]
        tracer.handle_event(ctx, name, values)
    else:
        name = p0.get("varName", "")
        if name == "onError":
            err = params[1].get("varName", "") if len(params) > 1 else ""
            tracer.on_error(ctx, [], name=err)
        else:
            values = [_eval_simple(ctx, a) for a in params[1:]]
            tracer.handle_event(ctx, name, values)
    return 0


def store_log(ctx, *params):
    """LOG0..4 data collection (eval_storeLog): params are
    (logIndex, isTopic, data) value trees."""
    tracer = getattr(ctx, "full_tracer", None)
    if tracer is None:
        return 0
    vals = [_eval_simple(ctx, p) if isinstance(p, dict) else int(p)
            for p in params]
    while len(vals) < 3:
        vals.append(0)
    tracer.on_store_log(ctx, vals[0], vals[1], vals[2])
    return 0


def get_smt_proof(ctx, index, level):
    proofs = ctx.input_vars.get("smtProofs")
    if proofs is None:
        raise KeyError("getSmtProof: no smtProofs in input")
    return int(proofs[int(index)][int(level)])


# ---------------------------------------------------------------------------
# secp256k1 point arithmetic (ECRecover support; reference eval_command
# AddPointEc/DblPointEc read the points from registers A,B and C,D)
# ---------------------------------------------------------------------------

def _regs_point1(ctx):
    return fea_to_scalar(ctx.regs.A), fea_to_scalar(ctx.regs.B)


def _regs_point2(ctx):
    return fea_to_scalar(ctx.regs.C), fea_to_scalar(ctx.regs.D)


def _ec_add(x1, y1, x2, y2):
    if x1 == x2 and (y1 + y2) % SECP_P == 0:
        raise ZeroDivisionError("point at infinity")
    s = ((y2 - y1) * pow(x2 - x1, -1, SECP_P)) % SECP_P
    x3 = (s * s - x1 - x2) % SECP_P
    y3 = (s * (x1 - x3) - y1) % SECP_P
    return x3, y3

def _ec_dbl(x1, y1):
    s = (3 * x1 * x1 * pow(2 * y1, -1, SECP_P)) % SECP_P
    x3 = (s * s - 2 * x1) % SECP_P
    y3 = (s * (x1 - x3) - y1) % SECP_P
    return x3, y3


def _ec_memo_add(ctx, x1, y1, x2, y2):
    """ECRecoverPrecalc memo probe (executor/ec_precalc.py; reference
    eval_command.cpp:2296-2347 serves these from the positional
    precalc buffer). Returns (x3, y3); a miss computes directly."""
    m = getattr(ctx, "ec_memo", None)
    if m is not None:
        hit = m.get(("add", x1, y1, x2, y2))
        if hit is not None:
            ctx.ec_memo_hits += 1
            return hit
    return _ec_add(x1, y1, x2, y2)


def _ec_memo_dbl(ctx, x1, y1):
    m = getattr(ctx, "ec_memo", None)
    if m is not None:
        hit = m.get(("dbl", x1, y1))
        if hit is not None:
            ctx.ec_memo_hits += 1
            return hit
    return _ec_dbl(x1, y1)


def x_add_point_ec(ctx, *params):
    if len(params) == 4:
        x1, y1, x2, y2 = (int(v) for v in params)
    else:
        (x1, y1), (x2, y2) = _regs_point1(ctx), _regs_point2(ctx)
    return _ec_memo_add(ctx, x1, y1, x2, y2)[0]


def y_add_point_ec(ctx, *params):
    if len(params) == 4:
        x1, y1, x2, y2 = (int(v) for v in params)
    else:
        (x1, y1), (x2, y2) = _regs_point1(ctx), _regs_point2(ctx)
    return _ec_memo_add(ctx, x1, y1, x2, y2)[1]


def x_dbl_point_ec(ctx, *params):
    if len(params) == 2:
        x1, y1 = (int(v) for v in params)
    else:
        x1, y1 = _regs_point1(ctx)
    return _ec_memo_dbl(ctx, x1, y1)[0]


def y_dbl_point_ec(ctx, *params):
    if len(params) == 2:
        x1, y1 = (int(v) for v in params)
    else:
        x1, y1 = _regs_point1(ctx)
    return _ec_memo_dbl(ctx, x1, y1)[1]


def inverse_fp_ec(ctx, a=None):
    a = (int(a) if a is not None else fea_to_scalar(ctx.regs.A)) % SECP_P
    if a == 0:
        raise ZeroDivisionError("inverseFpEc(0)")
    return pow(a, -1, SECP_P) if a % SECP_P else 0


def inverse_fn_ec(ctx, a=None):
    a = (int(a) if a is not None else fea_to_scalar(ctx.regs.A)) % SECP_N
    if a == 0:
        raise ZeroDivisionError("inverseFnEc(0)")
    return pow(a, SECP_N - 2, SECP_N)


def sqrt_fp_ec_parity(ctx, a=None, parity=None):
    """sqrt with the requested parity; the 'no root' sentinel follows the
    reference (0xff..ff marker)."""
    a = (int(a) if a is not None else fea_to_scalar(ctx.regs.C)) % SECP_P
    parity = (int(parity) if parity is not None
              else fea_to_scalar(ctx.regs.D)) & 1
    r = pow(a, (SECP_P + 1) // 4, SECP_P)
    if (r * r) % SECP_P != a:
        return (1 << 256) - 1  # ECRecover no-sqrt marker
    if r & 1 != parity:
        r = SECP_P - r
    return r


# ---------------------------------------------------------------------------
# BN254 Fp / Fp2 helpers
# ---------------------------------------------------------------------------

def fp_bn254_inv(ctx, a=None):
    a = (int(a) if a is not None else fea_to_scalar(ctx.regs.A)) % BN254_P
    if a == 0:
        raise ZeroDivisionError("fpBN254inv(0)")
    return pow(a, -1, BN254_P) if a % BN254_P else 0


def _fp2_from_regs(ctx):
    return (fea_to_scalar(ctx.regs.A) % BN254_P,
            fea_to_scalar(ctx.regs.B) % BN254_P,
            fea_to_scalar(ctx.regs.C) % BN254_P,
            fea_to_scalar(ctx.regs.D) % BN254_P)


def arith_bn254_addfp2(ctx):
    # (A + i B) + (C + i D): ROM reads x part here, y via E register ops;
    # the generated constraints check both — return the x component
    x1, y1, x2, y2 = _fp2_from_regs(ctx)
    return (x1 + x2) % BN254_P


def arith_bn254_subfp2(ctx):
    x1, y1, x2, y2 = _fp2_from_regs(ctx)
    return (x1 - x2) % BN254_P


def arith_bn254_mulfp2_x(ctx):
    x1, y1, x2, y2 = _fp2_from_regs(ctx)
    return (x1 * x2 - y1 * y2) % BN254_P


def arith_bn254_mulfp2_y(ctx):
    x1, y1, x2, y2 = _fp2_from_regs(ctx)
    return (x1 * y2 + y1 * x2) % BN254_P


def fp2_inv_bn254_x(ctx):
    x, y = fea_to_scalar(ctx.regs.A) % BN254_P, fea_to_scalar(ctx.regs.B) % BN254_P
    den = pow(x * x + y * y, -1, BN254_P)
    return (x * den) % BN254_P


def fp2_inv_bn254_y(ctx):
    x, y = fea_to_scalar(ctx.regs.A) % BN254_P, fea_to_scalar(ctx.regs.B) % BN254_P
    den = pow(x * x + y * y, -1, BN254_P)
    return (-y * den) % BN254_P


# ---------------------------------------------------------------------------
# memAlign write helpers (reference eval_memAlignWR_*)
# ---------------------------------------------------------------------------

M256 = (1 << 256) - 1


def mem_align_wr_w0(ctx, m0, value, offset):
    """New aligned word 0 after writing 256-bit value at byte offset."""
    offset = int(offset)
    pair = (int(m0) << 256)
    shift = 8 * (32 - offset)
    mask = M256 << shift
    pair = (pair & ~mask) | ((int(value) & M256) << shift)
    return (pair >> 256) & M256


def mem_align_wr_w1(ctx, m1, value, offset):
    offset = int(offset)
    pair = int(m1)
    shift = 8 * (32 - offset)
    mask = M256 << shift
    pair = (pair & ~(mask & M256)) | (((int(value) & M256) << shift) & M256)
    return pair & M256


def mem_align_wr8_w0(ctx, m0, value, offset):
    offset = int(offset)
    byte_shift = 8 * (31 - offset)
    return (int(m0) & ~(0xFF << byte_shift)) | ((int(value) & 0xFF) << byte_shift)


# ---------------------------------------------------------------------------
# MPdiv protocol (reference _MPdiv/_MPdiv_short + receive* streaming,
# eval_command.cpp:2916-3180): multiprecision division over base-2^256
# chunk arrays held in Main SM memory; quotient/remainder chunks are
# stashed on the context and streamed back through receive* calls.
# ---------------------------------------------------------------------------

B256 = 1 << 256


def _read_chunks(ctx, addr, length):
    out = []
    for i in range(int(length)):
        fea = ctx.mem.get(int(addr) + i)
        if fea is None:
            raise KeyError(f"MPdiv: memory at {int(addr) + i} empty")
        out.append(fea_to_scalar(fea))
    return out


def _to_digits(v: int):
    if v == 0:
        return [0]
    out = []
    while v:
        out.append(v % B256)
        v //= B256
    return out


def mp_div(ctx, addr1, len1, addr2, len2):
    a = _read_chunks(ctx, addr1, len1)
    b = _read_chunks(ctx, addr2, len2)
    av = sum(c << (256 * i) for i, c in enumerate(a))
    bv = sum(c << (256 * i) for i, c in enumerate(b))
    if bv == 0:
        raise ZeroDivisionError("MPdiv by zero")
    q, r = divmod(av, bv)
    ctx.vars["_mp_quotient"] = _to_digits(q)
    ctx.vars["_mp_remainder"] = _to_digits(r)
    return 0


def mp_div_short(ctx, addr1, len1, divisor):
    a = _read_chunks(ctx, addr1, len1)
    av = sum(c << (256 * i) for i, c in enumerate(a))
    bv = int(divisor)
    if bv == 0:
        raise ZeroDivisionError("MPdiv_short by zero")
    q, r = divmod(av, bv)
    # the reference keeps the quotient at the dividend's length
    digits = _to_digits(q)
    digits += [0] * (int(len1) - len(digits))
    ctx.vars["_mp_quotient"] = digits
    ctx.vars["_mp_remainder"] = [r]
    return r


def receive_len_quotient(ctx):
    return len(ctx.vars.get("_mp_quotient", []))


def receive_len_remainder(ctx):
    return len(ctx.vars.get("_mp_remainder", []))


def receive_quotient_chunk(ctx, i):
    return int(ctx.vars["_mp_quotient"][int(i)])


def receive_remainder_chunk(ctx, i):
    return int(ctx.vars["_mp_remainder"][int(i)])


def load_scalar(ctx, v):
    """eval_loadScalar: passthrough of the evaluated param
    (eval_command.cpp:1747-1760)."""
    return int(v)


def fn_exp(ctx, a, b):
    """eval_exp: unbounded a**b over mpz (eval_command.cpp:1355+)."""
    return int(a) ** int(b)


def sqrt_fp_ec(ctx, a):
    """eval_sqrtFpEc: sqrt mod the secp256k1 prime via p = 3 mod 4
    (eval_command.cpp:2196-2224; sqrtF3mod4)."""
    r = pow(int(a) % SECP_P, (SECP_P + 1) // 4, SECP_P)
    if r * r % SECP_P != int(a) % SECP_P:
        return 0
    return r


def get_global_exit_root(ctx, *_):
    """eval_getGlobalExitRoot (eval_command.cpp:1151-1164)."""
    return int(ctx.input_vars.get("globalExitRoot", 0))


def get_timestamp(ctx, *_):
    return int(ctx.input_vars.get("timestamp",
                                  ctx.input_vars.get("timestampLimit", 0)))


def receive_len(ctx, *vals):
    """eval_receiveLen: records the expected data length for the long
    division helpers (companion of receiveLenQuotient/Remainder)."""
    ctx.vars["_mp_len"] = int(vals[0]) if vals else 0
    return 0


def add_read_write_address(ctx, *vals):
    """eval_addReadWriteAddress: tracer bookkeeping of touched state
    addresses (full_tracer feed); recorded for the response builder."""
    ctx.vars.setdefault("_rw_addresses", [])
    ctx.vars["_rw_addresses"].append([int(v) for v in vals])
    return 0


def fn_log(ctx, *vals):
    return 0


def on_opcode(ctx, *params):
    """eval_onOpcode: FullTracer per-opcode hook."""
    tracer = getattr(ctx, "full_tracer", None)
    if tracer is not None:
        tracer.on_opcode(ctx, params)
    return 0


def bitwise_and(ctx, a, b):
    return int(a) & int(b)


def bitwise_or(ctx, a, b):
    return int(a) | int(b)


def bitwise_xor(ctx, a, b):
    return int(a) ^ int(b)


def bitwise_not(ctx, a):
    return int(a) ^ ((1 << 256) - 1)


def comp_lt(ctx, a, b):
    return int(int(a) < int(b))


def comp_gt(ctx, a, b):
    return int(int(a) > int(b))


def comp_eq(ctx, a, b):
    return int(int(a) == int(b))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

FUNCTIONS = {
    "getTxs": get_txs,
    "getTxsLen": get_txs_len,
    "cond": cond,
    "beforeLast": before_last,
    "eventLog": event_log,
    "storeLog": store_log,
    "getSmtProof": get_smt_proof,
    "getSequencerAddr": _input_var("sequencerAddr"),
    "getTimestampLimit": _input_var("timestampLimit"),
    "getL1InfoRoot": _input_var("l1InfoRoot"),
    "getForcedBlockHashL1": _input_var("forcedBlockHashL1"),
    "getL1InfoGER": _input_var("l1InfoGER"),
    "getL1InfoBlockHash": _input_var("l1InfoBlockHash"),
    "getL1InfoTimestamp": _input_var("l1InfoTimestamp"),
    "xAddPointEc": x_add_point_ec,
    "yAddPointEc": y_add_point_ec,
    "xDblPointEc": x_dbl_point_ec,
    "yDblPointEc": y_dbl_point_ec,
    "inverseFpEc": inverse_fp_ec,
    "inverseFnEc": inverse_fn_ec,
    "sqrtFpEcParity": sqrt_fp_ec_parity,
    "fpBN254inv": fp_bn254_inv,
    "ARITH_BN254_ADDFP2": arith_bn254_addfp2,
    "ARITH_BN254_SUBFP2": arith_bn254_subfp2,
    "ARITH_BN254_MULFP2_X": arith_bn254_mulfp2_x,
    "ARITH_BN254_MULFP2_Y": arith_bn254_mulfp2_y,
    "fp2InvBN254_x": fp2_inv_bn254_x,
    "fp2InvBN254_y": fp2_inv_bn254_y,
    "memAlignWR_W0": mem_align_wr_w0,
    "memAlignWR_W1": mem_align_wr_w1,
    "memAlignWR8_W0": mem_align_wr8_w0,
    "MPdiv": mp_div,
    "MPdiv_short": mp_div_short,
    "receiveLenQuotient": receive_len_quotient,
    "receiveLenQuotient_short": receive_len_quotient,
    "receiveLenRemainder": receive_len_remainder,
    "receiveQuotientChunk": receive_quotient_chunk,
    "receiveQuotientChunk_short": receive_quotient_chunk,
    "receiveRemainderChunk": receive_remainder_chunk,
    "receiveRemainderChunk_short": receive_remainder_chunk,
    "loadScalar": load_scalar,
    "exp": fn_exp,
    "sqrtFpEc": sqrt_fp_ec,
    "getGlobalExitRoot": get_global_exit_root,
    "getTimestamp": get_timestamp,
    "receiveLen": receive_len,
    "addReadWriteAddress": add_read_write_address,
    "log": fn_log,
    "onOpcode": on_opcode,
    "bitwise_and": bitwise_and,
    "bitwise_or": bitwise_or,
    "bitwise_xor": bitwise_xor,
    "bitwise_not": bitwise_not,
    "comp_lt": comp_lt,
    "comp_gt": comp_gt,
    "comp_eq": comp_eq,
}


def register_all(executor):
    executor.functions.update(FUNCTIONS)
    return executor
