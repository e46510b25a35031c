"""Main state machine interpreter (zkASM ROM executor).

The port's own copy of ``xlayer_prover_tpu/executor/main_sm.py``.
Keccak-256 digests come from the port's pure-Python ``utils/keccak.py``,
storage keys and hashP digests from its host Poseidon
(``ops/poseidon_gl.host_permute``).

Host-side equivalent of the reference fork_9 MainExecutor
(src/main_sm/fork_9/main/main_executor.cpp): per step, read the RomLine at
zkPC, build the op accumulator from input selectors + CONST/CONSTL + free
input, execute the line's operations, apply setters and jumps.

Faithful machine model: the 256-bit registers (A..E, SR) and the op
accumulator are 8 Goldilocks field elements (limbs), exactly as the
reference commits them to the Main pols — a "negative" constant is p-c in
limb 0, JMPN tests op0 against the 32-bit negative window
(main_executor.cpp:5072-5125), and fea->scalar conversions require limbs
< 2^32 like fea2scalar (src/utils/scalar.hpp:74+).  Address spaces use the
STACK/MEM/CTX offsets of main_executor.cpp:46-48.

The machine core + command trees compiled to closures
(``compile_command``); the ~60 ROM function calls register through
``MainExecutor.functions`` and raise if the ROM calls an unimplemented one.
Secondary-SM action vectors accumulate in ``Required``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from ..fields import gl
from ..ops.poseidon_gl import host_permute
from ..state.hashdb import HashDB
from ..utils.keccak import keccak256
from ..utils.zkresult import ZkError, ZkResult
from .rom import Rom, RomLine
from .storage_executor import SmtAction

P = gl.P
MASK256 = (1 << 256) - 1

STACK_OFFSET = 0x10000
MEM_OFFSET = 0x20000
CTX_OFFSET = 0x40000

FR_FIRST_32_NEGATIVE = P - (1 << 32)
FR_LAST_32_POSITIVE = (1 << 32) - 1

ZERO8 = [0] * 8

# functions whose params are passed unevaluated (tracer event hooks)
RAW_PARAM_FUNCTIONS = {"eventLog", "onOpcode", "storeLog"}

def fea_to_scalar(fea8) -> int:
    """8 field limbs -> 256-bit scalar; limbs must be < 2^32 (fea2scalar)."""
    v = 0
    for i in range(8):
        limb = int(fea8[i])
        if limb >= (1 << 32):
            raise ZkError(ZkResult.PROVER_ERROR,
                          f"fea2scalar: limb {i} too large ({limb:#x})")
        v |= limb << (32 * i)
    return v


def scalar_to_fea(v: int) -> List[int]:
    v &= MASK256
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def fe_to_s32(v: int) -> int:
    """Field element -> signed 32-bit (reference fr.toS32)."""
    if v <= 0x7FFFFFFF:
        return v
    if v >= P - 0x80000000:
        return v - P
    raise ZkError(ZkResult.PROVER_ERROR, f"toS32 out of range: {v:#x}")


@dataclasses.dataclass
class Registers:
    A: list = dataclasses.field(default_factory=lambda: [0] * 8)
    B: list = dataclasses.field(default_factory=lambda: [0] * 8)
    C: list = dataclasses.field(default_factory=lambda: [0] * 8)
    D: list = dataclasses.field(default_factory=lambda: [0] * 8)
    E: list = dataclasses.field(default_factory=lambda: [0] * 8)
    SR: list = dataclasses.field(default_factory=lambda: [0] * 8)
    CTX: int = 0
    SP: int = 0
    PC: int = 0
    GAS: int = 0
    RR: int = 0
    HASHPOS: int = 0
    RCX: int = 0
    zkPC: int = 0


@dataclasses.dataclass
class Counters:
    steps: int = 0
    arith: int = 0
    binary: int = 0
    keccak_f: int = 0
    sha256_f: int = 0
    mem_align: int = 0
    padding_pg: int = 0
    poseidon_g: int = 0


def counter_limits_from_rom(rom) -> dict:
    """Per-SM capacity limits (the batch-capacity product contract):
    the *_LIMIT constants of constants.zkasm shipped inside rom.json
    (reference main_executor.cpp:50,65-66)."""
    def c(name, default):
        v = rom.constants.get(name)
        return int(v["value"]) if v else default
    return {
        "steps": c("MAX_CNT_STEPS_LIMIT", 1 << 23),
        "arith": c("MAX_CNT_ARITH_LIMIT", 1 << 18),
        "binary": c("MAX_CNT_BINARY_LIMIT", 1 << 19),
        "mem_align": c("MAX_CNT_MEM_ALIGN_LIMIT", 1 << 18),
        "keccak_f": c("MAX_CNT_KECCAK_F_LIMIT", 2376),
        "padding_pg": c("MAX_CNT_PADDING_PG_LIMIT", 149796),
        "poseidon_g": c("MAX_CNT_POSEIDON_G_LIMIT", 279620),
        "sha256_f": c("MAX_CNT_SHA256_F_LIMIT", 1862),
    }


_OOC_CODES = {
    "steps": ZkResult.OUT_OF_COUNTERS_STEP,
    "arith": ZkResult.OUT_OF_COUNTERS_ARITH,
    "binary": ZkResult.OUT_OF_COUNTERS_BINARY,
    "mem_align": ZkResult.OUT_OF_COUNTERS_MEM,
    "keccak_f": ZkResult.OUT_OF_COUNTERS_KECCAK,
    "padding_pg": ZkResult.OUT_OF_COUNTERS_PADDING,
    "poseidon_g": ZkResult.OUT_OF_COUNTERS_POSEIDON,
    "sha256_f": ZkResult.OUT_OF_COUNTERS_PADDING,
}


@dataclasses.dataclass
class Required:
    """Action vectors for the secondary-SM trace expanders
    (reference MainExecRequired, main_exec_required.hpp:27-48)."""
    arith: list = dataclasses.field(default_factory=list)
    binary: list = dataclasses.field(default_factory=list)
    memory: list = dataclasses.field(default_factory=list)
    mem_align: list = dataclasses.field(default_factory=list)
    storage: list = dataclasses.field(default_factory=list)
    poseidon: list = dataclasses.field(default_factory=list)
    padding_pg: list = dataclasses.field(default_factory=list)
    padding_kk: list = dataclasses.field(default_factory=list)
    padding_sha: list = dataclasses.field(default_factory=list)


def linearize_reads(st: "HashState", zkpc_hint: str = "") -> list:
    """Read partition in position order (reference main_executor.cpp:5570-
    5589): recorded read lengths, singleton fallback for uncovered bytes;
    overlapping reads are an executor error."""
    reads = []
    p = 0
    while p < len(st.data):
        ln = st.reads.get(p, 0)
        if ln:
            reads.append(ln)
            p += ln
        else:
            reads.append(1)
            p += 1
    if p != len(st.data):
        raise ZkError(ZkResult.PROVER_ERROR,
                      f"hash read out of limits {zkpc_hint}")
    return reads


class HashState:
    def __init__(self):
        self.data = bytearray()
        self.len = None
        self.digest = None
        self.first_byte_written = False
        self.digest_called = False
        self.len_called = False
        # pos -> byte length of every access (read or write): the chunk
        # read partition the padding SMs replay (reference
        # main_executor.cpp:2778 ctx.hash*[addr].reads[pos] = size)
        self.reads: Dict[int, int] = {}

    def write(self, pos: int, data: bytes, zkpc: int,
              first_byte_games: bool = False):
        """Position-addressed write with the reference's hashK/hashP byte
        semantics (main_executor.cpp:2978-3043): append at pos==size,
        verify-match below size, error beyond size.  hashP additionally
        (`first_byte_games`) seeds a zero placeholder at position 0 when
        the first write starts at position 1, and allows one single-byte
        overwrite of position 0 — the ROM writes the l2TxHash tx-type byte
        at position 0 last (addL2HashTx_txType rom lines 203-213)."""
        for j, b in enumerate(data):
            p = pos + j
            if first_byte_games and p == 1 and not self.data \
                    and not self.first_byte_written:
                self.data.append(0)
            if first_byte_games and p == 0 and len(data) == 1 and self.data \
                    and not self.first_byte_written:
                self.data[0] = b
                self.first_byte_written = True
            elif p == len(self.data):
                self.data.append(b)
            elif p < len(self.data):
                if self.data[p] != b:
                    raise ZkError(ZkResult.PROVER_ERROR,
                                  f"hash byte mismatch at pos {p}, "
                                  f"zkPC={zkpc}")
            else:
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"hash write beyond size at pos {p}, "
                              f"zkPC={zkpc}")
        self.digest = None


class Context:
    def __init__(self, rom: Rom, hashdb: HashDB, batch_uuid: str = "batch",
                 input_vars: Optional[dict] = None):
        self.rom = rom
        self.hashdb = hashdb
        self.batch_uuid = batch_uuid
        self.regs = Registers()
        self.mem: Dict[int, List[int]] = {}
        self.vars: Dict[str, int] = {}
        self.counters = Counters()
        self.required = Required()
        self.hash_k: Dict[int, HashState] = {}
        self.hash_p: Dict[int, HashState] = {}
        self.hash_s: Dict[int, HashState] = {}
        self.input_vars = input_vars or {}
        self.counter_limits = counter_limits_from_rom(rom)
        self.carry = 0
        self.done = False
        self.step = 0
        self.max_steps = 1 << 23
        # when not None, execute_line appends per-step trace records for
        # the Main SM polynomial commitment (models/zkevm/main_sm_air.py)
        self.trace: Optional[list] = None
        self._hash_bytes = 0
        self.full_tracer = None       # executor/full_tracer.py when tracing
        # ECRecoverPrecalc memo (executor/ec_precalc.py): filled at the
        # ecrecover_store_args label, cleared at ecrecover_end
        self.ec_memo = None
        self.ec_memo_hits = 0
        # the storage key and SMT result of one step, shared by the free
        # input and the op block of the same sRD/sWR line
        self._skey_cache = None
        self._sload_cache = None
        self._sstore_cache = None


def _storage_key(regs):
    """SMT key from registers (main_executor.cpp:1080-1115): capacity =
    Poseidon(C limbs || 0) (Kin0, the slot), key = Poseidon(A0..A5, B0, B1
    || capacity) (Kin1: address and leaf type).  -> (kin0, kin1, key4)."""
    kin0 = [int(v) for v in regs.C] + [0, 0, 0, 0]
    cap = host_permute(kin0)[:4]
    kin1 = [int(v) for v in regs.A[0:6]] + [int(regs.B[0]),
                                            int(regs.B[1])] + cap
    return kin0, kin1, tuple(host_permute(kin1)[:4])


def _bump(ctx: "Context", name: str, amount: int = 1):
    """Increment a counter and enforce its OOC limit
    (reference CHECK_MAX_CNT_ASAP, main_executor.cpp:55-66)."""
    cur = getattr(ctx.counters, name) + amount
    setattr(ctx.counters, name, cur)
    limit = ctx.counter_limits.get(name)
    if limit is not None and cur > limit:
        raise ZkError(_OOC_CODES[name], f"out of counters: {name} > {limit}")


class CommandError(ZkError):
    def __init__(self, msg):
        super().__init__(ZkResult.PROVER_ERROR, msg)


_BINOP_LAMBDAS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a // b if b else 0,
    "mod": lambda a, b: a % b if b else 0,
    "or": lambda a, b: a | b,
    "bitor": lambda a, b: a | b,
    "and": lambda a, b: a & b,
    "bitand": lambda a, b: a & b,
    "xor": lambda a, b: a ^ b,
    "bitxor": lambda a, b: a ^ b,
    "bitnot": lambda a, b: a ^ MASK256,
    "shl": lambda a, b: a << b,
    "shr": lambda a, b: a >> b,
    "lt": lambda a, b: int(a < b),
    "gt": lambda a, b: int(a > b),
    "eq": lambda a, b: int(a == b),
    "ne": lambda a, b: int(a != b),
    "not": lambda a, b: int(not a),
}


class MainExecutor:
    """The machine. `functions` is the freeInTag function-call registry."""

    def __init__(self, rom: Rom, max_steps: int = 1 << 23):
        self.rom = rom
        self.max_steps = max_steps
        self.functions: Dict[str, Callable] = {}
        self._enc_cache: Dict[int, dict] = {}
        self._cmd_cache: Dict[int, Callable] = {}
        # ECRecoverPrecalc hook points (reference main_executor.cpp:341-363);
        # absent in toy/older ROMs -> hooks disabled
        self._ec_store_pc = rom.labels.get("ecrecover_store_args")
        self._ec_end_pc = rom.labels.get("ecrecover_end")

    # ------------------------------------------------------------------
    # command-tree compilation: each ROM command tree compiles once into
    # nested closures (the reference compiles them to C++ via
    # main_generator; this is the Python-tier equivalent — no dict
    # lookups or recursive dispatch on the hot path)
    # ------------------------------------------------------------------
    def compile_command(self, cmd: dict) -> Callable:
        op = cmd.get("op")
        if op == "number":
            v = int(cmd["num"])
            return lambda ctx: v
        if op == "getReg":
            name = cmd["regName"]
            if name in ("A", "B", "C", "D", "E", "SR"):
                def get_vec(ctx, _n=name):
                    return fea_to_scalar(getattr(ctx.regs, _n))
                return get_vec
            return lambda ctx, _n=name: int(getattr(ctx.regs, _n))
        if op == "declareVar":
            name = cmd["varName"]

            def declare(ctx, _n=name):
                ctx.vars[_n] = 0
                return 0
            return declare
        if op == "setVar":
            name = cmd["values"][0].get("varName")
            val_f = self.compile_command(cmd["values"][1])

            def setvar(ctx, _n=name, _f=val_f):
                v = _f(ctx)
                ctx.vars[_n] = v
                return v
            return setvar
        if op == "getVar":
            name = cmd["varName"]

            def getvar(ctx, _n=name):
                if _n in ctx.vars:
                    return ctx.vars[_n]
                if _n in ctx.input_vars:
                    return int(ctx.input_vars[_n])
                raise CommandError(f"undefined var {_n}")
            return getvar
        if op == "if":
            c_f = self.compile_command(cmd["values"][0])
            t_f = self.compile_command(cmd["values"][1])
            e_f = self.compile_command(cmd["values"][2])
            return lambda ctx: t_f(ctx) if c_f(ctx) else e_f(ctx)
        if op == "getMemValue":
            off = int(cmd["offset"])
            return lambda ctx: fea_to_scalar(ctx.mem.get(off, ZERO8))
        if op == "functionCall":
            name = cmd["funcName"]
            if name in RAW_PARAM_FUNCTIONS:
                raw = cmd.get("params", [])

                def call_raw(ctx, _n=name, _raw=raw, _self=self):
                    fn = _self.functions.get(_n)
                    if fn is None:
                        raise CommandError(f"unimplemented ROM function {_n}")
                    return fn(ctx, *_raw)
                return call_raw
            param_fs = [self.compile_command(pc)
                        for pc in cmd.get("params", [])]

            def call(ctx, _n=name, _pf=param_fs, _self=self):
                fn = _self.functions.get(_n)
                if fn is None:
                    raise CommandError(f"unimplemented ROM function {_n}")
                return fn(ctx, *[f(ctx) for f in _pf])
            return call
        if op in _BINOP_LAMBDAS:
            vals = [self.compile_command(v) for v in cmd["values"]]
            fn = _BINOP_LAMBDAS[op]
            if len(vals) == 1:
                a_f = vals[0]
                return lambda ctx, _f=fn, _a=a_f: _f(_a(ctx), 0)
            a_f, b_f = vals[0], vals[1]
            return lambda ctx, _f=fn, _a=a_f, _b=b_f: _f(_a(ctx), _b(ctx))
        raise CommandError(f"unknown command op {op}")

    def _line_encoding(self, line: RomLine) -> dict:
        enc = self._enc_cache.get(line.zkpc)
        if enc is None:
            from ..models.zkevm.main_sm_air import encode_line
            enc = encode_line(line)
            self._enc_cache[line.zkpc] = enc
        return enc

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def execute(self, ctx: Context, start_label: str = "start",
                stop_label: Optional[str] = "finalizeExecution"):
        regs = ctx.regs
        regs.zkPC = self.rom.label(start_label) if start_label else 0
        stop_pc = self.rom.labels.get(stop_label) if stop_label else None

        ctx.max_steps = self.max_steps
        # the step budget is min(row budget, MAX_CNT_STEPS from the ROM
        # constants) — reference CHECK_MAX_CNT_ASAP on cntSteps
        step_budget = min(self.max_steps,
                          ctx.counter_limits.get("steps", self.max_steps))
        for step in range(step_budget):
            if ctx.done:
                break
            if stop_pc is not None and regs.zkPC == stop_pc:
                ctx.done = True
                break
            if regs.zkPC == self._ec_store_pc:
                # A=hash B=r C=s D=v at ecrecover_store_args
                # (main_executor.cpp:341-354); a None memo (invalid sig,
                # edge case) just leaves the direct per-op math in place
                from . import ec_precalc
                ctx.ec_memo = ec_precalc.precalc(
                    fea_to_scalar(regs.A), fea_to_scalar(regs.B),
                    fea_to_scalar(regs.C), fea_to_scalar(regs.D))
            elif regs.zkPC == self._ec_end_pc and ctx.ec_memo is not None:
                ctx.ec_memo = None
            line = self.rom.program[regs.zkPC]
            ctx.counters.steps += 1
            ctx.step = step
            self.execute_line(ctx, line, step)
        else:
            raise ZkError(ZkResult.OUT_OF_COUNTERS_STEP, "max steps reached")
        return ctx

    def _addr(self, ctx: Context, line: RomLine) -> int:
        regs = ctx.regs
        addr_rel = 0
        if line.flag("ind"):
            addr_rel += fe_to_s32(regs.E[0])
        if line.flag("indRR"):
            addr_rel += fe_to_s32(regs.RR)
        addr_rel += line.offset
        if line.flag("isStack"):
            addr_rel += regs.SP
        if addr_rel < 0:
            raise ZkError(ZkResult.PROVER_ERROR, "addrRel < 0")
        addr = addr_rel
        if line.flag("useCTX"):
            addr += regs.CTX * CTX_OFFSET
        if line.flag("isStack"):
            addr += STACK_OFFSET
        if line.flag("isMem"):
            addr += MEM_OFFSET
        return addr

    def _line_cmds(self, line: RomLine):
        bundle = self._cmd_cache.get(line.zkpc)
        if bundle is None:
            before = [self.compile_command(c) for c in line.cmd_before]
            after = [self.compile_command(c) for c in line.cmd_after]
            freein = None
            if line.free_in_tag and line.free_in_tag.get("op"):
                freein = self.compile_command(line.free_in_tag)
            hash_prefix = None
            for prefix in ("hashK", "hashP", "hashS"):
                if any(line.flag(prefix + s)
                       for s in ("", "1", "Len", "Digest")):
                    hash_prefix = prefix
                    break
            meta = {
                "need_addr": (line.flag("mOp") or line.flag("JMP")
                              or line.flag("JMPN") or line.flag("JMPC")
                              or line.flag("JMPZ") or line.flag("call")
                              or hash_prefix is not None),
                "mOp": line.flag("mOp"), "mWR": line.flag("mWR"),
                "assert": line.flag("assert"), "bin": line.flag("bin"),
                "arith": (line.flag("arith")
                          or any(line.flag(f"arithEq{i}") for i in range(6))),
                "storage": line.flag("sRD") or line.flag("sWR"),
                "mem_align": (line.flag("memAlignRD")
                              or line.flag("memAlignWR")
                              or line.flag("memAlignWR8")),
                "hash_prefix": hash_prefix,
            }
            bundle = (before, after, freein, meta)
            self._cmd_cache[line.zkpc] = bundle
        return bundle

    def execute_line(self, ctx: Context, line: RomLine, step: int):
        regs = ctx.regs
        cmd_before, cmd_after, freein_f, meta = self._line_cmds(line)
        if ctx.trace is not None:
            rec = {
                "zkPC": regs.zkPC,
                "regs": {
                    "A": list(regs.A), "B": list(regs.B), "C": list(regs.C),
                    "D": list(regs.D), "E": list(regs.E), "SR": list(regs.SR),
                    "CTX": regs.CTX, "SP": regs.SP, "PC": regs.PC,
                    "GAS": regs.GAS, "RR": regs.RR,
                    "HASHPOS": regs.HASHPOS, "RCX": regs.RCX,
                },
                "counters": (ctx.counters.arith, ctx.counters.binary,
                             ctx.counters.keccak_f, ctx.counters.sha256_f,
                             ctx.counters.mem_align, ctx.counters.padding_pg,
                             ctx.counters.poseidon_g),
                "enc": self._line_encoding(line),
            }
            ctx._hash_bytes = 0
        for fn in cmd_before:
            fn(ctx)

        # ---- op accumulation: 8 field limbs ---------------------------
        op = [0] * 8
        sel = line.ins

        def add_vec(coeff: int, vec8):
            c = coeff % P
            for i in range(8):
                op[i] = (op[i] + c * vec8[i]) % P

        def add_scalar0(coeff: int, v):
            op[0] = (op[0] + (coeff % P) * (v % P)) % P

        for name, reg in (("inA", regs.A), ("inB", regs.B), ("inC", regs.C),
                          ("inD", regs.D), ("inE", regs.E), ("inSR", regs.SR)):
            if name in sel:
                add_vec(sel[name], reg)
        for name, v in (("inCTX", regs.CTX), ("inSP", regs.SP),
                        ("inPC", regs.PC), ("inGAS", regs.GAS),
                        ("inSTEP", step), ("inRR", regs.RR),
                        ("inHASHPOS", regs.HASHPOS), ("inRCX", regs.RCX),
                        ("inCntArith", ctx.counters.arith),
                        ("inCntBinary", ctx.counters.binary),
                        ("inCntKeccakF", ctx.counters.keccak_f),
                        ("inCntSha256F", ctx.counters.sha256_f),
                        ("inCntMemAlign", ctx.counters.mem_align),
                        ("inCntPaddingPG", ctx.counters.padding_pg),
                        ("inCntPoseidonG", ctx.counters.poseidon_g)):
            if name in sel:
                add_scalar0(sel[name], v)
        if "inROTL_C" in sel:
            rot = [regs.C[7]] + regs.C[0:7]
            add_vec(sel["inROTL_C"], rot)

        if line.has_const:
            c = line.const
            op[0] = (op[0] + (c % P)) % P
        if line.has_constl:
            for i, limb in enumerate(scalar_to_fea(line.constl)):
                op[i] = (op[i] + limb) % P

        # free input
        fi8 = None
        if line.free_in_tag is not None:
            if freein_f is None:
                fi8 = self._free_in_default(ctx, line)
            else:
                res = freein_f(ctx)
                # functions may return raw 8-limb field lists (e.g. cond's
                # field -1, which exceeds the 32-bit scalar limbs)
                fi8 = [int(v) % P for v in res] if isinstance(res, list) \
                    else scalar_to_fea(res)
            if sel.get("inFREE"):
                add_vec(sel["inFREE"], fi8)
            if sel.get("inFREE0"):
                add_scalar0(sel["inFREE0"], fi8[0])

        # ---- operations ----------------------------------------------
        addr = self._addr(ctx, line) if meta["need_addr"] else 0

        if meta["mOp"]:
            if meta["mWR"]:
                ctx.mem[addr] = list(op)
                ctx.required.memory.append(("W", addr, list(op), step))
            else:
                val = ctx.mem.get(addr, ZERO8)
                ctx.required.memory.append(("R", addr, list(val), step))
                if op != list(val):
                    raise ZkError(ZkResult.PROVER_ERROR,
                                  f"memory read mismatch at zkPC={line.zkpc}")

        if meta["assert"]:
            if regs.A != op:
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"assert fails at zkPC={line.zkpc}: "
                              f"[{line.line_str.strip()}]")

        if meta["bin"]:
            self._do_binary(ctx, line, op)
        if meta["arith"]:
            self._do_arith(ctx, line, op)
        if meta["storage"]:
            self._do_storage(ctx, line, op)
        if meta["mem_align"]:
            self._do_mem_align(ctx, line, op)
        if meta["hash_prefix"] is not None:
            prefix = meta["hash_prefix"]
            table = {"hashK": ctx.hash_k, "hashP": ctx.hash_p,
                     "hashS": ctx.hash_s}[prefix]
            self._do_hash(ctx, line, prefix, table, op, addr)

        # ---- setters --------------------------------------------------
        for s in line.sets:
            name = s[3:]
            if name in ("A", "B", "C", "D", "E", "SR"):
                setattr(regs, name, list(op))
            else:
                setattr(regs, name, op[0])

        # ---- control flow --------------------------------------------
        next_pc = regs.zkPC + 1
        dest = line.jmp_addr if line.flag("useJmpAddr") else addr
        if line.flag("JMPN"):
            v = op[0]
            if v >= FR_FIRST_32_NEGATIVE:
                next_pc = dest
            elif v <= FR_LAST_32_POSITIVE:
                next_pc = line.else_addr if line.flag("useElseAddr") \
                    else regs.zkPC + 1
            else:
                raise ZkError(ZkResult.PROVER_ERROR, "JMPN invalid S33 value")
        elif line.flag("JMPC"):
            if ctx.carry:
                next_pc = dest
            else:
                next_pc = line.else_addr if line.flag("useElseAddr") \
                    else regs.zkPC + 1
        elif line.flag("JMPZ"):
            if op[0] == 0:
                next_pc = dest
            else:
                next_pc = line.else_addr if line.flag("useElseAddr") \
                    else regs.zkPC + 1
        elif line.flag("JMP"):
            next_pc = dest
        elif line.flag("call"):
            regs.RR = regs.zkPC + 1
            next_pc = dest
        elif line.flag("return"):
            next_pc = regs.RR

        if line.flag("repeat") and regs.RCX != 0:
            regs.RCX = (regs.RCX - 1) % P
            if regs.RCX != 0:
                next_pc = regs.zkPC

        regs.zkPC = next_pc

        if ctx.trace is not None:
            rec["op"] = list(op)
            rec["free"] = list(fi8) if fi8 is not None else list(ZERO8)
            rec["carry"] = ctx.carry
            rec["binCarry"] = ctx.carry if line.flag("bin") else 0
            rec["hashBytes"] = ctx._hash_bytes
            rec["rcxNext"] = regs.RCX
            ctx.trace.append(rec)

        for fn in cmd_after:
            fn(ctx)

    # ------------------------------------------------------------------
    def _free_in_default(self, ctx, line):
        """Free input for untagged ops: derived from the operation itself
        (reference calculateFreeInput semantics) — memory reads, binary
        results, storage reads, hash digests."""
        if line.flag("mOp") and not line.flag("mWR"):
            return list(ctx.mem.get(self._addr(ctx, line), ZERO8))
        if line.flag("memAlignRD"):
            M256 = (1 << 256) - 1
            m0 = fea_to_scalar(ctx.regs.A)
            m1 = fea_to_scalar(ctx.regs.B)
            offset = fea_to_scalar(ctx.regs.C)
            if offset > 32:
                raise ZkError(ZkResult.PROVER_ERROR, "memAlign offset")
            left_v = (m0 << (offset * 8)) & M256
            right_v = (m1 >> (256 - offset * 8)) if offset else 0
            return scalar_to_fea(left_v | right_v)
        if line.flag("bin"):
            res, _carry = self._binary_result(line.bin_opcode,
                                              fea_to_scalar(ctx.regs.A),
                                              fea_to_scalar(ctx.regs.B))
            return scalar_to_fea(res)
        if line.flag("sRD"):
            old_root = self._root_quad(ctx.regs.SR)
            key = self._storage_key_cached(ctx)
            res = ctx.hashdb.get(ctx.batch_uuid, old_root, key)
            ctx._sload_cache = (old_root, key, res)
            return scalar_to_fea(res.value)
        if line.flag("sWR"):
            # free input of an SSTORE is the NEW root (reference
            # main_executor.cpp sWR free-input case: pHashDB->set there,
            # result reused by the later op block)
            old_root = self._root_quad(ctx.regs.SR)
            key = self._storage_key_cached(ctx)
            value = fea_to_scalar(ctx.regs.D)
            res = ctx.hashdb.set(ctx.batch_uuid, old_root, key, value)
            ctx._sstore_cache = (old_root, key, value, res)
            return self._quad_to_sr8(res.new_root)
        for prefix, table in (("hashK", ctx.hash_k), ("hashP", ctx.hash_p),
                              ("hashS", ctx.hash_s)):
            if line.flag(prefix + "Digest"):
                addr = self._addr(ctx, line)
                st = table.setdefault(addr, HashState())
                return scalar_to_fea(self._hash_digest(st, prefix))
        return list(ZERO8)

    @staticmethod
    def _hash_digest(st: "HashState", prefix: str) -> int:
        if st.digest is None:
            if prefix == "hashK":
                st.digest = int.from_bytes(keccak256(bytes(st.data)), "big")
            elif prefix == "hashS":
                import hashlib
                st.digest = int.from_bytes(
                    hashlib.sha256(bytes(st.data)).digest(), "big")
            else:
                # hashP: Poseidon linear hash over 7-byte elements
                # (reference poseidonLinearHash); digest scalar packs the
                # four 64-bit outputs as h0 | h1<<64 | h2<<128 | h3<<192
                from ..models.zkevm.padding_pg_sm import linear_hash_bytes
                h = linear_hash_bytes(bytes(st.data))
                st.digest = (h[0] | (h[1] << 64) | (h[2] << 128)
                             | (h[3] << 192))
        return st.digest

    @staticmethod
    def _binary_result(opcode: int, a: int, b: int):
        """(result, carry) of a 256-bit binary op (shared by the free-input
        derivation and the bin consistency check)."""
        if opcode == 0:      # ADD
            return (a + b) & MASK256, int(a + b > MASK256)
        if opcode == 1:      # SUB
            return (a - b) & MASK256, int(a < b)
        if opcode == 2:      # LT
            r = int(a < b)
            return r, r
        if opcode == 3:      # SLT
            sa = a - (1 << 256) if a >> 255 else a
            sb = b - (1 << 256) if b >> 255 else b
            r = int(sa < sb)
            return r, r
        if opcode == 4:      # EQ
            r = int(a == b)
            return r, r
        if opcode == 5:      # AND
            r = a & b
            return r, int(r != 0)
        if opcode == 6:      # OR
            return a | b, 0
        if opcode == 7:      # XOR
            return a ^ b, 0
        if opcode == 8:      # LT4
            r = int(all(((a >> (64 * i)) & 0xFFFFFFFFFFFFFFFF)
                        < ((b >> (64 * i)) & 0xFFFFFFFFFFFFFFFF)
                        for i in range(4)))
            return r, r
        raise ZkError(ZkResult.PROVER_ERROR, f"bad binOpcode {opcode}")

    def _do_binary(self, ctx: Context, line: RomLine, op):
        regs = ctx.regs
        a = fea_to_scalar(regs.A)
        b = fea_to_scalar(regs.B)
        res = fea_to_scalar(op)
        opcode = line.bin_opcode
        _bump(ctx, "binary")
        expected, carry = self._binary_result(opcode, a, b)
        if res != expected:
            raise ZkError(ZkResult.PROVER_ERROR,
                          f"binary check fails zkPC={line.zkpc}")
        ctx.carry = carry
        ctx.required.binary.append((opcode, a, b, res, carry))

    def _do_arith(self, ctx: Context, line: RomLine, op):
        """Arith equation checks (reference sm_arith_eq0..eq5):
        eq0: A*B + C = D*2^256 + op (256-bit mul-add)
        eq1: secp256k1 point add (different points): (A,B)+(C,D) = (E, op)
        eq2: secp256k1 point double: 2*(A,B) = (E, op)
        eq3: BN254 Fp2 mul: (A+iB)*(C+iD) = E + i*op
        eq4: BN254 Fp2 add ; eq5: BN254 Fp2 sub."""
        regs = ctx.regs
        _bump(ctx, "arith")
        a = fea_to_scalar(regs.A)
        b = fea_to_scalar(regs.B)
        c = fea_to_scalar(regs.C)
        d = fea_to_scalar(regs.D)
        e = fea_to_scalar(regs.E)
        res = fea_to_scalar(op)
        if line.flag("arithEq0") or not any(
                line.flag(f"arithEq{i}") for i in range(6)):
            if a * b + c != (d << 256) + res:
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"arithEq0 fails zkPC={line.zkpc}")
            ctx.required.arith.append((0, a, b, c, d, 0, res))
            return
        SECP_P = 2 ** 256 - 2 ** 32 - 977
        BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
        if line.flag("arithEq1") or line.flag("arithEq2"):
            if line.flag("arithEq1"):
                if (c - a) % SECP_P == 0:
                    raise ZkError(ZkResult.PROVER_ERROR, "ECADD x1 == x2")
                slope = ((d - b) * pow(c - a, -1, SECP_P)) % SECP_P
                x3 = (slope * slope - a - c) % SECP_P
            else:
                slope = (3 * a * a * pow(2 * b, -1, SECP_P)) % SECP_P
                x3 = (slope * slope - 2 * a) % SECP_P
            y3 = (slope * (a - x3) - b) % SECP_P
            if e != x3 or res != y3:
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"EC arith fails zkPC={line.zkpc}")
            # double substitutes x2 = x1, y2 = y1 (main_executor.cpp:3991)
            if line.flag("arithEq1"):
                ctx.required.arith.append((1, a, b, c, d, e, res))
            else:
                ctx.required.arith.append((2, a, b, a, b, e, res))
            return
        if line.flag("arithEq3"):   # Fp2 mul
            x3 = (a * c - b * d) % BN_P
            y3 = (a * d + b * c) % BN_P
        elif line.flag("arithEq4"):  # Fp2 add
            x3 = (a + c) % BN_P
            y3 = (b + d) % BN_P
        else:                        # arithEq5: Fp2 sub
            x3 = (a - c) % BN_P
            y3 = (b - d) % BN_P
        if e != x3 or res != y3:
            raise ZkError(ZkResult.PROVER_ERROR,
                          f"BN254 Fp2 arith fails zkPC={line.zkpc}")
        kind = 3 if line.flag("arithEq3") else (4 if line.flag("arithEq4")
                                                else 5)
        ctx.required.arith.append((kind, a, b, c, d, e, res))

    def _do_mem_align(self, ctx: Context, line: RomLine, op):
        """memAlign ops (main_executor.cpp:4484-4640): unaligned 256-bit
        value v = op across the aligned pair (m0 = A, m1 = B) at byte
        offset C; WR checks the new words against D (and E)."""
        regs = ctx.regs
        M256 = (1 << 256) - 1
        m0 = fea_to_scalar(regs.A)
        m1 = fea_to_scalar(regs.B)
        v = fea_to_scalar(op)
        offset = fea_to_scalar(regs.C)
        if offset > 32:
            raise ZkError(ZkResult.PROVER_ERROR,
                          f"memAlign offset out of range: {offset}")
        _bump(ctx, "mem_align")
        if line.flag("memAlignWR"):
            w0 = fea_to_scalar(regs.D)
            w1 = fea_to_scalar(regs.E)
            exp_w0 = (m0 & (((1 << 256)) - (1 << (256 - offset * 8)))
                      if offset else 0) | (v >> (offset * 8))
            exp_w1 = (m1 & (M256 >> (offset * 8))) \
                | ((v << (256 - offset * 8)) & M256) if offset else m1
            if offset == 0:
                exp_w0, exp_w1 = v, m1
            if w0 != exp_w0 or w1 != exp_w1:
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"memAlignWR mismatch at zkPC={line.zkpc}")
            ctx.required.mem_align.append(("WR", m0, m1, offset, v))
        elif line.flag("memAlignWR8"):
            w0 = fea_to_scalar(regs.D)
            byte_mask = M256 ^ (0xFF << 248)         # top byte cleared
            exp_w0 = (m0 & ((byte_mask >> (offset * 8))
                            | (M256 ^ (M256 >> (offset * 8))))) \
                | ((v & 0xFF) << ((31 - offset) * 8))
            if w0 != exp_w0:
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"memAlignWR8 mismatch at zkPC={line.zkpc}")
            ctx.required.mem_align.append(("WR8", m0, m1, offset, v))
        else:
            left_v = (m0 << (offset * 8)) & M256
            right_v = (m1 >> (256 - offset * 8)) if offset else 0
            if v != (left_v | right_v):
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"memAlignRD mismatch at zkPC={line.zkpc}")
            ctx.required.mem_align.append(("RD", m0, m1, offset, v))

    def _storage_key_cached(self, ctx):
        """Per-step storage-key memo: the free-input derivation and the
        op block of the SAME line both need it (registers cannot change
        in between); kin0/kin1 are kept for the later PoseidonG request
        recording."""
        cached = ctx._skey_cache
        if cached is not None and cached[0] == ctx.step:
            return cached[1][2]
        triple = _storage_key(ctx.regs)
        ctx._skey_cache = (ctx.step, triple)
        return triple[2]

    @staticmethod
    def _root_quad(sr8):
        """8x32-bit SR limbs -> 4x64-bit SMT root quad."""
        return tuple((int(sr8[2 * j]) | (int(sr8[2 * j + 1]) << 32))
                     for j in range(4))

    @staticmethod
    def _quad_to_sr8(quad):
        out = []
        for v in quad:
            out.append(int(v) & 0xFFFFFFFF)
            out.append((int(v) >> 32) & 0xFFFFFFFF)
        return out

    def _do_storage(self, ctx: Context, line: RomLine, op):
        regs = ctx.regs
        key = self._storage_key_cached(ctx)
        # record the key-derivation permutations as PoseidonG requests
        kin0, kin1, _k = ctx._skey_cache[1]
        ctx.required.poseidon.append(kin0)
        ctx.required.poseidon.append(kin1)
        old_root = self._root_quad(regs.SR)
        if line.flag("sWR"):
            value = fea_to_scalar(regs.D)
            cached = ctx._sstore_cache
            if cached is not None and cached[0] == old_root \
                    and cached[1] == key and cached[2] == value:
                res = cached[3]
                ctx._sstore_cache = None
            else:
                res = ctx.hashdb.set(ctx.batch_uuid, old_root, key, value)
            regs.SR = self._quad_to_sr8(res.new_root)
            ctx.required.storage.append(SmtAction(is_set=True,
                                                  set_result=res))
            # reference: incCounter = proofHashCounter + 2
            # (main_executor.cpp:2557, applied to cntPoseidonG at :5322)
            _bump(ctx, "poseidon_g", res.proof_hash_counter + 2)
        else:
            cached = ctx._sload_cache
            if cached is not None and cached[0] == old_root \
                    and cached[1] == key:
                res = cached[2]
                ctx._sload_cache = None
            else:
                res = ctx.hashdb.get(ctx.batch_uuid, old_root, key)
            if fea_to_scalar(op) != res.value:
                raise ZkError(ZkResult.PROVER_ERROR, "sRD value mismatch")
            ctx.required.storage.append(SmtAction(is_set=False,
                                                  get_result=res))
            _bump(ctx, "poseidon_g", res.proof_hash_counter + 2)

    def _do_hash(self, ctx: Context, line: RomLine, prefix: str, table,
                 op, addr: int):
        regs = ctx.regs
        st = table.setdefault(addr, HashState())
        if line.flag(prefix) or line.flag(prefix + "1"):
            nbytes = 1 if line.flag(prefix + "1") else \
                fe_to_s32(regs.D[0])
            if not (1 <= nbytes <= 32):
                raise ZkError(ZkResult.PROVER_ERROR, "hash size out of range")
            value = fea_to_scalar(op)
            if value >> (8 * nbytes):
                # op bytes beyond size must be zero (the padding-SM lookup
                # compares all 8 limbs; main_executor.cpp:2754-2761)
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"{prefix} value beyond size at "
                              f"zkPC={line.zkpc}")
            data = value.to_bytes(32, "big")[-nbytes:]
            pos = regs.HASHPOS
            seeds_zero = (prefix == "hashP" and pos == 1 and not st.data
                          and not st.first_byte_written)
            st.write(pos, data, line.zkpc,
                     first_byte_games=(prefix == "hashP"))
            if seeds_zero:
                # the zero placeholder byte is its own singleton read
                # (main_executor.cpp:3000 ctx.hashP[addr].reads[0] = 1)
                st.reads[0] = 1
            if st.reads.setdefault(pos, nbytes) != nbytes:
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"{prefix} two read sizes at pos {pos}, "
                              f"zkPC={line.zkpc}")
            regs.HASHPOS = (regs.HASHPOS + nbytes) % P
            ctx._hash_bytes = nbytes
        elif line.flag(prefix + "Len"):
            st.len = op[0]
            st.len_called = True
        elif line.flag(prefix + "Digest"):
            if fea_to_scalar(op) != self._hash_digest(st, prefix):
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"{prefix}Digest mismatch at zkPC={line.zkpc}")
            if st.digest_called:
                raise ZkError(ZkResult.PROVER_ERROR,
                              f"{prefix}Digest called twice at "
                              f"zkPC={line.zkpc}")
            st.digest_called = True
            # counters bump at the Digest row by padded-block count
            # (main_executor.cpp:2906 keccak ceil((n+1)/136),
            #  :3219 poseidon ceil((n+1)/56), :3478 sha ceil((n+1+8)/64))
            n = len(st.data)
            if prefix == "hashK":
                _bump(ctx, "keccak_f", -(-(n + 1) // 136))
            elif prefix == "hashS":
                _bump(ctx, "sha256_f", -(-(n + 1 + 8) // 64))
            else:
                inc = -(-(n + 1) // 56)
                _bump(ctx, "padding_pg", inc)
                _bump(ctx, "poseidon_g", inc)
