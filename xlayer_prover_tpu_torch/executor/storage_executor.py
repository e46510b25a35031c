"""Storage SM replay executor: replays SMT get/set actions through the
reference storage micro-ROM (config/scripts/storage_sm_rom.json), producing
the Storage SM trace rows plus PoseidonG and ClimbKey requests.

The port's own copy of ``xlayer_prover_tpu/executor/storage_executor.py``
(hashes through the port's host Poseidon), the re-design of
src/sm/storage/storage_executor.cpp (1,286 LoC): the row loop is
sequential host work (it follows data-dependent micro-ROM jumps), so it
stays on the host like the Main SM interpreter.  Semantics follow the
reference exactly:

  * per-action context (smt_action_context.cpp): level = #siblings, rKey /
    siblingRKey seeded from key / insKey, bits vectors generated by popping
    the low bit of limb i%4 — for insertFound/deleteFound the walk continues
    past the sibling list until the keys diverge.
  * free-input functions (storage_executor.cpp:60-520): mode predicates,
    value/old-value/sibling-value halves, sibling hashes via the recorded
    sibling nodes, level bookkeeping with GetNextKeyBit's auto-decrement.
  * op accumulation over quad selectors (inRKEY/inOLD_ROOT/..., CONST as a
    signed scalar), JMPZ/JMPNZ/JMP on op[0], Poseidon hash of
    HASH_LEFT||HASH_RIGHT||capacity(hashType), CLIMB ops injecting RKEY_BIT
    into the level%4 limb, LATCH GET/SET consistency checks against the
    recorded action (roots, full key, value, level 0).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..fields import gl
from ..ops.poseidon_gl import host_permute
from ..state.smt import SmtGetResult, SmtSetResult, value_to_fea8
from .storage_rom import StorageRom

P = gl.P
ZERO4 = (0, 0, 0, 0)

# PoseidonG SM permutation-type tag for Storage hashes
# (reference poseidon_g_permutation.hpp POSEIDONG_PERMUTATION3_ID)
POSEIDONG_PERMUTATION3_ID = 3

# Registers that are quads vs scalars
QUAD_REGS = ["RKEY", "VALUE_LOW", "VALUE_HIGH", "OLD_ROOT", "NEW_ROOT",
             "HASH_LEFT", "HASH_RIGHT", "SIBLING_RKEY", "SIBLING_VALUE_HASH"]
SCALAR_REGS = ["RKEY_BIT", "LEVEL"]

# bits in rkey limbs must stay climbable: rkey*2+bit < p  (reference
# ClimbKeyHelper, storage_executor.cpp PRE_CLIMB_UP_LIMIT)
PRE_CLIMB_UP_LIMIT = 0x7FFFFFFF80000000


@dataclasses.dataclass
class SmtAction:
    """One SMT operation to replay (reference smt_action.hpp)."""
    is_set: bool
    set_result: Optional[SmtSetResult] = None
    get_result: Optional[SmtGetResult] = None

    @property
    def result(self):
        return self.set_result if self.is_set else self.get_result


class _ActionContext:
    """Reference SmtActionContext (smt_action_context.cpp)."""

    def __init__(self, action: SmtAction):
        res = action.result
        self.level = len(res.siblings)
        r_key = [int(v) for v in res.key]
        ins = res.ins_key if res.ins_key is not None else ZERO4
        sibling_r_key = [int(v) for v in ins]
        self.bits: List[int] = []
        self.sibling_bits: List[int] = []
        mode = res.mode if action.is_set else None
        diverging = action.is_set and mode in ("insertFound", "deleteFound")
        if not diverging:
            for i in range(self.level):
                k = i % 4
                self.bits.append(r_key[k] & 1)
                self.sibling_bits.append(sibling_r_key[k] & 1)
                r_key[k] >>= 1
                sibling_r_key[k] >>= 1
        else:
            for i in range(256):
                k = i % 4
                bit = r_key[k] & 1
                sib = sibling_r_key[k] & 1
                r_key[k] >>= 1
                sibling_r_key[k] >>= 1
                self.bits.append(bit)
                self.sibling_bits.append(sib)
                if bit != sib:
                    break
            self.level = len(self.bits)
        self.r_key = tuple(r_key)
        self.sibling_r_key = tuple(sibling_r_key)
        self.current_level = self.level


class StorageExecutorError(Exception):
    pass


def _scalar_fea8(value: int) -> List[int]:
    return value_to_fea8(int(value))


def _climb(limb: int, bit: int) -> int:
    if limb > PRE_CLIMB_UP_LIMIT:
        raise StorageExecutorError(
            f"climb overflow: limb {limb:#x} exceeds PRE_CLIMB_UP_LIMIT")
    return (limb << 1) | bit


class StorageExecutor:
    """Replays a list of SmtActions through the storage micro-ROM."""

    def __init__(self, rom: StorageRom):
        self.rom = rom

    def execute(self, actions: List[SmtAction], max_rows: int = 1 << 20,
                n_rows: int = None):
        """Returns (rows, poseidon_required, climb_key_required).

        rows: list of per-row dicts with the register file, pc, free input
        and instruction flags — the Storage SM trace.  Without ``n_rows``,
        stops at the row where the ROM first calls isAlmostEndPolynomial
        with the action list consumed.  With ``n_rows``, pads exactly like
        the reference (storage_executor.cpp:481-494): the ROM idles in its
        JMPZ self-loop and isAlmostEndPolynomial returns 1 at row N-2, so
        row N-1 jumps back to pc 0 and the trace closes cyclically."""
        rom = self.rom
        regs = {name: ZERO4 for name in QUAD_REGS}
        regs.update({name: 0 for name in SCALAR_REGS})
        pc = 0
        a = 0
        empty = not actions
        ctx = None if empty else _ActionContext(actions[0])
        inc_counter = 0
        rows = []
        poseidon_required = []
        climb_key_required = []

        if n_rows is not None:
            max_rows = n_rows
        for i in range(max_rows):
            line = rom.lines[pc]
            op = [0, 0, 0, 0]
            free = [0, 0, 0, 0]
            action = None if empty else actions[a]
            res = None if empty else action.result
            done = False

            # ---- free input ------------------------------------------
            hash_out = None
            if line.hash:
                fea = list(regs["HASH_LEFT"]) + list(regs["HASH_RIGHT"]) \
                    + [1 if line.hash_type else 0, 0, 0, 0]
                out = host_permute(fea)[:4]
                hash_out = tuple(out)
                free = list(out)
                poseidon_required.append(
                    (tuple(fea[:12]), hash_out, POSEIDONG_PERMUTATION3_ID))
            elif line.climb_rkey or line.climb_sibling_rkey:
                bit = regs["RKEY_BIT"]
                if line.climb_bit_n:
                    bit = 1 - bit
                level = regs["LEVEL"]
                zlevel = level % 4
                src = regs["RKEY"] if line.climb_rkey \
                    else regs["SIBLING_RKEY"]
                climbed = list(src)
                climbed[zlevel] = _climb(int(src[zlevel]), bit)
                free = climbed
                climb_key_required.append((tuple(src), level, bit))
            elif line.free_in_tag is not None:
                tag = line.free_in_tag
                if tag.get("op") == "functionCall":
                    if tag["funcName"] == "isAlmostEndPolynomial":
                        if n_rows is not None:
                            free = [1 if i == n_rows - 2 else 0, 0, 0, 0]
                            if not empty:
                                raise StorageExecutorError(
                                    "action list not consumed before the "
                                    "end of the polynomial")
                        else:
                            free = [1 if empty else 0, 0, 0, 0]
                            done = empty
                    else:
                        free = self._function_call(tag["funcName"], ctx,
                                                   action, res, empty, i,
                                                   regs)
                elif tag.get("op") in ("", None):
                    pass
                else:
                    raise StorageExecutorError(
                        f"unknown freeInTag op {tag.get('op')}")

            coeff_free = line.ins.get("FREE", 0)
            if coeff_free:
                for j in range(4):
                    op[j] = (op[j] + coeff_free * free[j]) % P

            # ---- selectors -------------------------------------------
            if line.const is not None:
                op[0] = (op[0] + line.const) % P
            for name, reg in (("OLD_ROOT", "OLD_ROOT"),
                              ("NEW_ROOT", "NEW_ROOT"),
                              ("VALUE_LOW", "VALUE_LOW"),
                              ("VALUE_HIGH", "VALUE_HIGH"),
                              ("RKEY", "RKEY"),
                              ("SIBLING_RKEY", "SIBLING_RKEY"),
                              ("SIBLING_VALUE_HASH", "SIBLING_VALUE_HASH")):
                c = line.ins.get(name, 0)
                if c:
                    for j in range(4):
                        op[j] = (op[j] + c * regs[reg][j]) % P
            c = line.ins.get("RKEY_BIT", 0)
            if c:
                op[0] = (op[0] + c * regs["RKEY_BIT"]) % P
            c = line.ins.get("LEVEL", 0)
            if c:
                op[0] = (op[0] + c * regs["LEVEL"]) % P
            c = line.ins.get("ROTL_VH", 0)
            if c:
                vh = regs["VALUE_HIGH"]
                rot = (vh[3], vh[0], vh[1], vh[2])
                for j in range(4):
                    op[j] = (op[j] + c * rot[j]) % P

            # ---- climb consistency (reference re-check) ---------------
            if line.climb_rkey or line.climb_sibling_rkey:
                level = regs["LEVEL"]
                zlevel = level % 4
                if op[zlevel] != free[zlevel]:
                    raise StorageExecutorError(
                        f"climb mismatch at line {pc} row {i}")

            # ---- latches ---------------------------------------------
            if line.latch_get:
                self._latch_get(action, regs, i)
                a += 1
                if a >= len(actions):
                    empty = True
                else:
                    ctx = _ActionContext(actions[a])
            if line.latch_set:
                self._latch_set(action, regs, i)
                a += 1
                if a >= len(actions):
                    empty = True
                else:
                    ctx = _ActionContext(actions[a])

            # ---- record row ------------------------------------------
            rows.append({
                "pc": pc, "free": tuple(free), "op": tuple(op),
                "incCounter": inc_counter,
                **{r: regs[r] for r in QUAD_REGS},
                **{r: regs[r] for r in SCALAR_REGS},
                "hash": int(line.hash), "hashType": line.hash_type,
                "latchGet": int(line.latch_get),
                "latchSet": int(line.latch_set),
                "climbRkey": int(line.climb_rkey),
                "climbSiblingRkey": int(line.climb_sibling_rkey),
            })

            # ---- counter ---------------------------------------------
            if line.hash:
                inc_counter += 1
            elif line.latch_get or line.latch_set:
                inc_counter = 0

            # ---- setters ---------------------------------------------
            for s in line.sets:
                if s in QUAD_REGS:
                    regs[s] = tuple(op)
                elif s == "RKEY_BIT":
                    regs["RKEY_BIT"] = op[0]
                elif s == "LEVEL":
                    regs["LEVEL"] = op[0]
                else:
                    raise StorageExecutorError(f"unknown setter {s}")

            # ---- control flow ----------------------------------------
            if line.jmpz is not None:
                pc = line.jmpz if op[0] == 0 else pc + 1
            elif line.jmpnz is not None:
                pc = line.jmpnz if op[0] != 0 else pc + 1
            elif line.jmp is not None:
                pc = line.jmp
            else:
                pc = pc + 1

            if done:
                return rows, poseidon_required, climb_key_required

        if n_rows is not None:
            return rows, poseidon_required, climb_key_required
        raise StorageExecutorError("storage replay exceeded max_rows")

    # ------------------------------------------------------------------
    def _function_call(self, fn: str, ctx, action, res, empty: bool, row,
                       regs):
        def one_if(cond):
            return [1 if cond else 0, 0, 0, 0]

        # the reference indexes siblings/levels by the LEVEL *register* at
        # this row, not the context walk counter (storage_executor.cpp:64)
        reg_level = int(regs["LEVEL"])

        is_set = (not empty) and action.is_set
        mode = res.mode if (is_set and res is not None) else None
        if fn == "isSetUpdate":
            return one_if(mode == "update")
        if fn == "isSetInsertFound":
            return one_if(mode == "insertFound")
        if fn == "isSetInsertNotFound":
            return one_if(mode == "insertNotFound")
        if fn == "isSetDeleteLast":
            return one_if(mode == "deleteLast")
        if fn == "isSetDeleteFound":
            return one_if(mode == "deleteFound")
        if fn == "isSetDeleteNotFound":
            return one_if(mode == "deleteNotFound")
        if fn == "isSetZeroToZero":
            return one_if(mode == "zeroToZero")
        if fn == "isGet":
            return one_if((not empty) and not action.is_set)
        if fn == "GetIsOld0":
            return one_if((not empty) and res.is_old0)
        if fn == "isValueZero":
            if empty:
                return one_if(True)
            v = res.new_value if action.is_set else res.value
            return one_if(v == 0)
        if fn == "GetRkey":
            return list(ctx.r_key)
        if fn == "GetSiblingRkey":
            return list(ctx.sibling_r_key)
        if fn == "GetSiblingHash":
            node = res.siblings[reg_level]
            side = 1 - ctx.bits[reg_level]
            return [int(v) for v in node[side * 4: side * 4 + 4]]
        if fn == "GetSiblingLeftChildHash":
            if not is_set:
                raise StorageExecutorError(
                    "GetSiblingLeftChildHash on a GET action")
            return [int(v) for v in res.sibling_left_child]
        if fn == "GetSiblingRightChildHash":
            if not is_set:
                raise StorageExecutorError(
                    "GetSiblingRightChildHash on a GET action")
            return [int(v) for v in res.sibling_right_child]
        if fn == "GetValueLow":
            v = res.new_value if is_set else (0 if empty else res.value)
            return _scalar_fea8(v)[0:4]
        if fn == "GetValueHigh":
            v = res.new_value if is_set else (0 if empty else res.value)
            return _scalar_fea8(v)[4:8]
        if fn == "GetSiblingValueLow":
            return _scalar_fea8(res.ins_value)[0:4]
        if fn == "GetSiblingValueHigh":
            return _scalar_fea8(res.ins_value)[4:8]
        if fn == "GetOldValueLow":
            if not is_set:
                raise StorageExecutorError("GetOldValueLow on a GET action")
            return _scalar_fea8(res.old_value)[0:4]
        if fn == "GetOldValueHigh":
            if not is_set:
                raise StorageExecutorError("GetOldValueHigh on a GET action")
            return _scalar_fea8(res.old_value)[4:8]
        if fn == "GetLevel":
            return [ctx.level, 0, 0, 0]
        if fn == "GetTopTree":
            return one_if(reg_level > 0)
        if fn == "GetTopOfBranch":
            return one_if(reg_level > len(res.siblings))
        if fn == "GetNextKeyBit":
            ctx.current_level -= 1
            if ctx.current_level < 0:
                raise StorageExecutorError("GetNextKeyBit below level 0")
            return [ctx.bits[ctx.current_level], 0, 0, 0]
        if fn == "isAlmostEndPolynomial":
            # one action stream per call here: true once the list is done
            return one_if(empty)
        raise StorageExecutorError(f"unknown storage function {fn}")

    # ------------------------------------------------------------------
    @staticmethod
    def _latch_get(action, regs, row):
        if action.is_set:
            raise StorageExecutorError(f"LATCH GET on a SET action (row {row})")
        res = action.get_result
        if tuple(regs["OLD_ROOT"]) != tuple(int(v) for v in res.root):
            raise StorageExecutorError(f"LATCH GET root mismatch (row {row})")
        if tuple(regs["RKEY"]) != tuple(int(v) for v in res.key):
            raise StorageExecutorError(f"LATCH GET key mismatch (row {row})")
        if regs["LEVEL"] != 0:
            raise StorageExecutorError(f"LATCH GET level != 0 (row {row})")
        got = _scalar_fea8(res.value)
        have = list(regs["VALUE_LOW"]) + list(regs["VALUE_HIGH"])
        if [int(v) for v in have] != got:
            raise StorageExecutorError(f"LATCH GET value mismatch (row {row})")

    @staticmethod
    def _latch_set(action, regs, row):
        if not action.is_set:
            raise StorageExecutorError(f"LATCH SET on a GET action (row {row})")
        res = action.set_result
        if tuple(regs["OLD_ROOT"]) != tuple(int(v) for v in res.old_root):
            raise StorageExecutorError(
                f"LATCH SET old root mismatch (row {row}, mode {res.mode})")
        if tuple(regs["NEW_ROOT"]) != tuple(int(v) for v in res.new_root):
            raise StorageExecutorError(
                f"LATCH SET new root mismatch (row {row}, mode {res.mode})")
        if tuple(regs["RKEY"]) != tuple(int(v) for v in res.key):
            raise StorageExecutorError(
                f"LATCH SET key mismatch (row {row}, mode {res.mode})")
        if regs["LEVEL"] != 0:
            raise StorageExecutorError(
                f"LATCH SET level != 0 (row {row}, mode {res.mode})")
        got = _scalar_fea8(res.new_value)
        have = list(regs["VALUE_LOW"]) + list(regs["VALUE_HIGH"])
        if [int(v) for v in have] != got:
            raise StorageExecutorError(
                f"LATCH SET value mismatch (row {row}, mode {res.mode})")
