"""FullTracer: EVM-level trace collection driving the Executor responses.

The port's own copy of ``xlayer_prover_tpu/executor/full_tracer.py``, the
equivalent of the reference fork_9 FullTracer (src/main_sm/fork_9/main/
full_tracer.cpp, 2,531 LoC; event hooks listed at full_tracer.hpp:60-70):
the ROM fires ``eventLog(onX ...)`` commands at batch/block/tx/opcode
boundaries; the tracer snapshots registers and ROM memory globals into the
block/tx/log response structures that fill ProcessBatchResponseV2
(src/grpc/proto/executor.proto:331-573).

Event vocabulary (observed in the fork_9 ROM): onStartBatch(C),
onStartBlock, onProcessTx, onFinishTx, onFinishBlock, onFinishBatch,
onError(name), onUpdateStorage(C, E), onOpcode(RR), plus the storeLog
free-function for LOG0..4 opcodes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..fields import gl

P = gl.P
MASK160 = (1 << 160) - 1


def _fea(regs8) -> int:
    v = 0
    for i in range(8):
        limb = int(regs8[i])
        if limb >= (1 << 32):
            return 0        # non-scalar register state; tracer stays quiet
        v |= limb << (32 * i)
    return v


@dataclasses.dataclass
class LogEntry:
    address: int = 0
    topics: List[int] = dataclasses.field(default_factory=list)
    data: bytes = b""
    index: int = 0
    tx_index: int = 0
    block_number: int = 0
    tx_hash: int = 0


@dataclasses.dataclass
class TraceConfig:
    """executor.proto TraceConfigV2 / src/prover/trace_config.hpp."""
    enabled: bool = False
    disable_storage: bool = False
    disable_stack: bool = False
    enable_memory: bool = False
    enable_return_data: bool = False
    tx_hash_to_generate_full_trace: int = 0

    def generate_for(self, tx_hash: int) -> bool:
        if not self.enabled:
            return False
        if self.tx_hash_to_generate_full_trace:
            return int(tx_hash) == int(self.tx_hash_to_generate_full_trace)
        return True


@dataclasses.dataclass
class OpcodeStep:
    """One EVM opcode record (executor.proto TransactionStepV2;
    full_tracer.cpp onOpcode)."""
    op: int = 0
    pc: int = 0
    gas: int = 0
    gas_cost: int = 0
    gas_refund: int = 0
    depth: int = 1
    state_root: int = 0
    stack: List[int] = dataclasses.field(default_factory=list)
    memory: bytes = b""
    memory_size: int = 0
    return_data: bytes = b""
    storage: Dict[int, int] = dataclasses.field(default_factory=dict)
    error: str = ""


@dataclasses.dataclass
class TxTrace:
    tx_index: int = 0
    tx_hash: int = 0
    tx_hash_l2: int = 0
    from_addr: int = 0
    gas_left: int = 0
    gas_used: int = 0
    state_root: int = 0
    error: str = ""
    logs: List[LogEntry] = dataclasses.field(default_factory=list)
    storage: Dict[int, int] = dataclasses.field(default_factory=dict)
    opcodes: int = 0
    steps: List[OpcodeStep] = dataclasses.field(default_factory=list)
    full_trace: bool = False


@dataclasses.dataclass
class BlockTrace:
    block_number: int = 0
    timestamp: int = 0
    coinbase: int = 0
    gas_used: int = 0
    parent_hash: int = 0
    block_hash: int = 0
    ger: int = 0
    error: str = ""
    responses: List[TxTrace] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BatchTrace:
    old_state_root: int = 0
    new_state_root: int = 0
    new_acc_input_hash: int = 0
    new_local_exit_root: int = 0
    new_batch_num: int = 0
    gas_used: int = 0
    error: str = ""
    invalid_batch: bool = False
    blocks: List[BlockTrace] = dataclasses.field(default_factory=list)
    read_write_addresses: List[list] = dataclasses.field(default_factory=list)


# errors that invalidate the whole batch (full_tracer.cpp invalidBatchErrors)
INVALID_BATCH_ERRORS = {
    "invalidRLP", "invalidBatchL2Data", "invalidDecodeChangeL2Block",
    "invalidNotFirstTxChangeL2Block", "invalid_change_l2_block",
}


class FullTracer:
    """Collects the execution trace via the ROM's eventLog hooks."""

    CTX_OFFSET = 0x40000       # main_executor.cpp:46 address spaces
    STACK_OFFSET = 0x10000
    MEM_OFFSET = 0x20000

    # opcodes that open / close a call frame (depth tracking,
    # full_tracer.cpp onOpcode)
    _CALL_OPS = {0xF0, 0xF1, 0xF2, 0xF4, 0xF5, 0xFA}   # CREATE/CALL family
    _RET_OPS = {0x00, 0xF3, 0xFD, 0xFF}                # STOP/RETURN/REVERT/SD

    def __init__(self, rom=None, trace_config: Optional[TraceConfig] = None):
        self.batch = BatchTrace()
        self.current_block: Optional[BlockTrace] = None
        self.current_tx: Optional[TxTrace] = None
        self.tx_count = 0
        self.log_index = 0
        self.config = trace_config or TraceConfig()
        self.call_depth = 1
        self._var_offsets = {}
        if rom is not None:
            for line in rom.program:
                if line.offset_label and line.offset_label \
                        not in self._var_offsets:
                    self._var_offsets[line.offset_label] = \
                        (line.offset, bool(line.flag("useCTX")))

    # -- helpers ---------------------------------------------------------
    def _mem_var(self, ctx, name: str, default: int = 0) -> int:
        hit = self._var_offsets.get(name)
        if hit is None:
            return default
        off, use_ctx = hit
        if use_ctx:
            off += int(ctx.regs.CTX) * self.CTX_OFFSET
        return _fea(ctx.mem.get(off, [0] * 8))

    # -- event dispatch (called from rom_functions.event_log) ------------
    def handle_event(self, ctx, name: str, values: List[int]):
        handler = getattr(self, "on_" + _snake(name), None)
        if handler is not None:
            handler(ctx, values)

    def on_start_batch(self, ctx, values):
        self.batch.old_state_root = _fea(ctx.regs.SR)

    def on_start_block(self, ctx, values):
        blk = BlockTrace(
            block_number=self._mem_var(ctx, "blockNum"),
            timestamp=self._mem_var(ctx, "timestamp"),
            coinbase=self._mem_var(ctx, "sequencerAddr") & MASK160,
            ger=self._mem_var(ctx, "gerL1InfoTree"),
        )
        self.current_block = blk
        self.batch.blocks.append(blk)

    def on_process_tx(self, ctx, values):
        if self.current_block is None:
            self.on_start_block(ctx, [])
        tx = TxTrace(
            tx_index=self.tx_count,
            tx_hash=self._mem_var(ctx, "txHash"),
            tx_hash_l2=self._mem_var(ctx, "l2TxHash"),
            from_addr=self._mem_var(ctx, "txSrcOriginAddr") & MASK160,
            gas_left=int(ctx.regs.GAS) % P,
        )
        tx.full_trace = self.config.generate_for(tx.tx_hash)
        self.call_depth = 1
        self.tx_count += 1
        self.current_tx = tx
        self.current_block.responses.append(tx)

    def on_finish_tx(self, ctx, values):
        tx = self.current_tx
        if tx is None:
            return
        tx.state_root = _fea(ctx.regs.SR)
        gas_now = int(ctx.regs.GAS) % P
        if tx.gas_left and gas_now <= tx.gas_left:
            tx.gas_used = tx.gas_left - gas_now
        self.current_block.gas_used += tx.gas_used
        self.batch.gas_used += tx.gas_used
        self.current_tx = None

    def on_finish_block(self, ctx, values):
        blk = self.current_block
        if blk is None:
            return
        blk.block_hash = self._mem_var(ctx, "blockHash")
        blk.parent_hash = self._mem_var(ctx, "previousBlockHash")
        self.current_block = None

    def on_finish_batch(self, ctx, values):
        self.batch.new_state_root = self._mem_var(ctx, "batchSR") or \
            _fea(ctx.regs.SR)
        self.batch.new_acc_input_hash = self._mem_var(ctx,
                                                      "newAccInputHash")
        self.batch.new_local_exit_root = self._mem_var(ctx,
                                                       "newLocalExitRoot")
        self.batch.new_batch_num = self._mem_var(ctx, "newNumBatch")

    def on_error(self, ctx, values, name: str = ""):
        err = name or "romError"
        if err in INVALID_BATCH_ERRORS and (
                self.current_block is None
                or not self.current_block.responses):
            self.batch.invalid_batch = True
            self.batch.error = err
        elif self.current_tx is not None:
            self.current_tx.error = err
            if self.current_tx.steps:
                self.current_tx.steps[-1].error = err
        elif self.current_block is not None:
            self.current_block.error = err
        else:
            self.batch.error = self.batch.error or err

    def on_update_storage(self, ctx, values):
        if self.current_tx is not None and len(values) >= 2:
            self.current_tx.storage[int(values[0])] = int(values[1])

    def on_opcode(self, ctx, values):
        tx = self.current_tx
        if tx is None:
            return
        tx.opcodes += 1
        if not tx.full_trace:
            return
        # per-opcode record (full_tracer.cpp onOpcode; TransactionStepV2)
        op = int(values[0]) if values else 0
        step = OpcodeStep(
            op=op,
            pc=self._mem_var(ctx, "lastPC"),
            gas=int(ctx.regs.GAS) % P,
            gas_refund=self._mem_var(ctx, "gasRefund"),
            depth=self.call_depth,
            state_root=_fea(ctx.regs.SR),
        )
        if tx.steps:
            prev = tx.steps[-1]
            if prev.gas >= step.gas:
                prev.gas_cost = prev.gas - step.gas
        if not self.config.disable_stack:
            step.stack = self._stack_snapshot(ctx)
        if self.config.enable_memory:
            step.memory, step.memory_size = self._memory_snapshot(ctx)
        if not self.config.disable_storage:
            step.storage = dict(tx.storage)
        tx.steps.append(step)
        if op in self._CALL_OPS:
            self.call_depth += 1
        elif op in self._RET_OPS and self.call_depth > 1:
            self.call_depth -= 1

    def _stack_snapshot(self, ctx) -> List[int]:
        """EVM stack words: the isStack region of the current context up
        to SP (main_executor.cpp address spaces)."""
        base = int(ctx.regs.CTX) * self.CTX_OFFSET + self.STACK_OFFSET
        sp = int(ctx.regs.SP)
        return [_fea(ctx.mem.get(base + i, [0] * 8))
                for i in range(min(sp, 1024))]

    def _memory_snapshot(self, ctx):
        """EVM memory bytes: the isMem region, memLength 32-byte words."""
        n_words = self._mem_var(ctx, "memLength")
        n_words = min(int(n_words), 1 << 16)
        base = int(ctx.regs.CTX) * self.CTX_OFFSET + self.MEM_OFFSET
        out = b"".join(
            _fea(ctx.mem.get(base + i, [0] * 8)).to_bytes(32, "big")
            for i in range(n_words))
        return out, 32 * n_words

    def on_store_log(self, ctx, index: int, is_topic: int, data: int):
        """LOG0..4 collection (full_tracer.cpp onStoreLog)."""
        tx = self.current_tx
        if tx is None:
            return
        while len(tx.logs) <= 0 or tx.logs[-1].index != index:
            if tx.logs and tx.logs[-1].index == index:
                break
            tx.logs.append(LogEntry(index=index, tx_index=tx.tx_index,
                                    block_number=(
                                        self.current_block.block_number
                                        if self.current_block else 0)))
            break
        entry = tx.logs[-1]
        if is_topic:
            entry.topics.append(int(data))
        else:
            entry.data += int(data).to_bytes(32, "big")
        entry.address = self._mem_var(ctx, "storageAddr") & MASK160


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    s = "".join(out)
    return s[3:] if s.startswith("on_") else s.lstrip("_")
