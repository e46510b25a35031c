"""Executor gRPC service: the sequencer's ProcessBatch fast path.

The port's own copy of ``xlayer_prover_tpu/services/executor_service.py``.
Wire-compatible with the reference ExecutorService
(src/grpc/proto/executor.proto; impl src/service/executor/
executor_service.cpp): ProcessBatchV2 runs the Main SM without trace
expansion on the caller's gRPC thread (concurrent batches — the reference
explicitly does NOT queue these, SURVEY §3.3) and returns the new state
root + resource counters; GetFlushStatus reports state write-back progress.

The EVM semantics come from the configured ROM + function registry; batches
beyond the implemented command surface return an executor error rather than
wrong results.  It runs on the host alone: no kernel is on this path.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import grpc
from google.protobuf import empty_pb2

from ..executor.executor import Executor
from ..executor.main_sm import scalar_to_fea
from ..state.hashdb import HashDB
from ..utils.log import zklog
from ..utils.zkresult import ZkError, ZkResult
from .gen import executor_pb2 as pb

SERVICE = "executor.v1.ExecutorService"

# zkresult -> wire error (reference executor_service.cpp zkresult2error):
# OOC conditions surface as the specific COUNTERS_OVERFLOW codes so the
# sequencer can split the batch instead of treating it as a hard failure
_ZK_TO_EXECUTOR_ERROR = {
    ZkResult.OUT_OF_COUNTERS_STEP:
        pb.EXECUTOR_ERROR_SM_MAIN_COUNTERS_OVERFLOW_STEPS,
    ZkResult.OUT_OF_COUNTERS_KECCAK:
        pb.EXECUTOR_ERROR_SM_MAIN_COUNTERS_OVERFLOW_KECCAK,
    ZkResult.OUT_OF_COUNTERS_BINARY:
        pb.EXECUTOR_ERROR_SM_MAIN_COUNTERS_OVERFLOW_BINARY,
    ZkResult.OUT_OF_COUNTERS_MEM:
        pb.EXECUTOR_ERROR_SM_MAIN_COUNTERS_OVERFLOW_MEM,
    ZkResult.OUT_OF_COUNTERS_ARITH:
        pb.EXECUTOR_ERROR_SM_MAIN_COUNTERS_OVERFLOW_ARITH,
    ZkResult.OUT_OF_COUNTERS_PADDING:
        pb.EXECUTOR_ERROR_SM_MAIN_COUNTERS_OVERFLOW_PADDING,
    ZkResult.OUT_OF_COUNTERS_POSEIDON:
        pb.EXECUTOR_ERROR_SM_MAIN_COUNTERS_OVERFLOW_POSEIDON,
}


def _executor_error_of(e: ZkError):
    return _ZK_TO_EXECUTOR_ERROR.get(e.code, pb.EXECUTOR_ERROR_UNSPECIFIED)


def _setup_registers(ctx):
    """The initial register file from the request's input vars, as
    ``BatchInput.setup_registers`` sets it for a proof
    (main_executor.cpp:5700-5715).  The JAX package's service leaves the
    registers at zero, so the fork ROMs' start checks fail every real
    batch there (ROADMAP queue 3); the port sets them."""
    iv = ctx.input_vars
    ctx.regs.B = scalar_to_fea(int(iv.get("oldStateRoot", 0)))
    ctx.regs.C = scalar_to_fea(int(iv.get("oldAccInputHash", 0)))
    ctx.regs.SP = int(iv.get("oldBatchNum", 0))
    ctx.regs.GAS = int(iv.get("chainID", 0))
    ctx.regs.CTX = int(iv.get("forkID", 0))
    ctx.regs.SR = scalar_to_fea(int(iv.get("oldStateRoot", 0)))


class ExecutorServiceImpl:
    def __init__(self, executor: Executor, hashdb: HashDB):
        self.executor = executor
        self.hashdb = hashdb
        self.stored_flush_id = 0
        self.flushes = 0

    # -- RPC handlers ---------------------------------------------------
    def _input_vars_from_request(self, request) -> dict:
        """Honor the request envelope (the reference maps proto -> Input,
        executor_service.cpp:60-120)."""
        return {
            "oldStateRoot": int.from_bytes(request.old_state_root, "big"),
            "oldAccInputHash": int.from_bytes(request.old_acc_input_hash,
                                              "big"),
            "batchL2Data": request.batch_l2_data.hex(),
            "sequencerAddr": int(request.coinbase, 16)
            if request.coinbase else 0,
            "timestampLimit": request.timestamp_limit,
            "l1InfoRoot": int.from_bytes(request.l1_info_root, "big"),
            "forcedBlockHashL1": int.from_bytes(request.forced_blockhash_l1,
                                                "big"),
            "chainID": request.chain_id,
            "forkID": request.fork_id,
            "oldBatchNum": request.old_batch_num,
        }

    MAX_BATCH_L2_DATA_SIZE = 120000      # reference input.hpp:19

    def process_batch_v2(self, request, context):
        resp = pb.ProcessBatchResponseV2()
        uuid = request.context_id or f"pb-{id(request):x}-{self.flushes}"
        if len(request.batch_l2_data) > self.MAX_BATCH_L2_DATA_SIZE:
            resp.error = pb.EXECUTOR_ERROR_INVALID_BATCH_L2_DATA
            return resp
        try:
            from ..executor.forks import CURRENT_FORK, ForkRegistry
            from ..executor.full_tracer import FullTracer
            from ..executor.main_sm import Context as ExCtx
            input_vars = self._input_vars_from_request(request)
            fork_id = request.fork_id or CURRENT_FORK
            if fork_id == CURRENT_FORK:
                rom, main = self.executor.rom, self.executor.main
            else:
                # fork dispatch (reference executor.cpp:23-377): one
                # table-driven interpreter, per-fork ROM bundles
                if getattr(self, "_forks", None) is None:
                    self._forks = ForkRegistry()
                main = self._forks.executor(fork_id)
                if main is None:
                    resp.error = pb.EXECUTOR_ERROR_UNSUPPORTED_FORK_ID
                    return resp
                rom = main.rom
            ctx = ExCtx(rom, self.hashdb, uuid, input_vars)
            _setup_registers(ctx)
            ctx.full_tracer = FullTracer(rom,
                                         trace_config=_trace_config(request))
            main.execute(ctx, self.executor.start_label,
                         self.executor.stop_label)
            new_root = 0
            for i, limb in enumerate(ctx.regs.SR):
                new_root |= int(limb) << (32 * i)
            resp.new_state_root = new_root.to_bytes(32, "big")
            resp.cnt_keccak_hashes = ctx.counters.keccak_f
            resp.cnt_poseidon_hashes = ctx.counters.poseidon_g
            resp.cnt_poseidon_paddings = ctx.counters.padding_pg
            resp.cnt_sha256_hashes = ctx.counters.sha256_f
            resp.cnt_arithmetics = ctx.counters.arith
            resp.cnt_binaries = ctx.counters.binary
            resp.cnt_steps = ctx.counters.steps
            resp.cnt_mem_aligns = ctx.counters.mem_align
            resp.fork_id = fork_id
            self._fill_trace(resp, ctx)
            resp.error = pb.EXECUTOR_ERROR_NO_ERROR
            fid = self.hashdb.consolidate(uuid)
            if isinstance(fid, tuple):
                # CachedDB MultiWrite: real write-behind flush generations
                st = self.hashdb.db.flush_status()
                self.flushes = fid[0]
                self.stored_flush_id = st["stored_flush_id"]
                resp.flush_id = fid[0]
                resp.stored_flush_id = st["stored_flush_id"]
            else:
                self.flushes += 1
                resp.flush_id = self.flushes
                resp.stored_flush_id = self.stored_flush_id
                self.stored_flush_id = self.flushes
        except ZkError as e:
            zklog.error(f"executor service: {e}")
            self.hashdb.discard(uuid)
            resp.error = _executor_error_of(e)
        except Exception as e:  # noqa: BLE001
            zklog.error(f"executor service: {e}")
            self.hashdb.discard(uuid)
            resp.error = pb.EXECUTOR_ERROR_UNSPECIFIED
        return resp

    @staticmethod
    def _fill_full_trace(t, tx):
        """Per-opcode steps -> FullTraceV2 (executor.proto:418-493)."""
        ft = t.full_trace
        ft.gas_used = tx.gas_used
        ft.old_state_root = (tx.steps[0].state_root if tx.steps else
                             0).to_bytes(32, "big")
        ft.tx_index = tx.tx_index
        for step in tx.steps:
            s = ft.steps.add()
            s.state_root = step.state_root.to_bytes(32, "big")
            s.depth = step.depth
            s.pc = step.pc
            s.gas = step.gas
            s.gas_cost = step.gas_cost
            s.gas_refund = step.gas_refund
            s.op = step.op
            for w in step.stack:
                s.stack.append(hex(w))
            if step.memory:
                s.memory = step.memory
                s.memory_size = step.memory_size
            for k, v in step.storage.items():
                s.storage[f"{k:064x}"] = f"{v:064x}"
            s.error = _rom_error_code(step.error)

    @staticmethod
    def _fill_trace(resp, ctx):
        """FullTracer -> ProcessBatchResponseV2 block/tx/log structures
        (executor.proto:331-573)."""
        tracer = ctx.full_tracer
        if tracer is None:
            return
        batch = tracer.batch
        resp.gas_used = batch.gas_used
        resp.invalid_batch = int(batch.invalid_batch)
        for blk in batch.blocks:
            b = resp.block_responses.add()
            b.block_number = blk.block_number
            b.timestamp = blk.timestamp
            b.coinbase = f"0x{blk.coinbase:040x}"
            b.gas_used = blk.gas_used
            b.parent_hash = blk.parent_hash.to_bytes(32, "big")
            b.block_hash = blk.block_hash.to_bytes(32, "big")
            b.error = _rom_error_code(blk.error)
            for tx in blk.responses:
                t = b.responses.add()
                t.tx_hash = tx.tx_hash.to_bytes(32, "big")
                t.tx_hash_l2 = tx.tx_hash_l2.to_bytes(32, "big")
                t.block_number = blk.block_number
                t.gas_left = tx.gas_left
                t.gas_used = tx.gas_used
                t.state_root = tx.state_root.to_bytes(32, "big")
                t.error = _rom_error_code(tx.error)
                for lg in tx.logs:
                    l = t.logs.add()
                    l.address = f"0x{lg.address:040x}"
                    for topic in lg.topics:
                        l.topics.append(int(topic).to_bytes(32, "big"))
                    l.data = lg.data
                    l.index = lg.index
                    l.tx_index = lg.tx_index
                    l.block_number = lg.block_number
                if tx.full_trace and tx.steps:
                    ExecutorServiceImpl._fill_full_trace(t, tx)

    def process_stateless_batch_v2(self, request, context):
        """ProcessStatelessBatchV2 (executor.proto:13): rebuild the state
        from the Erigon witness blob, decode the datastream into
        batchL2Data, then run the standard path."""
        resp = pb.ProcessBatchResponseV2()
        uuid = request.context_id or f"sb-{id(request):x}"
        try:
            from ..state.witness import witness2db
            from ..state.datastream import batch_to_l2_data, datastream2batch
            from ..executor.full_tracer import FullTracer
            from ..executor.main_sm import Context as ExCtx
            wres = witness2db(request.witness)
            for key, vals in wres.db.items():
                self.hashdb.db.write(key, vals)
            for key, code in wres.programs.items():
                self.hashdb.db.set_program(key, code)
            batch = datastream2batch(request.data_stream)
            l2_data = batch_to_l2_data(batch)
            if len(l2_data) > self.MAX_BATCH_L2_DATA_SIZE:
                resp.error = pb.EXECUTOR_ERROR_INVALID_BATCH_L2_DATA
                return resp
            input_vars = {
                "oldStateRoot": wres.state_root,
                "chainID": batch.chain_id,
                "forkID": batch.fork_id,
                "batchL2Data": l2_data.hex(),
                "sequencerAddr": int(request.coinbase, 16)
                if request.coinbase else 0,
                "timestampLimit": request.timestamp_limit,
                "l1InfoRoot": int.from_bytes(request.l1_info_root, "big"),
                "forcedBlockHashL1": int.from_bytes(
                    request.forced_blockhash_l1, "big"),
                "oldAccInputHash": int.from_bytes(
                    request.old_acc_input_hash, "big"),
            }
            ctx = ExCtx(self.executor.rom, self.hashdb, uuid, input_vars)
            _setup_registers(ctx)
            ctx.full_tracer = FullTracer(self.executor.rom)
            self.executor.main.execute(ctx, self.executor.start_label,
                                       self.executor.stop_label)
            new_root = 0
            for i, limb in enumerate(ctx.regs.SR):
                new_root |= int(limb) << (32 * i)
            resp.new_state_root = new_root.to_bytes(32, "big")
            resp.cnt_steps = ctx.counters.steps
            resp.fork_id = batch.fork_id
            self._fill_trace(resp, ctx)
            resp.error = pb.EXECUTOR_ERROR_NO_ERROR
        except ZkError as e:
            zklog.error(f"executor stateless: {e}")
            self.hashdb.discard(uuid)
            resp.error = _executor_error_of(e)
        except Exception as e:  # noqa: BLE001
            zklog.error(f"executor stateless: {e}")
            self.hashdb.discard(uuid)
            resp.error = pb.EXECUTOR_ERROR_UNSPECIFIED
        return resp

    def get_flush_status(self, request, context):
        resp = pb.GetFlushStatusResponse()
        if hasattr(self.hashdb.db, "flush_status"):
            st = self.hashdb.db.flush_status()
            resp.stored_flush_id = st["stored_flush_id"]
            resp.storing_flush_id = st["storing_flush_id"]
            resp.last_flush_id = st["last_flush_id"]
            resp.pending_to_flush_nodes = st["pending_nodes"]
            resp.pending_to_flush_program = st["pending_programs"]
        else:
            resp.stored_flush_id = self.stored_flush_id
            resp.last_flush_id = self.flushes
            resp.pending_to_flush_nodes = 0
            resp.pending_to_flush_program = 0
        return resp


_ROM_ERRORS = {
    "": pb.ROM_ERROR_NO_ERROR,
    "romError": pb.ROM_ERROR_UNSPECIFIED,
    "OOG": pb.ROM_ERROR_OUT_OF_GAS,
    "invalidRLP": pb.ROM_ERROR_INVALID_RLP,
    "invalidDecodeChangeL2Block": pb.ROM_ERROR_INVALID_DECODE_CHANGE_L2_BLOCK,
    "invalidNotFirstTxChangeL2Block":
        pb.ROM_ERROR_INVALID_NOT_FIRST_TX_CHANGE_L2_BLOCK,
    "invalidIntrinsicTxSignature": pb.ROM_ERROR_INTRINSIC_INVALID_SIGNATURE,
    "invalidIntrinsicTxChainId": pb.ROM_ERROR_INTRINSIC_INVALID_CHAIN_ID,
    "invalidIntrinsicTxNonce": pb.ROM_ERROR_INTRINSIC_INVALID_NONCE,
    "invalidIntrinsicTxGasLimit": pb.ROM_ERROR_INTRINSIC_INVALID_GAS_LIMIT,
    "invalidIntrinsicTxBalance": pb.ROM_ERROR_INTRINSIC_INVALID_BALANCE,
    "invalidIntrinsicTxGasOverflow": pb.ROM_ERROR_INTRINSIC_TX_GAS_OVERFLOW,
    "invalidIntrinsicTxSenderCode": pb.ROM_ERROR_INTRINSIC_INVALID_SENDER_CODE,
    "invalidJump": pb.ROM_ERROR_INVALID_JUMP,
    "invalidOpcode": pb.ROM_ERROR_INVALID_OPCODE,
    "invalidStaticTx": pb.ROM_ERROR_INVALID_STATIC,
    "revert": pb.ROM_ERROR_EXECUTION_REVERTED,
    "overflowStack": pb.ROM_ERROR_STACK_OVERFLOW,
    "underflowStack": pb.ROM_ERROR_STACK_UNDERFLOW,
}


def _rom_error_code(name: str) -> int:
    return _ROM_ERRORS.get(name, pb.ROM_ERROR_UNSPECIFIED
                           if name else pb.ROM_ERROR_NO_ERROR)


def _trace_config(request):
    """Proto TraceConfigV2 -> executor TraceConfig (absence = disabled:
    the reference only collects opcode traces when the request asks,
    executor_service.cpp TraceConfig mapping)."""
    from ..executor.full_tracer import TraceConfig
    if not request.HasField("trace_config"):
        return TraceConfig()
    tc = request.trace_config
    return TraceConfig(
        enabled=True,
        disable_storage=bool(tc.disable_storage),
        disable_stack=bool(tc.disable_stack),
        enable_memory=bool(tc.enable_memory),
        enable_return_data=bool(tc.enable_return_data),
        tx_hash_to_generate_full_trace=int.from_bytes(
            tc.tx_hash_to_generate_full_trace, "big"))


class ExecutorServer:
    """gRPC server wrapper (hand-registered method handlers)."""

    def __init__(self, impl: ExecutorServiceImpl, port: int = 0):
        self.impl = impl
        self._server = grpc.server(ThreadPoolExecutor(max_workers=8))
        handlers = {
            "ProcessBatchV2": grpc.unary_unary_rpc_method_handler(
                impl.process_batch_v2,
                request_deserializer=pb.ProcessBatchRequestV2.FromString,
                response_serializer=pb.ProcessBatchResponseV2.SerializeToString,
            ),
            "ProcessStatelessBatchV2": grpc.unary_unary_rpc_method_handler(
                impl.process_stateless_batch_v2,
                request_deserializer=
                pb.ProcessStatelessBatchRequestV2.FromString,
                response_serializer=
                pb.ProcessBatchResponseV2.SerializeToString,
            ),
            "GetFlushStatus": grpc.unary_unary_rpc_method_handler(
                impl.get_flush_status,
                request_deserializer=empty_pb2.Empty.FromString,
                response_serializer=pb.GetFlushStatusResponse.SerializeToString,
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    def start(self):
        self._server.start()
        return self

    def stop(self):
        self._server.stop(1.0)


def make_client(port: int):
    """Returns (process_batch_v2, get_flush_status) callables."""
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    pb_call = channel.unary_unary(
        f"/{SERVICE}/ProcessBatchV2",
        request_serializer=pb.ProcessBatchRequestV2.SerializeToString,
        response_deserializer=pb.ProcessBatchResponseV2.FromString)
    fs_call = channel.unary_unary(
        f"/{SERVICE}/GetFlushStatus",
        request_serializer=empty_pb2.Empty.SerializeToString,
        response_deserializer=pb.GetFlushStatusResponse.FromString)
    sb_call = channel.unary_unary(
        f"/{SERVICE}/ProcessStatelessBatchV2",
        request_serializer=pb.ProcessStatelessBatchRequestV2.SerializeToString,
        response_deserializer=pb.ProcessBatchResponseV2.FromString)
    return pb_call, fs_call, sb_call
