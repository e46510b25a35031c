"""HashDB gRPC service + remote client.

The port's own copy of ``xlayer_prover_tpu/services/hashdb_service.py``.
Wire-compatible with the reference HashDBService (src/grpc/proto/
hashdb.proto; server impl src/service/hashdb/hashdb_service.cpp, remote
client hashdb_remote.hpp): Set/Get with full SMT result details,
program (bytecode) storage, LoadDB/LoadProgramDB bulk import, the flush
protocol, batch consolidate/purge/cancel.  ``HashDBRemote`` implements the
same call surface as state/hashdb.HashDB so the executor can run against a
remote state service — the reference's hashDBURL != "local" mode
(hashdb_factory.cpp:11-31).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import grpc
from google.protobuf import empty_pb2

from ..state.hashdb import HashDB
from ..state.smt import SmtSetResult, SmtGetResult
from ..utils.log import zklog
from .gen import hashdb_pb2 as pb

SERVICE = "hashdb.v1.HashDBService"


def _fea(msg) -> tuple:
    return (msg.fe0, msg.fe1, msg.fe2, msg.fe3)


def _set_fea(msg, quad):
    msg.fe0, msg.fe1, msg.fe2, msg.fe3 = [int(v) for v in quad]


def _scalar_bytes(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def _hexkey(quad) -> str:
    """Node-hash quad -> 64-hex key (the LoadDB/input.db key convention:
    limb j occupies bits [64j, 64j+64))."""
    v = 0
    for j, limb in enumerate(quad):
        v |= int(limb) << (64 * j)
    return f"{v:064x}"


def _hexnode(limbs) -> str:
    """Node limbs -> concatenated 16-hex-char limbs (the reference's DB
    string encoding of a 12-element node)."""
    return "".join(f"{int(x):016x}" for x in limbs)


class HashDBServiceImpl:
    def __init__(self, hashdb: Optional[HashDB] = None):
        self.hashdb = hashdb or HashDB()
        self.flush_id = 0
        self.stored_flush_id = 0

    # -- RPC handlers ---------------------------------------------------
    def set(self, request, context):
        resp = pb.SetResponse()
        try:
            res: SmtSetResult = self.hashdb.set(
                request.batch_uuid or None, _fea(request.old_root),
                _fea(request.key),
                int(request.value, 16))
            _set_fea(resp.old_root, res.old_root)
            _set_fea(resp.new_root, res.new_root)
            _set_fea(resp.key, _fea(request.key))
            resp.mode = getattr(res, "mode", "")
            resp.result.code = pb.ResultCode.CODE_SUCCESS
        except Exception as e:  # noqa: BLE001
            zklog.error(f"hashdb.set: {e}")
            resp.result.code = pb.ResultCode.CODE_INTERNAL_ERROR
        return resp

    def get(self, request, context):
        resp = pb.GetResponse()
        try:
            res: SmtGetResult = self.hashdb.get(
                request.batch_uuid or None, _fea(request.root),
                _fea(request.key))
            _set_fea(resp.root, _fea(request.root))
            _set_fea(resp.key, _fea(request.key))
            resp.value = f"{res.value:064x}"
            resp.result.code = pb.ResultCode.CODE_SUCCESS
        except Exception as e:  # noqa: BLE001
            zklog.error(f"hashdb.get: {e}")
            resp.result.code = pb.ResultCode.CODE_INTERNAL_ERROR
        return resp

    def set_program(self, request, context):
        resp = pb.SetProgramResponse()
        try:
            self.hashdb.set_program(request.batch_uuid or None,
                                    _fea(request.key), request.data)
            resp.result.code = pb.ResultCode.CODE_SUCCESS
        except Exception as e:  # noqa: BLE001
            zklog.error(f"hashdb.setProgram: {e}")
            resp.result.code = pb.ResultCode.CODE_INTERNAL_ERROR
        return resp

    def get_program(self, request, context):
        resp = pb.GetProgramResponse()
        try:
            data = self.hashdb.get_program(request.batch_uuid or None,
                                           _fea(request.key))
            if data is None:
                resp.result.code = \
                    pb.ResultCode.CODE_DB_KEY_NOT_FOUND
            else:
                resp.data = data
                resp.result.code = pb.ResultCode.CODE_SUCCESS
        except Exception as e:  # noqa: BLE001
            zklog.error(f"hashdb.getProgram: {e}")
            resp.result.code = pb.ResultCode.CODE_INTERNAL_ERROR
        return resp

    def load_db(self, request, context):
        for key_str, fe_list in request.input_db.items():
            key = tuple((int(key_str, 16) >> (64 * j)) & ((1 << 64) - 1)
                        for j in range(4))
            self.hashdb.db.write(key, [int(v) for v in fe_list.fe])
        return empty_pb2.Empty()

    def load_program_db(self, request, context):
        for key_str, data in request.input_program_db.items():
            key = tuple((int(key_str, 16) >> (64 * j)) & ((1 << 64) - 1)
                        for j in range(4))
            self.hashdb.db.set_program(key, data)
        return empty_pb2.Empty()

    def flush(self, request, context):
        resp = pb.FlushResponse()
        if request.batch_uuid:
            try:
                self.hashdb.consolidate(request.batch_uuid)
            except KeyError:
                pass
        self.flush_id += 1
        self.stored_flush_id = self.flush_id
        resp.flush_id = self.flush_id
        resp.stored_flush_id = self.stored_flush_id
        resp.result.code = pb.ResultCode.CODE_SUCCESS
        return resp

    def get_flush_status(self, request, context):
        resp = pb.GetFlushStatusResponse()
        resp.stored_flush_id = self.stored_flush_id
        resp.last_flush_id = self.flush_id
        return resp

    def consolidate_state(self, request, context):
        resp = pb.ConsolidateStateResponse()
        vroot = _fea(request.virtual_state_root)
        # hashdb64 backend: resolve a virtual root to its consolidated
        # real root (state_manager_64 consolidateState); the classic
        # backend has no virtual roots and echoes.
        resolve = getattr(self.hashdb, "consolidate_virtual", None)
        if resolve is None:
            # classic backend has no virtual roots: echo is the contract
            _set_fea(resp.consolidated_state_root, vroot)
            resp.result.code = pb.ResultCode.CODE_SUCCESS
            return resp
        real = resolve(vroot)
        if real is None:
            # unknown / already-consolidated virtual root: do NOT launder
            # the virtual root back as a real one
            _set_fea(resp.consolidated_state_root, (0, 0, 0, 0))
            resp.result.code = pb.ResultCode.CODE_DB_KEY_NOT_FOUND
            return resp
        _set_fea(resp.consolidated_state_root, real)
        resp.result.code = pb.ResultCode.CODE_SUCCESS
        return resp

    def get_latest_state_root(self, request, context):
        resp = pb.GetLatestStateRootResponse()
        root = getattr(self.hashdb, "get_latest_state_root",
                       lambda: (0, 0, 0, 0))()
        _set_fea(resp.latest_root, root)
        resp.result.code = pb.ResultCode.CODE_SUCCESS
        return resp

    def start_block(self, request, context):
        fn = getattr(self.hashdb, "start_block", None)
        if fn is not None:
            fn(request.batch_uuid, request.old_state_root,
               request.persistence)
        return empty_pb2.Empty()

    def finish_block(self, request, context):
        fn = getattr(self.hashdb, "finish_block", None)
        if fn is not None:
            fn(request.batch_uuid, request.new_state_root,
               request.persistence)
        return empty_pb2.Empty()

    def finish_tx(self, request, context):
        fn = getattr(self.hashdb, "finish_tx", None)
        if fn is not None:
            fn(request.batch_uuid, request.new_state_root,
               request.persistence)
        return empty_pb2.Empty()

    def get_flush_data(self, request, context):
        resp = pb.GetFlushDataResponse()
        try:
            stored, nodes, programs = self.hashdb.get_flush_data(
                request.flush_id)
            resp.stored_flush_id = stored
            for k, v in nodes.items():
                resp.nodes[_hexkey(k)] = _hexnode(v)
            for k, v in programs.items():
                resp.program[_hexkey(k)] = bytes(v).hex()
            resp.result.code = pb.ResultCode.CODE_SUCCESS
        except Exception as e:  # noqa: BLE001
            zklog.error(f"hashdb.getFlushData: {e}")
            resp.result.code = pb.ResultCode.CODE_INTERNAL_ERROR
        return resp

    def read_tree(self, request, context):
        resp = pb.ReadTreeResponse()
        try:
            keys = [_fea(k) for k in request.keys]
            key_values, hash_nodes = self.hashdb.read_tree(
                _fea(request.state_root), keys)
            for (key, value) in key_values:
                kv = resp.key_value.add()
                _set_fea(kv.key, key)
                kv.value = f"{value:x}"
            for h, node12 in hash_nodes.items():
                hv = resp.hash_value.add()
                _set_fea(hv.hash, h)
                (hv.value.fe0, hv.value.fe1, hv.value.fe2, hv.value.fe3,
                 hv.value.fe4, hv.value.fe5, hv.value.fe6, hv.value.fe7,
                 hv.value.fe8, hv.value.fe9, hv.value.fe10,
                 hv.value.fe11) = [int(v) for v in node12]
            resp.result.code = pb.ResultCode.CODE_SUCCESS
        except Exception as e:  # noqa: BLE001
            zklog.error(f"hashdb.readTree: {e}")
            resp.result.code = pb.ResultCode.CODE_INTERNAL_ERROR
        return resp

    def reset_db(self, request, context):
        resp = pb.ResetDBResponse()
        reset = getattr(self.hashdb, "reset", None)
        if reset is None:
            resp.result.code = pb.ResultCode.CODE_INTERNAL_ERROR
        else:
            reset()
            resp.result.code = pb.ResultCode.CODE_SUCCESS
        return resp

    def purge(self, request, context):
        resp = pb.PurgeResponse()
        if request.batch_uuid:
            self.hashdb.discard(request.batch_uuid)
        resp.result.code = pb.ResultCode.CODE_SUCCESS
        return resp

    def cancel_batch(self, request, context):
        resp = pb.CancelBatchResponse()
        if request.batch_uuid:
            self.hashdb.discard(request.batch_uuid)
        resp.result.code = pb.ResultCode.CODE_SUCCESS
        return resp


class HashDBServer:
    def __init__(self, impl: Optional[HashDBServiceImpl] = None,
                 port: int = 0):
        self.impl = impl or HashDBServiceImpl()
        self._server = grpc.server(ThreadPoolExecutor(max_workers=8))

        def h(fn, req_cls, resp_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)

        handlers = {
            "Set": h(self.impl.set, pb.SetRequest, pb.SetResponse),
            "Get": h(self.impl.get, pb.GetRequest, pb.GetResponse),
            "SetProgram": h(self.impl.set_program, pb.SetProgramRequest,
                            pb.SetProgramResponse),
            "GetProgram": h(self.impl.get_program, pb.GetProgramRequest,
                            pb.GetProgramResponse),
            "LoadDB": h(self.impl.load_db, pb.LoadDBRequest,
                        empty_pb2.Empty),
            "LoadProgramDB": h(self.impl.load_program_db,
                               pb.LoadProgramDBRequest, empty_pb2.Empty),
            "Flush": h(self.impl.flush, pb.FlushRequest, pb.FlushResponse),
            "GetFlushStatus": h(self.impl.get_flush_status, empty_pb2.Empty,
                                pb.GetFlushStatusResponse),
            "ConsolidateState": h(self.impl.consolidate_state,
                                  pb.ConsolidateStateRequest,
                                  pb.ConsolidateStateResponse),
            "Purge": h(self.impl.purge, pb.PurgeRequest, pb.PurgeResponse),
            "CancelBatch": h(self.impl.cancel_batch, pb.CancelBatchRequest,
                             pb.CancelBatchResponse),
            "GetLatestStateRoot": h(self.impl.get_latest_state_root,
                                    empty_pb2.Empty,
                                    pb.GetLatestStateRootResponse),
            "StartBlock": h(self.impl.start_block, pb.StartBlockRequest,
                            empty_pb2.Empty),
            "FinishBlock": h(self.impl.finish_block, pb.FinishBlockRequest,
                             empty_pb2.Empty),
            "FinishTx": h(self.impl.finish_tx, pb.FinishTxRequest,
                          empty_pb2.Empty),
            "GetFlushData": h(self.impl.get_flush_data,
                              pb.GetFlushDataRequest,
                              pb.GetFlushDataResponse),
            "ReadTree": h(self.impl.read_tree, pb.ReadTreeRequest,
                          pb.ReadTreeResponse),
            "ResetDB": h(self.impl.reset_db, empty_pb2.Empty,
                         pb.ResetDBResponse),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    def start(self):
        self._server.start()
        return self

    def stop(self):
        self._server.stop(1.0)


class HashDBRemote:
    """HashDB-compatible client over gRPC (reference hashdb_remote.hpp)."""

    def __init__(self, host: str, port: int):
        self._channel = grpc.insecure_channel(f"{host}:{port}")

        def call(name, req_cls, resp_cls):
            return self._channel.unary_unary(
                f"/{SERVICE}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)

        self._set = call("Set", pb.SetRequest, pb.SetResponse)
        self._get = call("Get", pb.GetRequest, pb.GetResponse)
        self._set_program = call("SetProgram", pb.SetProgramRequest,
                                 pb.SetProgramResponse)
        self._get_program = call("GetProgram", pb.GetProgramRequest,
                                 pb.GetProgramResponse)
        self._flush = call("Flush", pb.FlushRequest, pb.FlushResponse)
        self._purge = call("Purge", pb.PurgeRequest, pb.PurgeResponse)
        self._cancel = call("CancelBatch", pb.CancelBatchRequest,
                            pb.CancelBatchResponse)
        self._get_flush_data = call("GetFlushData", pb.GetFlushDataRequest,
                                    pb.GetFlushDataResponse)

    def set(self, batch_uuid, old_root, key, value):
        req = pb.SetRequest(batch_uuid=batch_uuid or "",
                            value=f"{int(value):x}")     # hex, like the
        # reference proto convention (hashdb.proto value strings)
        _set_fea(req.old_root, old_root)
        _set_fea(req.key, key)
        resp = self._set(req)
        if resp.result.code != pb.ResultCode.CODE_SUCCESS:
            raise RuntimeError("hashdb remote set failed")
        return SmtSetResult(old_root=_fea(resp.old_root),
                            new_root=_fea(resp.new_root), key=tuple(key),
                            siblings={}, ins_key=None, ins_value=0,
                            is_old0=False, old_value=0, new_value=int(value),
                            mode=resp.mode)

    def get(self, batch_uuid, root, key):
        req = pb.GetRequest(batch_uuid=batch_uuid or "")
        _set_fea(req.root, root)
        _set_fea(req.key, key)
        resp = self._get(req)
        if resp.result.code != pb.ResultCode.CODE_SUCCESS:
            raise RuntimeError("hashdb remote get failed")
        return SmtGetResult(root=tuple(root), key=tuple(key),
                            value=int(resp.value, 16), found=True,
                            siblings={}, ins_key=None, ins_value=0,
                            is_old0=False)

    def set_program(self, batch_uuid, key, data: bytes):
        req = pb.SetProgramRequest(batch_uuid=batch_uuid or "", data=data)
        _set_fea(req.key, key)
        self._set_program(req)

    def get_program(self, batch_uuid, key):
        req = pb.GetProgramRequest(batch_uuid=batch_uuid or "")
        _set_fea(req.key, key)
        resp = self._get_program(req)
        if resp.result.code == pb.ResultCode.CODE_DB_KEY_NOT_FOUND:
            return None
        return resp.data

    def consolidate(self, batch_uuid: str):
        self._flush(pb.FlushRequest(batch_uuid=batch_uuid))

    def get_flush_data(self, flush_id: int):
        """(stored_flush_id, nodes, programs) — the dbCacheSynchThread
        poll (reference HashDBRemote::getFlushData, hashdb_remote.cpp;
        consumed by database.cpp:1872-1966)."""
        resp = self._get_flush_data(pb.GetFlushDataRequest(
            flush_id=flush_id))
        if resp.result.code != pb.ResultCode.CODE_SUCCESS:
            raise RuntimeError("hashdb remote getFlushData failed")

        def unkey(hex64: str):
            v = int(hex64, 16)
            return tuple((v >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
                         for j in range(4))

        nodes = {unkey(k): [int(h[i * 16:(i + 1) * 16], 16)
                            for i in range(len(h) // 16)]
                 for k, h in resp.nodes.items()}
        programs = {unkey(k): bytes.fromhex(v)
                    for k, v in resp.program.items()}
        return resp.stored_flush_id, nodes, programs

    def discard(self, batch_uuid: str):
        self._purge(pb.PurgeRequest(batch_uuid=batch_uuid))
