"""Aggregator service: wire-compatible gRPC client + test-harness server.

The port's own copy of ``xlayer_prover_tpu/services/aggregator.py``.
Speaks the reference's AggregatorService protocol unchanged
(src/grpc/proto/aggregator.proto: one bidi ``Channel`` stream; the PROVER is
the gRPC *client*, the aggregator the server; every AggregatorMessage gets
a ProverMessage with the same id).  Mirrors the reference deployment shape:

  * ``AggregatorClient`` — the production path
    (src/service/aggregator/aggregator_client.cpp): connects out, serves
    GetStatus/GenBatchProof/GenAggregatedProof/GenFinalProof/Cancel/GetProof
    by driving a ProverService, reconnects forever on stream loss.
  * ``MockAggregatorServer`` — the reference's in-process test aggregator
    (test/service/aggregator/aggregator_server.cpp): drives the canonical
    e2e script (prove batches, aggregate pairwise, finalize) over localhost.

gRPC method descriptors are hand-registered (no grpc_tools codegen);
messages come from services/gen (protoc output of the reference protos,
byte-for-byte copies of the JAX package's).  The proofs are made by the
ProverService given, on its device; the stream's handlers run in gRPC's
threads and only queue, read or cancel requests.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid as uuid_mod
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import grpc

from ..prover_service import (ProverRequest, ProverService, RequestState,
                              RequestType)
from ..stark.proof import StarkProof
from ..utils.log import zklog
from .gen import aggregator_pb2 as pb

CHANNEL_METHOD = "/aggregator.v1.AggregatorService/Channel"


# ---------------------------------------------------------------------------
# Client (the prover side)
# ---------------------------------------------------------------------------

class AggregatorClient:
    def __init__(self, prover: ProverService, host: str, port: int,
                 prover_name: str = "tpu-prover", fork_id: int = 9,
                 input_decoder: Optional[Callable] = None,
                 watchdog_timeout_s: float = 0.0):
        self.prover = prover
        self.input_decoder = input_decoder
        self.target = f"{host}:{port}"
        self.prover_name = prover_name
        self.prover_id = str(uuid_mod.uuid4())
        self.fork_id = fork_id
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guard message processing like the reference (aggregator_client.cpp:5
        # wraps the stream handlers in a Watchdog); a wedged handler cancels
        # the in-flight proof and drops the stream for a clean reconnect
        self.watchdog_timeout_s = watchdog_timeout_s
        self._watchdog = None

    def start(self):
        self._thread = threading.Thread(target=self._run_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(3.0)

    def _run_forever(self):
        while not self._stop.is_set():
            try:
                self._run_stream()
            except grpc.RpcError as e:
                zklog.warning(f"aggregator stream lost: {e.code()}")
            if not self._stop.is_set():
                time.sleep(1.0)

    def _run_stream(self):
        channel = grpc.insecure_channel(self.target)
        stub = channel.stream_stream(
            CHANNEL_METHOD,
            request_serializer=pb.ProverMessage.SerializeToString,
            response_deserializer=pb.AggregatorMessage.FromString,
        )
        outbox: "queue.Queue" = queue.Queue()

        def request_iter():
            while not self._stop.is_set():
                try:
                    msg = outbox.get(timeout=0.25)
                except queue.Empty:
                    continue
                if msg is None:
                    return
                yield msg

        responses = stub(request_iter())
        if self.watchdog_timeout_s > 0:
            from ..utils.watchdog import Watchdog
            self._watchdog = Watchdog(
                self.watchdog_timeout_s,
                on_timeout=lambda: channel.close(),
                name=f"aggregator-client[{self.prover_name}]").start()
        try:
            for agg_msg in responses:
                if self._watchdog is not None:
                    self._watchdog.feed()
                reply = self._handle(agg_msg)
                if self._watchdog is not None:
                    self._watchdog.feed()
                outbox.put(reply)
                if self._stop.is_set():
                    outbox.put(None)
                    break
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None

    # -- message handling ----------------------------------------------
    def _handle(self, msg) -> "pb.ProverMessage":
        which = msg.WhichOneof("request")
        out = pb.ProverMessage(id=msg.id)
        if which == "get_status_request":
            out.get_status_response.CopyFrom(self._status())
        elif which == "gen_batch_proof_request":
            out.gen_batch_proof_response.CopyFrom(
                self._gen_batch(msg.gen_batch_proof_request))
        elif which == "gen_stateless_batch_proof_request":
            out.gen_batch_proof_response.CopyFrom(
                self._gen_stateless_batch(
                    msg.gen_stateless_batch_proof_request))
        elif which == "gen_aggregated_proof_request":
            out.gen_aggregated_proof_response.CopyFrom(
                self._gen_aggregated(msg.gen_aggregated_proof_request))
        elif which == "gen_final_proof_request":
            out.gen_final_proof_response.CopyFrom(
                self._gen_final(msg.gen_final_proof_request))
        elif which == "cancel_request":
            ok = self.prover.cancel(msg.cancel_request.id)
            out.cancel_response.result = pb.RESULT_OK if ok else \
                pb.RESULT_ERROR
        elif which == "get_proof_request":
            out.get_proof_response.CopyFrom(
                self._get_proof(msg.get_proof_request))
        else:
            zklog.warning(f"aggregator: unknown request {which}")
        return out

    def _status(self):
        return pb.GetStatusResponse(
            status=pb.GetStatusResponse.STATUS_IDLE
            if self.prover.queue_depth() == 0
            else pb.GetStatusResponse.STATUS_COMPUTING,
            prover_name=self.prover_name,
            prover_id=self.prover_id,
            version_proto="v0_0_1",
            version_server="xlayer-prover-tpu-0.1",
            fork_id=self.fork_id,
        )

    def _gen_batch(self, req):
        # The InputProver payload carries the batch (publics + L2 data);
        # input_decoder turns it into the prover payload (trace + publics) —
        # the zkEVM executor slots in here as it matures.
        payload = {"circuit": "batch"}
        if self.input_decoder is not None:
            payload.update(self.input_decoder(req.input) or {})
        preq = ProverRequest(RequestType.GEN_BATCH_PROOF, payload)
        uid = self.prover.submit(preq)
        return pb.GenBatchProofResponse(id=uid, result=pb.RESULT_OK)

    def _gen_stateless_batch(self, req):
        """GenStatelessBatchProof (reference aggregator_client.cpp:377-448):
        rebuild the pre-state node map from the Erigon witness blob
        (witness2db), decode the sequencer datastream into batchL2Data
        (dataStream2batch), then submit a standard batch-proof job; the
        reply rides gen_batch_proof_response exactly like the reference."""
        from ..executor.input import BatchInput
        from ..state.datastream import batch_to_l2_data, datastream2batch
        from ..state.witness import witness2db
        from .executor_service import ExecutorServiceImpl
        pi = req.input.public_inputs
        try:
            if not pi.witness:
                raise ValueError("empty witness")
            wres = witness2db(pi.witness)
            if not pi.data_stream:
                raise ValueError("empty data stream")
            batch = datastream2batch(pi.data_stream)
            if not batch.blocks:
                raise ValueError("datastream has zero blocks")
            l2_data = batch_to_l2_data(batch)
            if len(l2_data) > ExecutorServiceImpl.MAX_BATCH_L2_DATA_SIZE:
                raise ValueError(
                    f"batchL2Data {len(l2_data)} > "
                    f"{ExecutorServiceImpl.MAX_BATCH_L2_DATA_SIZE}")
            seq = pi.sequencer_addr
            inp = BatchInput(
                old_state_root=wres.state_root,
                chain_id=batch.chain_id,
                fork_id=batch.fork_id or self.fork_id,
                batch_l2_data=l2_data,
                sequencer_addr=int(seq, 16) if seq else 0,
                timestamp_limit=pi.timestamp_limit,
                l1_info_root=int.from_bytes(pi.l1_info_root, "big"),
                forced_blockhash_l1=int.from_bytes(pi.forced_blockhash_l1,
                                                   "big"),
                old_acc_input_hash=int.from_bytes(pi.old_acc_input_hash,
                                                  "big"),
                db_raw=dict(wres.db),
                programs_raw=dict(wres.programs))
        except Exception as e:  # noqa: BLE001 - wire boundary
            zklog.error(f"aggregator GenStatelessBatchProof: {e}")
            return pb.GenBatchProofResponse(result=pb.RESULT_ERROR)
        preq = ProverRequest(RequestType.GEN_BATCH_PROOF,
                             {"circuit": "batch", "input": inp})
        uid = self.prover.submit(preq)
        return pb.GenBatchProofResponse(id=uid, result=pb.RESULT_OK)

    def _gen_aggregated(self, req):
        try:
            p1 = self._parse_proof(req.recursive_proof_1)
            p2 = self._parse_proof(req.recursive_proof_2)
        except Exception:
            return pb.GenAggregatedProofResponse(result=pb.RESULT_ERROR)
        preq = ProverRequest(RequestType.GEN_AGGREGATED_PROOF,
                             {"circuit": "batch", "proof1": p1, "proof2": p2})
        uid = self.prover.submit(preq)
        return pb.GenAggregatedProofResponse(id=uid, result=pb.RESULT_OK)

    def _gen_final(self, req):
        try:
            inner = self._parse_proof(req.recursive_proof)
        except Exception:
            return pb.GenFinalProofResponse(result=pb.RESULT_ERROR)
        preq = ProverRequest(RequestType.GEN_FINAL_PROOF,
                             {"circuit": "batch", "proof": inner})
        uid = self.prover.submit(preq)
        return pb.GenFinalProofResponse(id=uid, result=pb.RESULT_OK)

    def _get_proof(self, req):
        preq = self.prover.get(req.id)
        resp = pb.GetProofResponse(id=req.id)
        if preq is None:
            resp.result = pb.GetProofResponse.RESULT_ERROR
            return resp
        if req.timeout:
            preq.done.wait(req.timeout)
        if preq.state in (RequestState.PENDING, RequestState.RUNNING):
            resp.result = pb.GetProofResponse.RESULT_PENDING
        elif preq.state == RequestState.COMPLETED:
            resp.result = pb.GetProofResponse.RESULT_COMPLETED_OK
            resp.recursive_proof = self._proof_json(preq.proof)
        elif preq.state == RequestState.CANCELLED:
            resp.result = pb.GetProofResponse.RESULT_CANCEL
        else:
            resp.result = pb.GetProofResponse.RESULT_INTERNAL_ERROR
            resp.result_string = preq.error
        return resp

    @staticmethod
    def _parse_proof(blob: str):
        """Wire proof -> StarkProof or RecursiveProof."""
        import json
        from ..recursion.stack import RecursiveProof
        obj = json.loads(blob)
        if isinstance(obj, dict) and "level" in obj and "proof" in obj:
            return RecursiveProof(level=int(obj["level"]),
                                  proof=StarkProof.from_json(
                                      json.dumps(obj["proof"])
                                      if not isinstance(obj["proof"], str)
                                      else obj["proof"]))
        return StarkProof.from_json(blob)

    @staticmethod
    def _proof_json(proof) -> str:
        import json
        from ..recursion.stack import RecursiveProof
        if isinstance(proof, StarkProof):
            return proof.to_json()
        if isinstance(proof, RecursiveProof):
            return json.dumps({"level": proof.level,
                               "proof": proof.proof.to_json()})
        if isinstance(proof, dict) and "final" in proof:
            inner = proof["final"]
            if isinstance(inner, RecursiveProof):
                return json.dumps({"final": {"level": inner.level,
                                             "proof": inner.proof.to_json()}})
            return json.dumps({"final": inner.to_json()
                               if isinstance(inner, StarkProof) else inner},
                              default=str)
        return json.dumps(proof, default=str)


# ---------------------------------------------------------------------------
# Test-harness server (the aggregator side)
# ---------------------------------------------------------------------------

class MockAggregatorServer:
    """In-process aggregator: queues requests to connected provers and
    collects replies (the reference test AggregatorServer pattern)."""

    def __init__(self, port: int = 0):
        self._server = grpc.server(ThreadPoolExecutor(max_workers=4))
        handler = grpc.stream_stream_rpc_method_handler(
            self._channel,
            request_deserializer=pb.ProverMessage.FromString,
            response_serializer=pb.AggregatorMessage.SerializeToString,
        )
        service = grpc.method_handlers_generic_handler(
            "aggregator.v1.AggregatorService", {"Channel": handler})
        self._server.add_generic_rpc_handlers((service,))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")
        self._to_prover: "queue.Queue" = queue.Queue()
        self._replies: dict = {}
        self._reply_events: dict = {}
        self._connected = threading.Event()
        self._clients: list = []          # per-connection direct queues
        self.reply_client: dict = {}      # msg_id -> client index

    def start(self):
        self._server.start()
        return self

    def stop(self):
        self._server.stop(1.0)

    def wait_connected(self, timeout=10.0, n: int = 1) -> bool:
        """Wait until at least n prover streams are attached."""
        import time as _t
        deadline = _t.monotonic() + timeout
        while _t.monotonic() < deadline:
            if len(self._clients) >= n and self._connected.wait(0.1):
                return True
            _t.sleep(0.02)
        return len(self._clients) >= n

    def ask(self, msg_id: str, timeout: float = 120.0, client=None,
            **kwargs):
        """Send one AggregatorMessage and wait for a reply.  client=None
        posts to the shared queue (any prover grabs it — the elastic
        dispatch model); an index routes to that prover's own stream
        (follow-ups like GetProof must reach the job's owner)."""
        msg = pb.AggregatorMessage(id=msg_id, **kwargs)
        ev = threading.Event()
        self._reply_events[msg_id] = ev
        if client is None:
            self._to_prover.put(msg)
        else:
            self._clients[client].put(msg)
        if not ev.wait(timeout):
            raise TimeoutError(f"no reply for {msg_id}")
        return self._replies.pop(msg_id)

    def _channel(self, request_iterator, context):
        my_q: "queue.Queue" = queue.Queue()
        my_idx = len(self._clients)
        self._clients.append(my_q)
        self._connected.set()
        stop = threading.Event()

        def reader():
            try:
                for prover_msg in request_iterator:
                    self._replies[prover_msg.id] = prover_msg
                    self.reply_client[prover_msg.id] = my_idx
                    ev = self._reply_events.pop(prover_msg.id, None)
                    if ev:
                        ev.set()
            except Exception:
                pass
            finally:
                stop.set()

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        while not stop.is_set():
            try:
                msg = my_q.get_nowait()
            except queue.Empty:
                try:
                    msg = self._to_prover.get(timeout=0.25)
                except queue.Empty:
                    continue
            yield msg
