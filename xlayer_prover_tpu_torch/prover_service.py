"""Prover orchestrator: request queue + worker + proof pipeline.

The port's own copy of ``xlayer_prover_tpu/prover_service.py``, the
equivalent of the reference Prover (src/prover/prover.cpp): owns the
proving engine instances, accepts ProverRequests into a pending queue, a
single worker drains it (the reference is also one-proof-at-a-time,
prover.cpp:182-255), and exposes submit/wait/get APIs used by the
aggregator client and the services.  Completed requests are
garbage-collected after a TTL.

Proof cascade (reference prover.cpp:392-980): batch -> (zkevm STARK ->
c12a -> recursive1); two recursive proofs -> recursive2; final ->
recursiveF -> Groth16.  ``BatchProver`` is the batch pipeline
(BatchInput -> executor -> trace -> STARK); ``ProverService`` serves
batch, aggregated and final proofs over it and ``recursion/stack.py``.
As in the JAX package, the service's recursion stack carries no zkEVM
chain link (``_recursion_stack``); ``cascade.py`` builds its own with
one.  The gRPC services are not ported (ROADMAP item 18).

``device=None`` proves on the GPU; ``device="cpu"`` runs every kernel's
plain PyTorch version on the CPU.  A service's recursion stack lives on
the device of the setup it recurses over.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
import uuid as uuid_mod
from typing import Dict, Optional

import torch

from .stark import prover as stark_prover
from .stark import verifier as stark_verifier
from .utils.log import zklog
from .utils.timer import timer
from .utils.zkresult import ZkError, ZkResult


class RequestType(enum.Enum):
    PROCESS_BATCH = "process_batch"
    GEN_BATCH_PROOF = "gen_batch_proof"
    GEN_AGGREGATED_PROOF = "gen_aggregated_proof"
    GEN_FINAL_PROOF = "gen_final_proof"


class RequestState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class ProverRequest:
    req_type: RequestType
    payload: dict
    uuid: str = dataclasses.field(
        default_factory=lambda: str(uuid_mod.uuid4()))
    state: RequestState = RequestState.PENDING
    result: ZkResult = ZkResult.UNSPECIFIED
    proof: Optional[object] = None
    error: str = ""
    abort: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # a BatchInput's proof: the seconds of its execution, STARK, rounds
    # (as stark.prover.gen_proof gives them) and verification
    timings: dict = dataclasses.field(default_factory=dict)


class BatchProver:
    """BatchInput -> executor -> trace -> STARK (the reference
    Prover::genBatchProof pipeline, prover.cpp:392-674, minus the
    recursion stages).

    The circuit's constant polynomials (ROM table + SM tables) do not
    depend on the input, so the Setup (const tree / verkey) is built once
    per geometry and reused across batches — the analogue of the
    reference's preloaded const pols + const tree (starks.hpp:93-191).
    """

    # the last proof's section plan, windows, copies and peaks
    # (stark.prover.gen_proof's stats)
    stark_stats = None

    def __init__(self, rom, n_bits: int = 16, chunk_bits: int = 4,
                 limb_bits: int = 16, n_queries: int = 8,
                 max_steps: int = 1 << 22, storage_rom=None, device=None):
        from .executor import rom_functions as rf
        from .executor.executor import Executor
        self.executor = Executor(rom, n_bits=n_bits, chunk_bits=chunk_bits,
                                 limb_bits=limb_bits, n_queries=n_queries,
                                 max_steps=max_steps,
                                 storage_rom=storage_rom)
        rf.register_all(self.executor.main)
        self.device = device
        self._setup = None

    @property
    def air(self):
        return self.executor.air

    def setup(self, constants_tree_file: str = "") -> stark_prover.Setup:
        """Build (or load) the preprocessed const pols + tree on the
        device, once.  When `constants_tree_file` names an existing
        artifact it is loaded (the reference's zkevmConstantsTree preload,
        config.hpp:132); when it names a missing path the freshly built
        Setup is saved there for the next run."""
        if self._setup is None:
            import os
            if constants_tree_file and os.path.exists(constants_tree_file):
                self._setup = stark_prover.Setup.load(
                    constants_tree_file, self.air, device=self.device)
                return self._setup
            # the executor's constants, filled once for its executions
            # and this Setup
            self._setup = stark_prover.Setup.build(
                self.air, self.executor.fixed(), device=self.device)
            if constants_tree_file:
                self._setup.save(constants_tree_file)
        return self._setup

    def execute_only(self, batch_input, batch_uuid: str = "batch"):
        """Witness generation only (the zkevmCmPolsAfterExecutor stage)."""
        from .state.hashdb import HashDB
        hashdb = HashDB()
        batch_input.load_db(hashdb)
        return self.executor.execute(
            hashdb, batch_uuid=batch_uuid,
            input_vars=batch_input.input_vars(),
            setup_registers=batch_input.setup_registers)

    def prove_from_trace(self, cm1_np, publics, abort_check=None,
                         timings: dict | None = None):
        """STARK over a previously committed trace (resume-without-
        re-execution, the reference's mmap'd cmPols re-run path).
        `timings` receives the seconds of each round, and
        ``stark_stats`` the section plan, windows, copies and peaks
        (``stark.prover.gen_proof``)."""
        stats: dict = {}
        proof = stark_prover.gen_proof(self.setup(), cm1_np, publics,
                                       timings=timings,
                                       abort_check=abort_check, stats=stats)
        self.stark_stats = stats
        return proof

    def prove(self, batch_input, batch_uuid: str = "batch",
              abort_check=None, timings: dict | None = None):
        """Run the batch and prove it.  Returns (StarkProof, Context).
        `timings` receives the seconds of the execution (``execute_s``),
        of the STARK (``stark_s``) and of its rounds (``rounds_s``), and
        the STARK's section plan, windows, copies and peaks
        (``stark_stats``) where the engine records them."""
        t0 = time.perf_counter()
        res = self.execute_only(batch_input, batch_uuid)
        t1 = time.perf_counter()
        rounds: dict = {}
        proof = self.prove_from_trace(res.cm1_np, res.publics,
                                      abort_check=abort_check,
                                      timings=rounds)
        if timings is not None:
            timings.update(execute_s=t1 - t0,
                           stark_s=time.perf_counter() - t1,
                           rounds_s=rounds)
            if self.stark_stats is not None:
                timings["stark_stats"] = self.stark_stats
        return proof, res.ctx

    # -- artifact persistence (reference saveInput/Output/ProofToFile +
    #    zkevmCmPolsAfterExecutor dumps, config.hpp:56-63,123) ----------
    @staticmethod
    def save_cm_pols(path: str, res):
        import numpy as np
        np.savez_compressed(path, cm1=res.cm1_np,
                            publics=np.array([p % stark_prover.P
                                              for p in res.publics],
                                             dtype=np.uint64))

    @staticmethod
    def load_cm_pols(path: str):
        import numpy as np
        with np.load(path) as data:
            return data["cm1"], [int(v) for v in data["publics"]]


class ProverService:
    """Queue + worker around the STARK engine and the recursion stack."""

    def __init__(self, setup_registry: Optional[Dict[str, object]] = None,
                 cleaner_ttl_s: float = 600.0,
                 batch_prover: Optional[BatchProver] = None,
                 recursion_queries: int = 8,
                 artifacts_dir: str = ""):
        # name -> (air, Setup) pairs; "batch" is the batch-proof circuit
        self.setups: Dict[str, object] = setup_registry or {}
        self.batch_prover = batch_prover
        self.recursion_queries = recursion_queries
        self.artifacts_dir = artifacts_dir
        self._rstack = {}
        self.requests: Dict[str, ProverRequest] = {}
        self._queue: "queue.Queue[str]" = queue.Queue()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # the worker proves on the CUDA device current where the service
        # was made (a new thread starts on device 0)
        self._cuda_device = (torch.cuda.current_device()
                             if torch.cuda.is_initialized() else None)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._cleaner_ttl = cleaner_ttl_s
        self._completed_at: Dict[str, float] = {}
        self._worker.start()

    # -- API ------------------------------------------------------------
    def submit(self, req: ProverRequest) -> str:
        with self._lock:
            self.requests[req.uuid] = req
        self._queue.put(req.uuid)
        zklog.info(f"prover: queued {req.req_type.value} uuid={req.uuid}")
        return req.uuid

    def wait(self, uuid: str, timeout: Optional[float] = None) -> ProverRequest:
        req = self.requests[uuid]
        req.done.wait(timeout)
        return req

    def get(self, uuid: str) -> Optional[ProverRequest]:
        return self.requests.get(uuid)

    def cancel(self, uuid: str) -> bool:
        req = self.requests.get(uuid)
        if req is None:
            return False
        # The PENDING->RUNNING transition in the worker holds the same
        # lock, so a cancel cannot land between the worker's CANCELLED
        # check and the RUNNING assignment and then be overwritten.
        with self._lock:
            if req.state == RequestState.PENDING:
                req.state = RequestState.CANCELLED
                req.result = ZkResult.CANCELLED
                req.done.set()
                return True
            if req.state == RequestState.RUNNING:
                # cooperative mid-proof abort: the worker polls at each
                # prover round boundary (the reference's cancel only skips
                # queued jobs)
                req.abort.set()
                return True
        return False

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def shutdown(self):
        self._stop.set()
        self._queue.put(None)
        self._worker.join(5.0)

    # -- worker ---------------------------------------------------------
    def _run(self):
        if self._cuda_device is not None:
            torch.cuda.set_device(self._cuda_device)
        while not self._stop.is_set():
            uid = self._queue.get()
            if uid is None:
                break
            req = self.requests.get(uid)
            if req is None:
                continue
            with self._lock:
                if req.state == RequestState.CANCELLED:
                    continue
                req.state = RequestState.RUNNING
            try:
                with timer(f"prover.{req.req_type.value}", log=True):
                    self._dispatch(req)
                req.state = RequestState.COMPLETED
                req.result = ZkResult.SUCCESS
                self._save_artifact(req)
            except stark_prover.ProofCancelled:
                req.state = RequestState.CANCELLED
                req.result = ZkResult.CANCELLED
                zklog.info(f"prover: {req.uuid} cancelled mid-proof")
            except ZkError as e:
                req.state = RequestState.FAILED
                req.result = e.code
                req.error = str(e)
                zklog.error(f"prover: {req.uuid} failed: {e}")
            except Exception as e:  # noqa: BLE001 - worker must survive
                req.state = RequestState.FAILED
                req.result = ZkResult.PROVER_ERROR
                req.error = str(e)
                zklog.error(f"prover: {req.uuid} failed: {e}")
            finally:
                req.done.set()
                self._completed_at[req.uuid] = time.monotonic()
                self._gc()

    def _save_artifact(self, req: ProverRequest):
        """Stage-output persistence (reference saveProofToFile,
        prover.cpp:660-669): every completed proof is re-runnable /
        auditable from disk."""
        if not self.artifacts_dir:
            return
        import json as _json
        import os as _os
        _os.makedirs(self.artifacts_dir, exist_ok=True)
        path = _os.path.join(self.artifacts_dir,
                             f"{req.uuid}.{req.req_type.value}.proof.json")
        proof = req.proof
        try:
            if hasattr(proof, "to_json"):
                payload = proof.to_json()
                if not isinstance(payload, str):
                    payload = _json.dumps(payload, default=str)
            else:
                payload = _json.dumps(proof, default=str)
            with open(path, "w") as f:
                f.write(payload)
            zklog.info(f"prover: saved proof artifact {path}")
        except Exception as e:  # noqa: BLE001 - persistence is best-effort
            zklog.warning(f"prover: artifact save failed: {e}")

    def _gc(self):
        cutoff = time.monotonic() - self._cleaner_ttl
        with self._lock:
            stale = [u for u, t in self._completed_at.items() if t < cutoff]
            for u in stale:
                self._completed_at.pop(u, None)
                self.requests.pop(u, None)

    # -- pipelines ------------------------------------------------------
    def _dispatch(self, req: ProverRequest):
        if req.req_type == RequestType.GEN_BATCH_PROOF:
            self._gen_batch_proof(req)
        elif req.req_type == RequestType.GEN_AGGREGATED_PROOF:
            self._gen_aggregated_proof(req)
        elif req.req_type == RequestType.GEN_FINAL_PROOF:
            self._gen_final_proof(req)
        else:
            raise ZkError(ZkResult.INVALID_INPUT,
                          f"unsupported request {req.req_type}")

    def _get_setup(self, name: str):
        entry = self.setups.get(name)
        if entry is None:
            raise ZkError(ZkResult.PROVER_ERROR, f"no setup named '{name}'")
        return entry  # (air, Setup)

    def _gen_batch_proof(self, req: ProverRequest):
        if "input" in req.payload:
            # the real path: a BatchInput through executor -> trace -> STARK
            if self.batch_prover is None:
                raise ZkError(ZkResult.PROVER_ERROR,
                              "no batch prover engine configured")
            proof, _ctx = self.batch_prover.prove(
                req.payload["input"], batch_uuid=req.uuid,
                abort_check=req.abort.is_set, timings=req.timings)
            setup = self.batch_prover.setup()
            t0 = time.perf_counter()
            stark_verifier.verify(self.batch_prover.air, setup.verkey, proof)
            req.timings["verify_s"] = time.perf_counter() - t0
            req.proof = proof
            return
        air, setup = self._get_setup(req.payload.get("circuit", "batch"))
        cm1 = req.payload["cm1"]
        publics = req.payload.get("publics", [])
        proof = stark_prover.gen_proof(setup, cm1, publics,
                                       abort_check=req.abort.is_set)
        # self-check before shipping (the reference cross-verifies via
        # pil-stark; we have a native verifier)
        stark_verifier.verify(air, setup.verkey, proof)
        req.proof = proof

    def _gen_aggregated_proof(self, req: ProverRequest):
        """Two proofs -> one recursive proof (reference genAggregatedProof,
        prover.cpp:676-825).

        The recursion engines (recursion/engine.py) build the verifier-as-
        circuit pipeline per proof shape: batch proofs first compress
        through recursive1, then pairs aggregate through recursive2, whose
        outputs are recursive2-shaped so aggregation trees of any depth
        chain (the reference's recursive2-accepts-recursive2 property)."""
        p1 = req.payload["proof1"]
        p2 = req.payload["proof2"]
        stack = self._recursion_stack(req.payload.get("circuit", "batch"))
        p1 = stack.lift(p1)
        p2 = stack.lift(p2)
        req.proof = stack.aggregate(p1, p2)

    def _gen_final_proof(self, req: ProverRequest):
        """Final wrap (reference genFinalProof, prover.cpp:827-980): verify
        the aggregate, re-prove it through RecursiveF (BN254 commitment
        stack) and wrap in Groth16 via the final verifier R1CS when
        wrap="groth16" is requested (default configurable)."""
        inner = req.payload["proof"]
        stack = self._recursion_stack(req.payload.get("circuit", "batch"))
        wrap = req.payload.get("wrap", getattr(self, "final_wrap", "stark"))
        snark = req.payload.get("snark", True)
        out = stack.finalize(inner, wrap=wrap, snark=snark)
        req.proof = out if isinstance(out, dict) else {"final": out}

    def _recursion_stack(self, circuit: str):
        stack = self._rstack.get(circuit)
        if stack is None:
            from .recursion.stack import RecursionStack
            if circuit == "batch" and self.batch_prover is not None:
                air = self.batch_prover.air
                setup = self.batch_prover.setup()
            else:
                air, setup = self._get_setup(circuit)
            stack = RecursionStack(air, setup.verkey,
                                   n_queries=self.recursion_queries,
                                   device=setup.device)
            self._rstack[circuit] = stack
        return stack
