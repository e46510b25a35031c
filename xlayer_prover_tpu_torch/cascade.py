"""The devnet cascade on the port: four chained devnet batches proven
through the ``ProverService`` request queue, lifted to recursive1,
aggregated pairwise to one root, verified, and wrapped in RecursiveF and
Groth16 (reference test/service/aggregator/aggregator_service.cpp:18-240).

The port's counterpart of ``tools/run_a7_cascade.py --devnet 4``::

    python3 -m xlayer_prover_tpu_torch.cascade [--state-dir DIR]
        [--out RECORD.json]

Stages, in order: ``setup_const_tree``; ``batch_proof_{k}vdev{k}`` for k
in 0..3, each a GEN_BATCH_PROOF request with ``{"input": BatchInput}``
(``utils/devnet.build_devnet_inputs``: batch k's pre-state is the port's
own execution of batch k-1); ``recursive1_{k}``; ``aggregate_01``,
``aggregate_23``, ``aggregate_root`` through a ``RecursionStack`` with the
zkEVM chain link (``zkevm_chain_spec``); ``verify_root``;
``finalize_groth16`` (``rng=random.Random(11)``); ``groth16_verify``.

Every proof stage persists to ``--state-dir`` under the JAX tool's file
names and JSON text (``{name}_nb16_q4.json``), so each file compares byte
for byte with ``a7_state_devnet/``; a stage whose file exists is read
back, not proven again.  The record (``--out``) has the JAX record's keys
(``PROOF_a7_cascade_devnet.json``) with ``backend`` the card's name, and
per stage its launches by kernel, its peak device memory (on the card)
and its ``timings``: for a batch proof the request's execution, STARK
(by round, and its rows per second) and verification seconds, for the
others those of the recursion engines.  The JAX tool's parallel
``--worker`` mode and its reference-vector mode are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import torch

from . import device as devices
from . import kernels
from .prover_service import (ProverRequest, ProverService, RequestState,
                             RequestType)
from .recursion.stack import RecursionStack, RecursiveProof, zkevm_chain_spec
from .snark import groth16
from .stark.proof import StarkProof
from .utils import devnet

N_BATCHES = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_DIR = os.path.join(REPO, "build", "a7_state_devnet")
RECORD = os.path.join(REPO, "build", "PROOF_a7_cascade_devnet.json")
REQUEST_TIMEOUT_S = 3600.0


def batch_stage(k: int) -> str:
    return f"batch_proof_{k}vdev{k}"


class DevnetCascade:
    """One run of the cascade.  `engine` (a ``BatchProver``; None: the
    devnet prover on the card), `inputs` (None: built from `engine` when a
    batch stage first needs them) and `stack` (None: built over
    `engine`'s AIR and verkey) may be stand-ins.  After ``run``,
    ``outputs`` maps each stage to what it returned."""

    def __init__(self, state_dir: str = STATE_DIR, out: str = RECORD,
                 engine=None, inputs=None, stack=None):
        self.state_dir = state_dir
        self.out = out
        self.engine = engine or devnet.devnet_prover()
        self.device = devices.resolve(self.engine.device)
        self.stack = stack
        self._inputs = inputs
        geo = devnet.DEVNET_GEOMETRY
        self.n_bits, self.n_queries = geo["n_bits"], geo["n_queries"]
        self.outputs: dict = {}
        self.record = {
            "what": "A.7 cascade: 4 real batches -> 3 aggregations -> "
                    "RecursiveF -> Groth16 (aggregator_service.cpp:18-240)",
            "backend": None,
            "n_bits": self.n_bits,
            "n_queries": self.n_queries,
            "limb_bits": geo["limb_bits"],
            "vectors": [f"dev{k}" for k in range(N_BATCHES)],
            "stages": {},
            "status": "running",
            "launches": {},
            "peak_bytes": {},
            "timings": {},
        }

    # -- persistence -----------------------------------------------------
    def path(self, name: str) -> str:
        return os.path.join(self.state_dir, f"{name}_nb{self.n_bits}"
                            f"_q{self.n_queries}.json")

    def read_stage(self, name: str):
        p = self.path(name)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            blob = json.load(f)
        if blob.get("level"):
            return RecursiveProof.from_json(blob)
        return StarkProof.from_json(blob["proof"])

    def write_stage(self, name: str, out):
        if isinstance(out, RecursiveProof):
            blob = {"level": out.level, "proof": out.proof.to_json()}
        else:
            blob = {"level": 0, "proof": out.to_json()}
        p = self.path(name)
        tmp = p + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, p)

    def save(self, **kw):
        self.record.update(kw)
        os.makedirs(os.path.dirname(os.path.abspath(self.out)),
                    exist_ok=True)
        with open(self.out, "w") as f:
            json.dump(self.record, f, indent=1, default=str)

    # -- stages ----------------------------------------------------------
    def _measured(self, name: str, fn):
        """fn(timings) with its seconds (after a synchronise on the card),
        its launches by kernel and its peak device memory recorded."""
        dev = self.device
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = dict(kernels.LAUNCHES)
        timings: dict = {}
        t0 = time.perf_counter()
        out = fn(timings)
        if cuda:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.record["stages"][name] = dt
        self.record["launches"][name] = {
            k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
            if v != before.get(k, 0)}
        if cuda:
            self.record["peak_bytes"][name] = \
                torch.cuda.max_memory_allocated(dev)
        if timings:
            self.record["timings"][name] = timings
        self.outputs[name] = out
        print(f"[a7] {name}: {dt:.2f}s", flush=True)
        self.save()
        return out

    def stage(self, name: str, fn):
        """A proof stage: read back from its file when present, else run
        and persisted."""
        out = self.read_stage(name)
        if out is not None:
            self.record["stages"][name] = "resumed"
            self.outputs[name] = out
            print(f"[a7] {name}: resumed from {self.path(name)}", flush=True)
            self.save()
            return out
        out = self._measured(name, fn)
        self.write_stage(name, out)
        return out

    def inputs(self) -> list:
        """The batches' inputs, planned up to the last batch whose proof
        is not on file (batch 0's alone when every one is): a batch read
        back after it needs no planning execution."""
        if self._inputs is None:
            missing = [k for k in range(N_BATCHES)
                       if not os.path.exists(self.path(batch_stage(k)))]
            self._inputs = devnet.build_devnet_inputs(
                self.engine, 1 + max(missing, default=0))
        return self._inputs

    def serve_batch(self, service: ProverService, k: int, timings: dict):
        """Batch k as a GEN_BATCH_PROOF request; the service verifies it
        before it completes.  `timings` receives the request's."""
        req = ProverRequest(RequestType.GEN_BATCH_PROOF,
                            {"input": self.inputs()[k]})
        service.submit(req)
        service.wait(req.uuid, timeout=REQUEST_TIMEOUT_S)
        if req.state != RequestState.COMPLETED:
            raise RuntimeError(f"{batch_stage(k)}: request {req.uuid} "
                               f"{req.state.value}: {req.error}")
        timings.update(req.timings)
        if req.timings.get("stark_s"):
            timings["rows_per_s"] = (1 << self.n_bits) / req.timings[
                "stark_s"]
        return req.proof

    def run(self) -> dict:
        os.makedirs(self.state_dir, exist_ok=True)
        self.record["backend"] = (torch.cuda.get_device_name(self.device)
                                  if self.device.type == "cuda" else "cpu")
        self._measured("setup_const_tree", lambda t: self.engine.setup())
        if self._inputs is None and not all(
                os.path.exists(self.path(batch_stage(k)))
                for k in range(N_BATCHES)):
            # the three planning executions, outside the batch stages as
            # in the JAX tool
            t0 = time.perf_counter()
            self.inputs()
            self.record["inputs_s"] = time.perf_counter() - t0

        service = ProverService(batch_prover=self.engine)
        try:
            batch_proofs = [
                self.stage(batch_stage(k),
                           lambda t, k=k: self.serve_batch(service, k, t))
                for k in range(N_BATCHES)]
        finally:
            service.shutdown()
        publics_chain = [[int(p) for p in proof.publics[:8]]
                         for proof in batch_proofs]

        if self.stack is None:
            link, out_map = zkevm_chain_spec(len(batch_proofs[0].publics))
            self.stack = RecursionStack(
                self.engine.air, self.engine.setup().verkey,
                n_queries=self.n_queries, link=link, out_map=out_map,
                device=self.device)
        stack = self.stack
        lifts = [self.stage(f"recursive1_{k}",
                            lambda t, k=k: stack.lift(batch_proofs[k], t))
                 for k in range(N_BATCHES)]
        agg01 = self.stage("aggregate_01", lambda t: stack.aggregate(
            lifts[0], lifts[1], t))
        agg23 = self.stage("aggregate_23", lambda t: stack.aggregate(
            lifts[2], lifts[3], t))
        root = self.stage("aggregate_root", lambda t: stack.aggregate(
            agg01, agg23, t))
        if not self._measured("verify_root", lambda t: stack.verify(root)):
            raise RuntimeError("the aggregate root does not verify")
        self.record["pair_s"] = stack.timings

        out = self._measured("finalize_groth16", lambda t: stack.finalize(
            root, wrap="groth16", rng=random.Random(11), timings=t))
        if not self._measured("groth16_verify", lambda t: groth16.verify(
                out["vk"], out["proof"], out["publics"])):
            raise RuntimeError("the Groth16 proof does not verify")
        self.save(status="complete", verified=True,
                  groth16_publics=[str(p) for p in out["publics"]],
                  batch_publics_head=publics_chain)
        return self.record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--state-dir", default=STATE_DIR,
                    help="where each stage's proof is persisted and "
                         "resumed from")
    ap.add_argument("--out", default=RECORD, help="the run's record")
    args = ap.parse_args(argv)
    DevnetCascade(state_dir=args.state_dir, out=args.out).run()
    print("[a7] COMPLETE ->", args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
