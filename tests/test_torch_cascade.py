"""The port's devnet cascade (``xlayer_prover_tpu_torch/cascade.py``, the
counterpart of ``tools/run_a7_cascade.py --devnet 4``) on the CPU.

Stand-in engines (a batch prover, a recursion stack, Groth16's verify)
record their calls: the stages run in the JAX tool's order, the batch
proofs go through the ProverService's request queue, the stage files get
the JAX tool's names, a stage whose file exists is read back and not
proven again, and a failed batch request stops the run with its error.
The committed ``a7_state_devnet/`` files read back and write out byte for
byte.  Devnet batch 0's trace and publics do not depend on the batch UUID
(the service passes a random one where the JAX tool passed ``a7-0``).
The slow tier executes the chained batches 1-3 on the CPU: their publics
equal the committed proofs' and the state roots chain."""

import json
import os
import random
import types
import uuid

import numpy as np
import pytest
import torch

from xlayer_prover_tpu_torch import cascade
from xlayer_prover_tpu_torch import prover_service as service
from xlayer_prover_tpu_torch.recursion.stack import RecursiveProof
from xlayer_prover_tpu_torch.stark import prover
from xlayer_prover_tpu_torch.stark.proof import StarkProof
from xlayer_prover_tpu_torch.utils import devnet

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

A7 = os.path.join(fixtures.ROOT, "a7_state_devnet")
JAX_RECORD = os.path.join(fixtures.ROOT, "PROOF_a7_cascade_devnet.json")
NEW_STATE_ROOT, OLD_STATE_ROOT = 19, 0   # publics[19:27], publics[0:8]


class Names:
    """Stand-in proofs: a StarkProof whose first root limb numbers its
    name, so a name survives the stage files."""

    def __init__(self):
        self.names = []

    def proof(self, name: str, publics=None) -> StarkProof:
        self.names.append(name)
        return StarkProof(roots=[[len(self.names) - 1, 0, 0, 0]] * 4,
                          evals=[], fri_steps=[], final_pol=[],
                          publics=publics or [])

    def of(self, p) -> str:
        p = p.proof if isinstance(p, RecursiveProof) else p
        return self.names[p.roots[0][0]]


class StandInEngine:
    """A BatchProver stand-in: batch k's publics chain its state roots."""

    device = "cpu"
    air = "devnet-air"

    def __init__(self, log, names, fail_at=None):
        self.log, self.names, self.fail_at = log, names, fail_at
        self._setup = None

    def setup(self):
        if self._setup is None:
            self.log.append(("setup",))
            self._setup = types.SimpleNamespace(verkey=[1, 2, 3, 4],
                                                device=torch.device("cpu"))
        return self._setup

    def prove(self, batch_input, batch_uuid, abort_check, timings):
        k = int(batch_input[-1])
        self.log.append(("prove", batch_input))
        if k == self.fail_at:
            raise ValueError(f"batch {k} refused")
        timings.update(execute_s=1.0, stark_s=2.0 ** (k + 1),
                       rounds_s={"step1": 0.5, "fri": 0.25})
        publics = [0] * 44
        publics[OLD_STATE_ROOT:OLD_STATE_ROOT + 8] = [k] * 8
        publics[NEW_STATE_ROOT:NEW_STATE_ROOT + 8] = [k + 1] * 8
        return self.names.proof(f"B{k}", publics), None


class StandInStack:
    def __init__(self, log, names):
        self.log, self.names = log, names
        self.timings = {"rec1_trace_s": 0.0}

    def lift(self, p, timings):
        self.log.append(("lift", self.names.of(p)))
        return RecursiveProof(1, self.names.proof(f"L{self.names.of(p)[1]}"))

    def aggregate(self, a, b, timings):
        a, b = self.names.of(a), self.names.of(b)
        self.log.append(("aggregate", a, b))
        return RecursiveProof(2, self.names.proof(f"A({a},{b})"))

    def verify(self, rp):
        self.log.append(("verify", self.names.of(rp)))
        return True

    def finalize(self, rp, wrap, rng, timings):
        self.log.append(("finalize", self.names.of(rp), wrap,
                         rng.random() == random.Random(11).random()))
        return {"vk": "vk", "proof": "g16", "publics": [5, 6]}


@pytest.fixture
def stand_ins(monkeypatch):
    """-> make(state_dir, fail_at=None) -> (DevnetCascade, log, names)."""
    log, names = [], Names()
    monkeypatch.setattr(service, "stark_verifier", types.SimpleNamespace(
        verify=lambda air, vk, proof: log.append(
            ("verify_batch", names.of(proof))) or True))
    monkeypatch.setattr(cascade, "groth16", types.SimpleNamespace(
        verify=lambda vk, proof, publics: log.append(
            ("groth16_verify", vk, proof, publics)) or True))

    def make(state_dir, fail_at=None):
        log.clear()
        cas = cascade.DevnetCascade(
            state_dir=str(state_dir), out=str(state_dir / "record.json"),
            engine=StandInEngine(log, names, fail_at),
            inputs=[f"input{k}" for k in range(cascade.N_BATCHES)],
            stack=StandInStack(log, names))
        return cas, log, names
    return make


FULL_LOG = [("setup",),
            *[e for k in range(4) for e in (("prove", f"input{k}"),
                                            ("verify_batch", f"B{k}"))],
            *[("lift", f"B{k}") for k in range(4)],
            ("aggregate", "L0", "L1"), ("aggregate", "L2", "L3"),
            ("aggregate", "A(L0,L1)", "A(L2,L3)"),
            ("verify", "A(A(L0,L1),A(L2,L3))"),
            ("finalize", "A(A(L0,L1),A(L2,L3))", "groth16", True),
            ("groth16_verify", "vk", "g16", [5, 6])]
PROOF_STAGES = [*(cascade.batch_stage(k) for k in range(4)),
                *(f"recursive1_{k}" for k in range(4)),
                "aggregate_01", "aggregate_23", "aggregate_root"]


def test_stages_run_in_the_jax_order(stand_ins, tmp_path):
    cas, log, names = stand_ins(tmp_path)
    record = cas.run()
    assert log == FULL_LOG
    with open(JAX_RECORD) as f:
        jax_record = json.load(f)
    assert list(record["stages"]) == list(jax_record["stages"])
    assert set(jax_record) <= set(record)
    assert json.loads((tmp_path / "record.json").read_text()) == \
        json.loads(json.dumps(record, default=str))
    assert record["status"] == "complete" and record["verified"]
    assert record["backend"] == "cpu"
    assert record["groth16_publics"] == ["5", "6"]
    assert record["batch_publics_head"] == [[k] * 8 for k in range(4)]
    for k in range(4):
        t = record["timings"][cascade.batch_stage(k)]
        assert t["execute_s"] == 1.0 and t["stark_s"] == 2.0 ** (k + 1)
        assert t["rounds_s"] == {"step1": 0.5, "fri": 0.25}
        assert t["rows_per_s"] == (1 << 16) / 2.0 ** (k + 1)
        assert t["verify_s"] >= 0.0
    assert sorted(os.listdir(A7)) == sorted(
        f for f in os.listdir(tmp_path) if f != "record.json")
    assert [names.of(cas.outputs[s]) for s in PROOF_STAGES[-3:]] == [
        "A(L0,L1)", "A(L2,L3)", "A(A(L0,L1),A(L2,L3))"]


def test_resume_reads_stage_files_back(stand_ins, tmp_path):
    cas, log, names = stand_ins(tmp_path)
    cas.run()
    cas, log, _ = stand_ins(tmp_path)
    record = cas.run()
    assert log == [("setup",), *FULL_LOG[-3:]]
    assert [record["stages"][s] for s in PROOF_STAGES] == \
        ["resumed"] * len(PROOF_STAGES)
    assert names.of(cas.outputs["recursive1_2"]) == "L2"
    assert "inputs_s" not in record
    for stage in ("recursive1_3", "aggregate_23", "aggregate_root"):
        os.remove(cas.path(stage))
    cas, log, _ = stand_ins(tmp_path)
    record = cas.run()
    assert log == [("setup",), ("lift", "B3"), ("aggregate", "L2", "L3"),
                   ("aggregate", "A(L0,L1)", "A(L2,L3)"), *FULL_LOG[-3:]]
    assert record["stages"]["recursive1_2"] == "resumed"
    assert isinstance(record["stages"]["recursive1_3"], float)


def test_failed_batch_request_stops_the_run(stand_ins, tmp_path):
    cas, log, _ = stand_ins(tmp_path, fail_at=2)
    with pytest.raises(RuntimeError, match=r"batch_proof_2vdev2: request "
                       r".* failed: batch 2 refused"):
        cas.run()
    assert log[-1] == ("prove", "input2")
    assert os.path.exists(cas.path("batch_proof_1vdev1"))
    assert not os.path.exists(cas.path("batch_proof_2vdev2"))
    assert cas.record["status"] == "running"


@pytest.mark.parametrize("stage", ["batch_proof_0vdev0", "recursive1_1",
                                   "aggregate_root"])
def test_committed_stage_files_round_trip(stand_ins, tmp_path, stage):
    """The stage files' JSON text is the JAX tool's: a committed file read
    back and written out again is byte-equal."""
    cas, *_ = stand_ins(tmp_path)
    cas.state_dir = A7
    out = cas.read_stage(stage)
    assert isinstance(out, StarkProof if stage.startswith("batch")
                      else RecursiveProof)
    cas.state_dir = str(tmp_path)
    cas.write_stage(stage, out)
    with open(os.path.join(A7, f"{stage}_nb16_q4.json")) as f:
        assert (tmp_path / f"{stage}_nb16_q4.json").read_text() == f.read()


def test_devnet_trace_does_not_depend_on_the_batch_uuid():
    """The service proves batch k under the request's random UUID; the JAX
    tool used "a7-{k}".  The UUID only keys the HashDB overlay: batch 0's
    trace and publics are the same under both, so are its proofs."""
    engine = devnet.devnet_prover(device="cpu")
    inp = devnet.build_devnet_inputs(engine, 1)[0]
    a = engine.execute_only(inp, batch_uuid="a7-0")
    b = engine.execute_only(inp, batch_uuid=str(uuid.uuid4()))
    assert np.array_equal(a.cm1_np, b.cm1_np)
    assert [int(p) for p in a.publics] == [int(p) for p in b.publics]
    with open(os.path.join(A7, "batch_proof_0vdev0_nb16_q4.json")) as f:
        committed = StarkProof.from_json(json.load(f)["proof"])
    assert [int(p) % prover.P for p in b.publics] == committed.publics


@pytest.mark.slow
def test_chained_batches_match_the_committed_publics():
    engine = devnet.devnet_prover(device="cpu")
    inputs = devnet.build_devnet_inputs(engine, cascade.N_BATCHES)
    publics = []
    for k, inp in enumerate(inputs):
        with open(os.path.join(
                A7, f"{cascade.batch_stage(k)}_nb16_q4.json")) as f:
            committed = StarkProof.from_json(json.load(f)["proof"])
        if k:
            res = engine.execute_only(inp, batch_uuid=str(uuid.uuid4()))
            assert [int(p) % prover.P for p in res.publics] == \
                committed.publics
        publics.append(committed.publics)
    for k in range(cascade.N_BATCHES - 1):
        assert publics[k][NEW_STATE_ROOT:NEW_STATE_ROOT + 8] == \
            publics[k + 1][OLD_STATE_ROOT:OLD_STATE_ROOT + 8]
