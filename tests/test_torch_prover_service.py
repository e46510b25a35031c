"""Port parity: the request path of xlayer_prover_tpu_torch
(``prover_service.ProverService`` and ``BatchProver``) against the JAX
package's, on the fib toy (n_bits 4, 2 queries) on the CPU.

Both services serve the same requests: the fib batch proof and its saved
artifact are byte-equal; a pending request and a running one are
cancelled (the running one through ``abort_check`` -> ``ProofCancelled``
at each of gen_proof's two round boundaries); an unknown setup fails with
the same ``ZkResult``; completed requests are dropped after their TTL;
aggregated and final proofs dispatch through a stand-in recursion stack
that records its calls.  ``Setup.save`` / ``Setup.load`` cross between the
packages both ways and a loaded setup proves byte-equal;
``save_cm_pols`` / ``load_cm_pols`` too.  The slow tier serves the real
fib aggregation on the CPU, byte-equal to the JAX service's
(``tests/data/svc_agg_fib_q4.proof.json``), and the final proof over it.
Every wait has a timeout and every service is shut down."""

import contextlib
import json
import os
import threading
import time
import types

import numpy as np
import pytest

import xlayer_prover_tpu.prover_service as jservice
from xlayer_prover_tpu.models.toy import fib as jfib
from xlayer_prover_tpu.stark import prover as jprover
from xlayer_prover_tpu_torch import prover_service as service
from xlayer_prover_tpu_torch.models.toy import fib
from xlayer_prover_tpu_torch.recursion.stack import RecursionStack
from xlayer_prover_tpu_torch.stark import prover, verifier

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures

TIMEOUT = 120.0
SLOW_TIMEOUT = 4 * 3600.0            # the slow tier's recursion on the CPU
SVC_AGG = "svc_agg_fib_q4"
# package name -> (its prover_service, stark.prover, fib, Setup.build kw)
PKGS = {"port": (service, prover, fib, {"device": "cpu"}),
        "jax": (jservice, jprover, jfib, {})}


def fib_case(pkg: str, a0: int = 1, b0: int = 1, seed: int = 0):
    """-> (air, setup, cm1, publics) of the fib toy in `pkg`."""
    _svc, prv, fib_mod, kw = PKGS[pkg]
    air = fib_mod.build_air(n_bits=4, n_queries=2)
    const_np, cm1, publics = fib_mod.gen_trace(air, a0=a0, b0=b0, seed=seed)
    return air, prv.Setup.build(air, const_np, **kw), cm1, publics


@pytest.fixture(scope="module")
def cases():
    return {pkg: fib_case(pkg) for pkg in PKGS}


@pytest.fixture(scope="module")
def proofs(cases):
    """Each package's fib proof JSON from gen_proof; the two are equal."""
    out = {pkg: PKGS[pkg][1].gen_proof(*case[1:]).to_json()
           for pkg, case in cases.items()}
    assert out["port"] == out["jax"]
    return out


@contextlib.contextmanager
def serving(pkg: str, *args, **kw):
    svc = PKGS[pkg][0].ProverService(*args, **kw)
    try:
        yield svc
    finally:
        svc.shutdown()
    assert not svc._worker.is_alive()


def served(pkg: str, svc, req_type: str, payload: dict,
           timeout: float = TIMEOUT, **req_kw):
    """Submit one request and wait for it (with a timeout)."""
    mod = PKGS[pkg][0]
    req = mod.ProverRequest(mod.RequestType[req_type], payload, **req_kw)
    svc.submit(req)
    svc.wait(req.uuid, timeout=timeout)
    assert req.done.is_set(), f"{req_type} did not finish in {timeout} s"
    return req


def batch_payload(case) -> dict:
    _air, _setup, cm1, publics = case
    return {"cm1": cm1, "publics": publics}


def outcome(req):
    return (req.state.value, req.result.name, int(req.result), req.error)


# ---------------------------------------------------------------------------
# Batch proofs, artifacts, failures
# ---------------------------------------------------------------------------

def test_batch_proof_and_artifact_byte_equal_to_jax(cases, proofs,
                                                    tmp_path):
    texts = {}
    for pkg, case in cases.items():
        out = tmp_path / pkg
        air, setup, *_ = case
        with serving(pkg, {"batch": (air, setup)},
                     artifacts_dir=str(out)) as svc:
            req = served(pkg, svc, "GEN_BATCH_PROOF", batch_payload(case))
        assert outcome(req) == ("completed", "SUCCESS", 1, "")
        (name,) = os.listdir(out)
        assert name == f"{req.uuid}.gen_batch_proof.proof.json"
        texts[pkg] = (req.proof.to_json(), (out / name).read_text())
        if pkg == "port":
            assert verifier.verify(air, setup.verkey, req.proof)
    assert texts["port"] == texts["jax"] == (proofs["port"],) * 2


def test_batch_prover_times_execute_stark_and_rounds():
    """BatchProver.prove gives the execution's seconds, the STARK's and
    gen_proof's rounds into `timings`, and passes abort_check on."""
    calls = []

    def prove_from_trace(cm1, publics, abort_check, timings):
        calls.append((cm1, publics, abort_check))
        timings.update(step1=0.5, fri=0.25)
        return "proof"

    engine = types.SimpleNamespace(
        execute_only=lambda batch_input, batch_uuid: types.SimpleNamespace(
            cm1_np="cm1", publics=[7], ctx=f"ctx-{batch_input}"),
        prove_from_trace=prove_from_trace, stark_stats=None)
    timings = {}
    check = object()
    assert service.BatchProver.prove(engine, "in", "u", abort_check=check,
                                     timings=timings) == ("proof", "ctx-in")
    assert calls == [("cm1", [7], check)]
    assert set(timings) == {"execute_s", "stark_s", "rounds_s"}
    assert timings["rounds_s"] == {"step1": 0.5, "fri": 0.25}
    assert timings["execute_s"] >= 0.0 and timings["stark_s"] >= 0.0
    assert service.BatchProver.prove(engine, "in") == ("proof", "ctx-in")


@pytest.mark.parametrize("payload", [
    {"circuit": "nope"}, {"input": None}], ids=["unknown_setup",
                                                "no_batch_prover"])
def test_failure_gives_the_jax_result(cases, payload):
    got = {}
    for pkg, case in cases.items():
        air, setup, *_ = case
        with serving(pkg, {"batch": (air, setup)}) as svc:
            req = served(pkg, svc, "GEN_BATCH_PROOF",
                         {**batch_payload(case), **payload})
        got[pkg] = outcome(req)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("failed", "PROVER_ERROR", 40)


def test_unsupported_request_gives_the_jax_result(cases):
    got = {}
    for pkg, case in cases.items():
        with serving(pkg, {"batch": case[:2]}) as svc:
            got[pkg] = outcome(served(pkg, svc, "PROCESS_BATCH", {}))
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("failed", "INVALID_INPUT", 20)


# ---------------------------------------------------------------------------
# Cancellation
# ---------------------------------------------------------------------------

class GatedAbort(threading.Event):
    """A request's abort flag whose first poll waits for `gate`: the
    worker stays inside that request's proof until the test opens it."""

    def __init__(self, gate: threading.Event):
        super().__init__()
        self.gate = gate
        self.polled = threading.Event()

    def is_set(self):
        self.polled.set()
        self.gate.wait(TIMEOUT)
        return super().is_set()


class CancelAtPoll(threading.Event):
    """A request's abort flag that counts the proof's polls and, at poll
    `at`, asks the service to cancel the request (then RUNNING)."""

    def __init__(self, at: int):
        super().__init__()
        self.at = at
        self.polls = 0
        self.cancel = None
        self.accepted = None

    def is_set(self):
        self.polls += 1
        if self.polls == self.at:
            self.accepted = self.cancel()
        return super().is_set()


@pytest.mark.parametrize("pkg", PKGS)
def test_cancel_pending_request(cases, pkg):
    case = cases[pkg]
    mod = PKGS[pkg][0]
    gate = threading.Event()
    with serving(pkg, {"batch": case[:2]}) as svc:
        first = mod.ProverRequest(mod.RequestType.GEN_BATCH_PROOF,
                                  batch_payload(case),
                                  abort=GatedAbort(gate))
        queued = mod.ProverRequest(mod.RequestType.GEN_BATCH_PROOF,
                                   batch_payload(case))
        svc.submit(first)
        svc.submit(queued)
        try:
            assert first.abort.polled.wait(TIMEOUT)
            assert svc.queue_depth() == 1
            assert svc.cancel(queued.uuid)
            assert queued.done.is_set()
            assert outcome(queued) == ("cancelled", "CANCELLED", 43, "")
        finally:
            gate.set()
        svc.wait(first.uuid, timeout=TIMEOUT)
        assert first.state.value == "completed"
        assert queued.proof is None and queued.state.value == "cancelled"
        assert not svc.cancel(queued.uuid) and not svc.cancel("unknown")


@pytest.mark.parametrize("at", [1, 2], ids=["before_step2",
                                            "before_step3"])
@pytest.mark.parametrize("pkg", PKGS)
def test_cancel_running_request_at_a_round_boundary(cases, pkg, at):
    case = cases[pkg]
    with serving(pkg, {"batch": case[:2]}) as svc:
        abort = CancelAtPoll(at)
        mod = PKGS[pkg][0]
        req = mod.ProverRequest(mod.RequestType.GEN_BATCH_PROOF,
                                batch_payload(case), abort=abort)
        abort.cancel = lambda: svc.cancel(req.uuid)
        svc.submit(req)
        svc.wait(req.uuid, timeout=TIMEOUT)
        assert abort.accepted is True and abort.polls == at
        assert outcome(req) == ("cancelled", "CANCELLED", 43, "")
        assert req.proof is None
        after = served(pkg, svc, "GEN_BATCH_PROOF", batch_payload(case))
        assert after.state.value == "completed"


@pytest.mark.parametrize("pkg", PKGS)
def test_gen_proof_polls_at_two_round_boundaries(cases, proofs, pkg):
    """abort_check is polled before step 2 and before step 3 only; False
    leaves the proof unchanged, True at either poll raises
    ProofCancelled."""
    prv = PKGS[pkg][1]
    _air, setup, cm1, publics = cases[pkg]
    polls = []
    proof = prv.gen_proof(setup, cm1, publics,
                          abort_check=lambda: polls.append(1) and False)
    assert len(polls) == 2
    assert proof.to_json() == proofs[pkg]
    for at in (1, 2):
        polls.clear()
        with pytest.raises(prv.ProofCancelled):
            prv.gen_proof(setup, cm1, publics,
                          abort_check=lambda: polls.append(1) or
                          len(polls) == at)
        assert len(polls) == at


# ---------------------------------------------------------------------------
# The cleaner, the recursion pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_gc_drops_finished_requests_after_their_ttl(cases, pkg):
    """Each finished request (here: failed ones, no proof needed) is
    dropped by the first request to finish a TTL later."""
    ttl = 0.2
    with serving(pkg, {"batch": cases[pkg][:2]}, cleaner_ttl_s=ttl) as svc:
        old = served(pkg, svc, "PROCESS_BATCH", {})
        assert svc.get(old.uuid) is old
        time.sleep(2 * ttl)
        new = served(pkg, svc, "PROCESS_BATCH", {})
        deadline = time.monotonic() + TIMEOUT
        while svc.get(old.uuid) is not None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.get(old.uuid) is None
        assert svc.get(new.uuid) is new


class RecordingStack:
    """Stands in for a RecursionStack: records each call, returns tags."""

    def __init__(self):
        self.calls = []

    def lift(self, p):
        self.calls.append(("lift", p))
        return f"L({p})"

    def aggregate(self, a, b):
        self.calls.append(("aggregate", a, b))
        return f"A({a},{b})"

    def finalize(self, p, wrap="stark", snark=True):
        self.calls.append(("finalize", p, wrap, snark))
        return {"final": "groth16"} if wrap == "groth16" else f"F({p})"


REQUESTS = [
    ("GEN_AGGREGATED_PROOF", {"proof1": "p1", "proof2": "p2"},
     "A(L(p1),L(p2))",
     [("lift", "p1"), ("lift", "p2"), ("aggregate", "L(p1)", "L(p2)")]),
    ("GEN_FINAL_PROOF", {"proof": "r"}, {"final": "F(r)"},
     [("finalize", "r", "stark", True)]),
    ("GEN_FINAL_PROOF", {"proof": "r", "wrap": "groth16", "snark": False},
     {"final": "groth16"}, [("finalize", "r", "groth16", False)]),
]


@pytest.mark.parametrize("req_type,payload,proof,calls", REQUESTS,
                         ids=["aggregate", "final_default", "final_groth16"])
@pytest.mark.parametrize("pkg", PKGS)
def test_recursion_requests_dispatch_like_jax(cases, pkg, req_type, payload,
                                              proof, calls):
    with serving(pkg, {"batch": cases[pkg][:2]}) as svc:
        svc._rstack["batch"] = stack = RecordingStack()
        req = served(pkg, svc, req_type, payload)
    assert outcome(req) == ("completed", "SUCCESS", 1, "")
    assert req.proof == proof and stack.calls == calls


def test_recursion_stack_has_no_chain_link(cases):
    """Like the JAX package's, the service's stack is built over the
    named setup's AIR and verkey with the service's queries and no zkEVM
    chain link (ROADMAP queue 3); it lives on the setup's device, is
    built once, and a BatchProver stands for "batch" when there is one."""
    air, setup, *_ = cases["port"]
    jair, jsetup, *_ = cases["jax"]
    with serving("port", {"batch": (air, setup)},
                 recursion_queries=4) as svc, \
            serving("jax", {"batch": (jair, jsetup)},
                    recursion_queries=4) as jsvc:
        st, jst = svc._recursion_stack("batch"), jsvc._recursion_stack(
            "batch")
        assert isinstance(st, RecursionStack)
        assert svc._recursion_stack("batch") is st
        assert (st.link, st.out_map, st.n_queries, st.batch_verkey) == \
            (jst.link, jst.out_map, jst.n_queries, jst.batch_verkey) == \
            (None, None, 4, setup.verkey)
        assert st.device == setup.device and st.batch_air is air
        with pytest.raises(Exception, match="no setup named 'x'"):
            svc._recursion_stack("x")
    engine = types.SimpleNamespace(air=air, setup=lambda: setup)
    with serving("port", {}, batch_prover=engine) as svc:
        st = svc._recursion_stack("batch")
        assert st.batch_air is air and st.batch_verkey == setup.verkey


# ---------------------------------------------------------------------------
# Persistence: Setup.save / load, save_cm_pols / load_cm_pols
# ---------------------------------------------------------------------------

def test_setup_save_load_across_packages(cases, proofs, tmp_path):
    air, setup, cm1, publics = cases["port"]
    jair, jsetup, *_ = cases["jax"]
    want = proofs["port"]

    setup.save(str(tmp_path / "port.npz"))
    from_port = jprover.Setup.load(str(tmp_path / "port.npz"), jair)
    assert from_port.verkey == jsetup.verkey
    assert jprover.gen_proof(from_port, cm1, publics).to_json() == want

    jsetup.save(str(tmp_path / "jax.npz"))
    from_jax = prover.Setup.load(str(tmp_path / "jax.npz"), air,
                                 device="cpu")
    assert from_jax.verkey == setup.verkey
    assert from_jax.device == setup.device
    for a, b in [(from_jax.const_n, setup.const_n),
                 (from_jax.const_ext, setup.const_ext),
                 *zip(from_jax.const_tree.levels, setup.const_tree.levels)]:
        assert a.dtype == b.dtype and a.device == b.device
        assert np.array_equal(a.numpy(), b.numpy())
    assert prover.gen_proof(from_jax, cm1, publics).to_json() == want

    other = fib.build_air(n_bits=5, n_queries=2)
    with pytest.raises(ValueError, match="geometry"):
        prover.Setup.load(str(tmp_path / "jax.npz"), other, device="cpu")


def test_batch_prover_preloads_the_constants_tree(cases, tmp_path,
                                                  monkeypatch):
    """setup(constants_tree_file): a missing file is written after the
    build, an existing one is loaded instead of building (an executor
    stand-in over the fib AIR keeps the build small)."""
    from xlayer_prover_tpu_torch.models.zkevm import zkevm_air
    air, setup, *_ = cases["port"]
    const_np = fib.gen_trace(air)[0]
    builds = []
    monkeypatch.setattr(zkevm_air, "fill_fixed",
                        lambda a, layout: builds.append(a) or const_np)

    def engine():
        bp = service.BatchProver.__new__(service.BatchProver)
        bp.executor = types.SimpleNamespace(
            air=air, fixed=lambda: zkevm_air.fill_fixed(air, None))
        bp.device, bp._setup = "cpu", None
        return bp

    path = str(tmp_path / "consttree.npz")
    built = engine().setup(path)
    assert builds == [air] and os.path.exists(path)
    loaded = engine().setup(path)
    assert builds == [air]
    assert loaded.verkey == built.verkey == setup.verkey
    assert np.array_equal(loaded.const_ext.numpy(), setup.const_ext.numpy())
    assert jprover.Setup.load(path, cases["jax"][0]).verkey == setup.verkey


def test_cm_pols_round_trip_across_packages(cases, tmp_path):
    _air, _setup, cm1, publics = cases["port"]
    res = types.SimpleNamespace(cm1_np=cm1,
                                publics=[*publics, prover.P + 5])
    want = [*publics, 5]
    for save, name in ((service.BatchProver.save_cm_pols, "port.npz"),
                       (jservice.BatchProver.save_cm_pols, "jax.npz")):
        path = str(tmp_path / name)
        save(path, res)
        for load in (service.BatchProver.load_cm_pols,
                     jservice.BatchProver.load_cm_pols):
            got_cm1, got_publics = load(path)
            assert np.array_equal(got_cm1, cm1) and got_publics == want


# ---------------------------------------------------------------------------
# Slow tier: the real fib aggregation on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_fib_aggregation_served_byte_equal_to_jax(tmp_path):
    """Two fib proofs served, then GEN_AGGREGATED_PROOF over them (the
    recursion pair with no chain link, on the CPU) byte-equal to the JAX
    service's, its artifact too; then GEN_FINAL_PROOF's default wrap
    returns the verified root."""
    cases_ = [fib_case("port", *t) for t in fixtures.SVC_FIB_TRACES]
    air, setup, *_ = cases_[0]
    with serving("port", {"batch": (air, setup)}, recursion_queries=4,
                 artifacts_dir=str(tmp_path)) as svc:
        proofs = [served("port", svc, "GEN_BATCH_PROOF",
                         batch_payload(c)).proof for c in cases_]
        agg = served("port", svc, "GEN_AGGREGATED_PROOF",
                     {"proof1": proofs[0], "proof2": proofs[1]},
                     timeout=SLOW_TIMEOUT)
        assert agg.state.value == "completed", agg.error
        text = json.dumps(agg.proof.to_json())
        assert text == fixtures.read(SVC_AGG)
        assert (tmp_path / f"{agg.uuid}.gen_aggregated_proof.proof.json"
                ).read_text() == text
        final = served("port", svc, "GEN_FINAL_PROOF", {"proof": agg.proof},
                       timeout=SLOW_TIMEOUT)
        assert final.state.value == "completed", final.error
        assert final.proof == {"final": agg.proof}


def test_chip_smoke_serves_the_fixture_traces():
    """chip_smoke.py's service phase proves the fixture's fib traces."""
    import chip_smoke
    assert chip_smoke.FIB_SVC_TRACES == fixtures.SVC_FIB_TRACES


@pytest.mark.slow
def test_svc_agg_fixture_is_the_jax_service_proof():
    assert fixtures.jax_proof(SVC_AGG) == fixtures.read(SVC_AGG)


@pytest.mark.parametrize("pkg", ["xlayer_prover_tpu_torch",
                                 "xlayer_prover_tpu"])
def test_timer_and_log_like_jax(pkg, capsys):
    """utils/timer.timer adds (count, seconds) per label and logs through
    utils/log.zklog, whose JSON lines carry the thread's tags."""
    import importlib
    timer_mod = importlib.import_module(f"{pkg}.utils.timer")
    zklog = importlib.import_module(f"{pkg}.utils.log").zklog
    label = f"test.{pkg}"
    for _ in range(2):
        with timer_mod.timer(label, log=False):
            pass
    assert timer_mod.metrics.as_dict()[label]["count"] == 2
    zklog.json_mode = True
    zklog.set_tags(uuid="u1")
    try:
        with timer_mod.timer(label):
            pass
    finally:
        zklog.json_mode = False
        zklog.clear_tags()
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rec["level"] == "I" and rec["uuid"] == "u1"
    assert rec["msg"].startswith(f"{label}: ")
