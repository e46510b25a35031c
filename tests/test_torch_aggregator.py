"""Port parity: the aggregator protocol of xlayer_prover_tpu_torch
(``services/aggregator.py``: the prover's ``AggregatorClient`` and the
test ``MockAggregatorServer``) against the JAX package's, over loopback
gRPC on the CPU.

The fib script of tests/test_services.py (GetStatus, GenBatchProof,
GetProof) served by each package's client and ProverService gives the
same replies and the same proof JSON; the port's client works against
the JAX server and the JAX client against the port's server; devnet batch
0 sent as GenStatelessBatchProof decodes into the BatchInput that
``utils/devnet.build_devnet_inputs`` makes, in both clients; a pending
request is cancelled, an unknown id refused, a stalled handler trips the
watchdog and the client connects again.  The two reference faults the
port copies (ROADMAP queue 3) are held: the service that ``main.py
--run-services`` builds, ``ProverService({})``, fails both batch
requests, and the stateless decoder sets no old batch number.  Every
server, client and service is stopped in ``finally``; every ask and
GetProof has a timeout."""

import contextlib
import dataclasses
import importlib
import json
import threading

import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401
from xlayer_prover_tpu_torch.services.gen import aggregator_pb2 as pb
from xlayer_prover_tpu_torch.utils import devnet

PORT, JAX = PKGS = ("xlayer_prover_tpu_torch", "xlayer_prover_tpu")
TIMEOUT = 120.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class CaptureProver:
    """ProverService stand-in that keeps what the client submits
    (tests/test_stateless_stream.py's)."""

    def __init__(self):
        self.requests = []
        self.event = threading.Event()

    def submit(self, req):
        self.requests.append(req)
        self.event.set()
        return f"cap-{len(self.requests)}"

    def queue_depth(self):
        return 0

    def get(self, uid):
        return None

    def cancel(self, uid):
        return False


def fib_service(pkg: str):
    """`pkg`'s ProverService over the fib toy (n_bits 4, 2 queries) and
    the decoder that turns a GenBatchProof into its trace."""
    fib = mod(pkg, "models.toy.fib")
    prover = mod(pkg, "stark.prover")
    air = fib.build_air(n_bits=4, n_queries=2)
    const_np, cm1, publics = fib.gen_trace(air)
    kw = {"device": "cpu"} if pkg == PORT else {}
    setup = prover.Setup.build(air, const_np, **kw)
    svc = mod(pkg, "prover_service").ProverService({"batch": (air, setup)})
    return svc, (lambda _input: {"cm1": cm1, "publics": publics})


@contextlib.contextmanager
def stream(server_pkg: str, client_pkg: str, prover, **client_kw):
    """`server_pkg`'s MockAggregatorServer with `client_pkg`'s
    AggregatorClient driving `prover` connected to it.  -> (server,
    client)"""
    agg_s = mod(server_pkg, "services.aggregator")
    agg_c = mod(client_pkg, "services.aggregator")
    server = agg_s.MockAggregatorServer().start()
    client = agg_c.AggregatorClient(prover, "127.0.0.1", server.port,
                                    **client_kw)
    client.prover_id = "prover-under-test"
    try:
        client.start()
        assert server.wait_connected(15.0)
        yield server, client
    finally:
        client.stop()
        server.stop()
        if hasattr(prover, "shutdown"):
            prover.shutdown()


def fib_script(server) -> dict:
    """GetStatus, GenBatchProof, GetProof, an unknown id, a cancel of an
    unknown id.  -> the replies with the request ids blanked, and the
    proof JSON"""
    out = {}
    st = server.ask("st", timeout=TIMEOUT,
                    get_status_request=pb.GetStatusRequest())
    out["status"] = st.SerializeToString(deterministic=True)
    gen = server.ask("gen", timeout=TIMEOUT,
                     gen_batch_proof_request=pb.GenBatchProofRequest())
    uid = gen.gen_batch_proof_response.id
    gen.gen_batch_proof_response.id = ""
    out["gen"] = gen.SerializeToString(deterministic=True)
    got = server.ask("gp", timeout=TIMEOUT, get_proof_request=pb.
                     GetProofRequest(id=uid, timeout=int(TIMEOUT)))
    out["proof"] = got.get_proof_response.recursive_proof
    got.get_proof_response.id = ""
    got.get_proof_response.recursive_proof = ""
    out["get_proof"] = got.SerializeToString(deterministic=True)
    out["unknown"] = server.ask(
        "gp-x", timeout=TIMEOUT, get_proof_request=pb.GetProofRequest(
            id="nonexistent", timeout=1)).SerializeToString(
                deterministic=True)
    out["cancel_unknown"] = server.ask(
        "cx", timeout=TIMEOUT, cancel_request=pb.CancelRequest(
            id="nonexistent")).SerializeToString(deterministic=True)
    return out


@pytest.fixture(scope="module")
def fib_replies():
    """package -> its client's replies to ``fib_script`` through its own
    server."""
    out = {}
    for pkg in PKGS:
        svc, decoder = fib_service(pkg)
        with stream(pkg, pkg, svc, input_decoder=decoder,
                    watchdog_timeout_s=TIMEOUT) as (server, _client):
            out[pkg] = fib_script(server)
    return out


def test_fib_script_equal(fib_replies):
    port, jax = fib_replies[PORT], fib_replies[JAX]
    assert port == jax
    msg = pb.ProverMessage.FromString(port["get_proof"])
    assert msg.get_proof_response.result \
        == pb.GetProofResponse.RESULT_COMPLETED_OK
    assert json.loads(port["proof"])["publics"]
    assert pb.ProverMessage.FromString(port["unknown"]).get_proof_response \
        .result == pb.GetProofResponse.RESULT_ERROR
    assert pb.ProverMessage.FromString(port["cancel_unknown"]) \
        .cancel_response.result == pb.RESULT_ERROR
    status = pb.ProverMessage.FromString(port["status"]).get_status_response
    assert (status.prover_name, status.fork_id, status.prover_id) == (
        "tpu-prover", 9, "prover-under-test")


def test_fib_proof_verifies(fib_replies):
    """The proof served over the wire is the port's fib proof, and it
    verifies."""
    from xlayer_prover_tpu_torch.models.toy import fib
    from xlayer_prover_tpu_torch.stark import prover, verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof
    air = fib.build_air(n_bits=4, n_queries=2)
    const_np, cm1, publics = fib.gen_trace(air)
    setup = prover.Setup.build(air, const_np, device="cpu")
    text = fib_replies[PORT]["proof"]
    assert text == prover.gen_proof(setup, cm1, publics).to_json()
    assert verifier.verify(air, setup.verkey, StarkProof.from_json(text))


@pytest.mark.parametrize("server_pkg,client_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["port_client_jax_server",
                              "jax_client_port_server"])
def test_cross_package_stream(fib_replies, server_pkg, client_pkg):
    """One package's client against the other's server: the port's client
    serves the fib script to the JAX server as to its own; the JAX client
    answers the port's server's status and decodes its stateless
    request."""
    if client_pkg == PORT:
        svc, decoder = fib_service(PORT)
        with stream(server_pkg, client_pkg, svc, input_decoder=decoder,
                    watchdog_timeout_s=TIMEOUT) as (server, _client):
            assert fib_script(server) == fib_replies[PORT]
        return
    prover = CaptureProver()
    with stream(server_pkg, client_pkg, prover) as (server, _client):
        st = server.ask("st", timeout=TIMEOUT,
                        get_status_request=pb.GetStatusRequest())
        assert st.SerializeToString(deterministic=True) \
            == fib_replies[PORT]["status"]
        reply = server.ask("sl", timeout=TIMEOUT,
                           gen_stateless_batch_proof_request=stateless0())
        assert reply.gen_batch_proof_response.result == pb.RESULT_OK
        assert prover.event.wait(5.0)
        assert fields(prover.requests[0].payload["input"]) == fields(
            devnet.build_devnet_inputs(None, 1)[0])


def stateless0(datastream_batch: int = 0):
    """Devnet batch 0 as GenStatelessBatchProof (the datastream of batch
    `datastream_batch` over the genesis witness)."""
    sb = devnet.devnet_stateless_batch0()
    req = pb.GenStatelessBatchProofRequest()
    pi = req.input.public_inputs
    pi.witness = sb["witness"]
    pi.data_stream = (sb["data_stream"] if not datastream_batch else
                      devnet._devnet_datastream(datastream_batch,
                                                devnet.DEVNET_CHAIN_ID))
    pi.sequencer_addr = sb["sequencer_addr"]
    pi.timestamp_limit = sb["timestamp_limit"]
    return req


def fields(inp) -> dict:
    """A BatchInput of either package as a plain dict."""
    return {f.name: getattr(inp, f.name) for f in dataclasses.fields(inp)}


@pytest.mark.parametrize("datastream_batch", [0, 1],
                         ids=["batch0", "batch1_datastream"])
def test_stateless_batch_input_equal(datastream_batch):
    """Each client decodes the stateless request into the same BatchInput;
    for devnet batch 0 it is ``build_devnet_inputs(...)[0]``.  The
    reference fault the port copies: the decoder sets no old batch
    number, so batch 1's datastream (batch number 2) decodes with 0."""
    inputs = {}
    for pkg in PKGS:
        prover = CaptureProver()
        with stream(pkg, pkg, prover) as (server, _client):
            reply = server.ask("sl", timeout=TIMEOUT,
                               gen_stateless_batch_proof_request=stateless0(
                                   datastream_batch))
            assert reply.gen_batch_proof_response.result == pb.RESULT_OK
            assert reply.gen_batch_proof_response.id == "cap-1"
            assert prover.event.wait(5.0)
            req = prover.requests[0]
            assert req.payload["circuit"] == "batch"
            inputs[pkg] = fields(req.payload["input"])
    assert inputs[PORT] == inputs[JAX]
    assert inputs[PORT]["old_batch_num"] == 0
    if datastream_batch == 0:
        assert inputs[PORT] == fields(devnet.build_devnet_inputs(None, 1)[0])


@pytest.mark.parametrize("pkg", PKGS)
def test_stateless_malformed_is_error(pkg):
    prover = CaptureProver()
    with stream(pkg, pkg, prover) as (server, _client):
        req = pb.GenStatelessBatchProofRequest()
        req.input.public_inputs.data_stream = b"\x01"
        reply = server.ask("sl-e", timeout=TIMEOUT,
                           gen_stateless_batch_proof_request=req)
        assert reply.gen_batch_proof_response.result == pb.RESULT_ERROR
        assert not prover.requests


def cancel_script(pkg: str) -> list:
    """A GenBatchProof held running (its worker waits on a gate), a second
    one pending behind it and cancelled, GetProof of both and of an
    unknown id.  -> the result codes"""
    svc, decoder = fib_service(pkg)
    gate = threading.Event()
    run = svc._dispatch

    def held(req):
        gate.wait(TIMEOUT)
        return run(req)

    svc._dispatch = held
    out = []
    with stream(pkg, pkg, svc, input_decoder=decoder,
                watchdog_timeout_s=TIMEOUT) as (server, _client):
        try:
            ids = [server.ask(f"g{k}", timeout=TIMEOUT,
                              gen_batch_proof_request=pb.GenBatchProofRequest()
                              ).gen_batch_proof_response.id
                   for k in range(2)]
            out.append(svc.get(ids[1]).state.value)
            out.append(server.ask("c1", timeout=TIMEOUT, cancel_request=pb.
                                  CancelRequest(id=ids[1])).cancel_response
                       .result)
            for name, uid in (("p1", ids[1]), ("px", "nonexistent")):
                out.append(server.ask(name, timeout=TIMEOUT,
                                      get_proof_request=pb.GetProofRequest(
                                          id=uid, timeout=1))
                           .get_proof_response.result)
            gate.set()
            out.append(server.ask("p0", timeout=TIMEOUT,
                                  get_proof_request=pb.GetProofRequest(
                                      id=ids[0], timeout=int(TIMEOUT)))
                       .get_proof_response.result)
        finally:
            gate.set()
    return out


def test_cancel_and_unknown_id_equal():
    port, jax = (cancel_script(pkg) for pkg in PKGS)
    assert port == jax == [
        "pending", pb.RESULT_OK, pb.GetProofResponse.RESULT_CANCEL,
        pb.GetProofResponse.RESULT_ERROR,
        pb.GetProofResponse.RESULT_COMPLETED_OK]


@pytest.mark.parametrize("pkg", PKGS)
def test_watchdog_drops_a_stalled_stream(pkg):
    """A GetProof that waits longer than the watchdog: the watchdog closes
    the channel, the reply is lost, the client connects again and serves
    a later request (asked on the newest stream until one answers: an idle
    stream is dropped by the watchdog too)."""
    svc, decoder = fib_service(pkg)
    gate = threading.Event()
    run = svc._dispatch

    def held(req):
        gate.wait(TIMEOUT)
        return run(req)

    svc._dispatch = held
    with stream(pkg, pkg, svc, input_decoder=decoder,
                watchdog_timeout_s=2.0) as (server, _client):
        try:
            uid = server.ask("g", timeout=TIMEOUT, gen_batch_proof_request=pb.
                             GenBatchProofRequest()).gen_batch_proof_response.id
            with pytest.raises(TimeoutError):
                server.ask("stall", timeout=6.0, get_proof_request=pb.
                           GetProofRequest(id=uid, timeout=4))
            assert server.wait_connected(15.0, n=2)
            gate.set()
            for attempt in range(10):
                try:
                    st = server.ask(f"st-{attempt}", timeout=3.0,
                                    client=len(server._clients) - 1,
                                    get_status_request=pb.GetStatusRequest())
                    break
                except TimeoutError:
                    continue
            else:
                pytest.fail("no reply after the client connected again")
            assert st.get_status_response.prover_name == "tpu-prover"
        finally:
            gate.set()


def test_watchdog_equal():
    port, jax = (mod(pkg, "utils.watchdog") for pkg in PKGS)
    fired = {}
    for name, m in (("port", port), ("jax", jax)):
        hits = []
        dog = m.Watchdog(0.2, on_timeout=lambda h=hits: h.append(1)).start()
        try:
            assert not dog.fired
            threading.Event().wait(1.0)
            fired[name] = (dog.fired, len(hits))
        finally:
            dog.stop()
    assert fired["port"] == fired["jax"] == (True, 1)


def run_services_prover(pkg: str) -> list:
    """The reference fault the port copies: the aggregator client of
    ``main.py --run-services`` drives ``ProverService({})``.  A stateless
    batch and a plain batch request are accepted and then fail.  -> the
    GetProof results and their messages"""
    svc = mod(pkg, "prover_service").ProverService({})
    out = []
    with stream(pkg, pkg, svc) as (server, _client):
        for name, kw in (("sl", {"gen_stateless_batch_proof_request":
                                 stateless0()}),
                         ("b", {"gen_batch_proof_request":
                                pb.GenBatchProofRequest()})):
            reply = server.ask(name, timeout=TIMEOUT, **kw)
            assert reply.gen_batch_proof_response.result == pb.RESULT_OK
            got = server.ask(f"gp-{name}", timeout=TIMEOUT,
                             get_proof_request=pb.GetProofRequest(
                                 id=reply.gen_batch_proof_response.id,
                                 timeout=int(TIMEOUT))).get_proof_response
            out.append((got.result, got.result_string))
    return out


def test_run_services_prover_fails_batches_as_the_reference():
    port, jax = (run_services_prover(pkg) for pkg in PKGS)
    assert port == jax == [
        (pb.GetProofResponse.RESULT_INTERNAL_ERROR,
         "PROVER_ERROR: no batch prover engine configured"),
        (pb.GetProofResponse.RESULT_INTERNAL_ERROR,
         "PROVER_ERROR: no setup named 'batch'")]


def test_proof_json_forms_equal():
    """``_proof_json`` / ``_parse_proof`` on a stark proof, a recursive
    proof and a final proof, against the JAX client's."""
    from xlayer_prover_tpu_torch.models.toy import fib
    from xlayer_prover_tpu_torch.recursion.stack import RecursiveProof
    from xlayer_prover_tpu_torch.stark import prover
    air = fib.build_air(n_bits=4, n_queries=2)
    const_np, cm1, publics = fib.gen_trace(air)
    proof = prover.gen_proof(prover.Setup.build(air, const_np, device="cpu"),
                             cm1, publics)
    port, jax = (mod(pkg, "services.aggregator").AggregatorClient
                 for pkg in PKGS)
    jproof = mod(JAX, "stark.proof").StarkProof.from_json(proof.to_json())
    jrec = mod(JAX, "recursion.stack").RecursiveProof(level=2, proof=jproof)
    rec = RecursiveProof(level=2, proof=proof)
    for p, j in ((proof, jproof), (rec, jrec), ({"final": rec},
                                                {"final": jrec})):
        text = port._proof_json(p)
        assert text == jax._proof_json(j)
    parsed = port._parse_proof(port._proof_json(rec))
    assert isinstance(parsed, RecursiveProof) and parsed.level == 2
    assert parsed.proof.to_json() == proof.to_json()
