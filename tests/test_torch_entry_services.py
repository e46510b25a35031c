"""Port parity: the HashDB and executor gRPC services of
xlayer_prover_tpu_torch, its fork registry and full tracer, against the
JAX package's, on the CPU.

Each package serves the same RPC script on its own loopback port, and the
responses must be equal as ``SerializeToString(deterministic=True)``:
HashDB Set/Get/programs/flush/ReadTree/ConsolidateState/ResetDB and the
two ``HashDBRemote`` clients; ProcessBatchV2 and ProcessStatelessBatchV2
on the micro-ROM of tests/test_executor_service.py, on devnet batch 0
(its responses also equal to the committed JAX fixture
tests/data/executor_devnet0.json, its new state root the committed devnet
batch proof's), on devnet batch 0 under fork 8 and under an unsupported
fork id.  The JAX service is built as ``tools/torch_proof_fixtures.
jax_executor_service`` builds it (its registers set per request, as the
port's service sets them); the JAX service as its ``main.py`` builds it
is held failing devnet batch 0.  The full tracer's records, the
opcode-step trace and each fork's ROM must be equal too.  Every server is
stopped and every channel closed in ``finally``."""

import contextlib
import dataclasses
import importlib
import json
import os

import grpc
import pytest
from google.protobuf import empty_pb2

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures
from xlayer_prover_tpu_torch import main as pmain
from xlayer_prover_tpu_torch.executor.executor import Executor
from xlayer_prover_tpu_torch.services import executor_service as pes
from xlayer_prover_tpu_torch.services import hashdb_service as phs
from xlayer_prover_tpu_torch.services.gen import executor_pb2 as epb
from xlayer_prover_tpu_torch.services.gen import hashdb_pb2 as hpb
from xlayer_prover_tpu_torch.state.hashdb import HashDB
from xlayer_prover_tpu_torch.utils import devnet

PKGS = ("xlayer_prover_tpu_torch", "xlayer_prover_tpu")
TIMEOUT = 60.0
A7_BATCH0 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "a7_state_devnet",
    "batch_proof_0vdev0_nb16_q4.json")
NEW_STATE_ROOT = 19                 # publics[19:27]: newStateRoot limbs


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@contextlib.contextmanager
def served(server):
    """`server` started; -> (server, a channel to it); both closed after."""
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
    try:
        yield server, channel
    finally:
        channel.close()
        server.stop()


def _rpc(channel, name, req_cls, resp_cls):
    return channel.unary_unary(
        f"/{phs.SERVICE}/{name}",
        request_serializer=req_cls.SerializeToString,
        response_deserializer=resp_cls.FromString)


# ---------------------------------------------------------------------------
# HashDB
# ---------------------------------------------------------------------------

KEYS = [(1, 0, 0, 0), (2, 0, 0, 0), (3, 5, 7, 11), (1 << 40, 9, 0, 1)]
VALUES = [7, 1 << 200, 12345, 0]


def hashdb_script(channel) -> list:
    """One RPC script over a HashDB service: every response's
    deterministic bytes, in order."""
    out = []

    def call(name, req, req_cls, resp_cls):
        resp = _rpc(channel, name, req_cls, resp_cls)(req, timeout=TIMEOUT)
        out.append((name, resp.SerializeToString(deterministic=True)))
        return resp

    root = (0, 0, 0, 0)
    call("StartBlock", hpb.StartBlockRequest(batch_uuid="b1",
                                             old_state_root="0x0"),
         hpb.StartBlockRequest, empty_pb2.Empty)
    for key, value in zip(KEYS, VALUES):
        req = hpb.SetRequest(batch_uuid="b1", value=f"{value:x}")
        phs._set_fea(req.old_root, root)
        phs._set_fea(req.key, key)
        root = phs._fea(call("Set", req, hpb.SetRequest,
                             hpb.SetResponse).new_root)
    call("FinishTx", hpb.FinishTxRequest(batch_uuid="b1",
                                         new_state_root="0x1"),
         hpb.FinishTxRequest, empty_pb2.Empty)
    for key in KEYS:
        req = hpb.GetRequest(batch_uuid="b1")
        phs._set_fea(req.root, root)
        phs._set_fea(req.key, key)
        call("Get", req, hpb.GetRequest, hpb.GetResponse)
    req = hpb.SetProgramRequest(batch_uuid="b1", data=b"\x60\x80\x60\x40")
    phs._set_fea(req.key, (9, 8, 7, 6))
    call("SetProgram", req, hpb.SetProgramRequest, hpb.SetProgramResponse)
    for key in ((9, 8, 7, 6), (1, 1, 1, 1)):
        req = hpb.GetProgramRequest(batch_uuid="b1")
        phs._set_fea(req.key, key)
        call("GetProgram", req, hpb.GetProgramRequest,
             hpb.GetProgramResponse)
    call("FinishBlock", hpb.FinishBlockRequest(batch_uuid="b1",
                                               new_state_root="0x1"),
         hpb.FinishBlockRequest, empty_pb2.Empty)
    flush = call("Flush", hpb.FlushRequest(batch_uuid="b1"),
                 hpb.FlushRequest, hpb.FlushResponse)
    call("GetFlushStatus", empty_pb2.Empty(), empty_pb2.Empty,
         hpb.GetFlushStatusResponse)
    call("GetLatestStateRoot", empty_pb2.Empty(), empty_pb2.Empty,
         hpb.GetLatestStateRootResponse)
    call("GetFlushData", hpb.GetFlushDataRequest(flush_id=flush.flush_id),
         hpb.GetFlushDataRequest, hpb.GetFlushDataResponse)
    req = hpb.ReadTreeRequest()
    phs._set_fea(req.state_root, root)
    for key in (*KEYS, (4, 4, 4, 4)):
        phs._set_fea(req.keys.add(), key)
    call("ReadTree", req, hpb.ReadTreeRequest, hpb.ReadTreeResponse)
    req = hpb.ConsolidateStateRequest()
    phs._set_fea(req.virtual_state_root, root)
    call("ConsolidateState", req, hpb.ConsolidateStateRequest,
         hpb.ConsolidateStateResponse)
    call("Purge", hpb.PurgeRequest(batch_uuid="b2"), hpb.PurgeRequest,
         hpb.PurgeResponse)
    call("CancelBatch", hpb.CancelBatchRequest(batch_uuid="b3"),
         hpb.CancelBatchRequest, hpb.CancelBatchResponse)
    load = hpb.LoadDBRequest()
    load.input_db[f"{5:064x}"].fe.extend(range(12))
    call("LoadDB", load, hpb.LoadDBRequest, empty_pb2.Empty)
    load = hpb.LoadProgramDBRequest()
    load.input_program_db[f"{6:064x}"] = b"\x01\x02"
    call("LoadProgramDB", load, hpb.LoadProgramDBRequest, empty_pb2.Empty)
    for key in ((6, 0, 0, 0), (9, 8, 7, 6)):
        req = hpb.GetProgramRequest()
        phs._set_fea(req.key, key)
        call("GetProgram", req, hpb.GetProgramRequest,
             hpb.GetProgramResponse)
    call("ResetDB", empty_pb2.Empty(), empty_pb2.Empty,
         hpb.ResetDBResponse)
    req = hpb.GetRequest()
    phs._set_fea(req.root, root)
    phs._set_fea(req.key, KEYS[0])
    call("Get", req, hpb.GetRequest, hpb.GetResponse)
    call("GetLatestStateRoot", empty_pb2.Empty(), empty_pb2.Empty,
         hpb.GetLatestStateRootResponse)
    return out


@pytest.fixture(scope="module")
def hashdb_answers():
    """Each package's HashDB server's answers to ``hashdb_script``."""
    out = {}
    for pkg in PKGS:
        svc = mod(pkg, "services.hashdb_service")
        with served(svc.HashDBServer(svc.HashDBServiceImpl())) as (_s, ch):
            out[pkg] = hashdb_script(ch)
    return out


def test_hashdb_rpcs_equal(hashdb_answers):
    port, jax = (hashdb_answers[p] for p in PKGS)
    assert [n for n, _ in port] == [n for n, _ in jax]
    for (name, a), (_, b) in zip(port, jax):
        assert a == b, name


def test_hashdb_script_reaches_the_state(hashdb_answers):
    """The script's answers are not vacuous: every Set and Get succeeds,
    the Gets read the values set, ReadTree returns every key's value and
    the nodes on its path, ResetDB empties the store."""
    answers = hashdb_answers[PKGS[0]]
    gets = [hpb.GetResponse.FromString(b) for n, b in answers if n == "Get"]
    assert [int(g.value, 16) for g in gets[:4]] == VALUES
    assert all(g.result.code == hpb.ResultCode.CODE_SUCCESS
               for g in gets[:4])
    tree = hpb.ReadTreeResponse.FromString(
        next(b for n, b in answers if n == "ReadTree"))
    assert [int(kv.value, 16) for kv in tree.key_value] == [*VALUES, 0]
    assert len(tree.hash_value) > len(KEYS)
    programs = [hpb.GetProgramResponse.FromString(b)
                for n, b in answers if n == "GetProgram"]
    assert programs[0].data == b"\x60\x80\x60\x40"
    assert programs[1].result.code == hpb.ResultCode.CODE_DB_KEY_NOT_FOUND
    assert programs[2].data == b"\x01\x02"
    assert gets[-1].result.code == hpb.ResultCode.CODE_INTERNAL_ERROR


@pytest.mark.parametrize("server_pkg", PKGS)
def test_hashdb_remote_clients_equal(server_pkg):
    """The port's and the JAX package's HashDBRemote, each against one
    server: the same roots, values, programs and flush data."""
    svc = mod(server_pkg, "services.hashdb_service")
    with served(svc.HashDBServer(svc.HashDBServiceImpl())) as (server, _c):
        results = []
        for pkg in PKGS:
            remote = mod(pkg, "services.hashdb_service").HashDBRemote(
                "127.0.0.1", server.port)
            try:
                uuid = f"r-{pkg}"
                root = (0, 0, 0, 0)
                out = []
                for key, value in zip(KEYS, VALUES):
                    res = remote.set(uuid, root, key, value)
                    root = res.new_root
                    out.append((res.old_root, res.new_root, res.mode))
                out += [remote.get(uuid, root, k).value for k in KEYS]
                remote.set_program(uuid, (1, 2, 3, 4), b"\xfe")
                out.append(remote.get_program(uuid, (1, 2, 3, 4)))
                out.append(remote.get_program(uuid, (4, 3, 2, 1)))
                remote.consolidate(uuid)
                out.append(remote.get_flush_data(1))
                remote.discard(uuid)
                results.append(out)
            finally:
                remote._channel.close()
    assert results[0] == results[1]
    assert results[0][len(KEYS):2 * len(KEYS)] == VALUES


# ---------------------------------------------------------------------------
# Executor service
# ---------------------------------------------------------------------------

MICRO_PROG = [{"CONST": 3, "setC": 1}, {"CONST": 7, "setD": 1},
              {"sWR": 1}, {"CONST": 0}]
MICRO_LABELS = {"start": 0, "finalizeExecution": 3}


def port_executor_service(rom=None):
    """The port's ExecutorServiceImpl as its ``main.py --run-services``
    builds it (``rom`` None: the fork_9 ROM)."""
    if rom is None:
        rom, machine = pmain._load_rom(None)
    else:
        from xlayer_prover_tpu_torch.executor import rom_functions as rf
        from xlayer_prover_tpu_torch.executor.main_sm import MainExecutor
        machine = MainExecutor(rom, max_steps=1 << 23)
        rf.register_all(machine)
    executor = Executor.__new__(Executor)
    executor.rom, executor.main = rom, machine
    executor.start_label, executor.stop_label = "start", "finalizeExecution"
    return pes.ExecutorServiceImpl(executor, HashDB())


def micro_rom(pkg: str):
    return mod(pkg, "executor.rom").Rom.from_json(
        {"program": MICRO_PROG, "labels": MICRO_LABELS, "constants": {}})


def executor_requests(case: str) -> list:
    """(method, request) pairs of one case, in the order a fresh service
    takes them."""
    stateless, batch = devnet.devnet0_executor_requests()
    if case == "micro_rom":
        return [("ProcessBatchV2", epb.ProcessBatchRequestV2(
                    old_state_root=b"\x00" * 32, batch_l2_data=b"\x01\x02",
                    context_id="micro")),
                ("ProcessStatelessBatchV2", stateless)]
    if case == "devnet0":
        return [("ProcessStatelessBatchV2", stateless),
                ("ProcessBatchV2", batch)]
    fork = {"devnet0_fork8": 8, "devnet0_fork77": 77}[case]
    other = epb.ProcessBatchRequestV2()
    other.CopyFrom(batch)
    other.fork_id = fork
    other.context_id = f"{batch.context_id}-fork{fork}"
    return [("ProcessStatelessBatchV2", stateless),
            ("ProcessBatchV2", other)]


def serve_executor(impl, requests) -> list:
    """`requests` sent over loopback gRPC to `impl`'s server: each
    response's deterministic bytes."""
    server = impl_server(impl)
    with served(server) as (_s, channel):
        calls = {"ProcessBatchV2": (epb.ProcessBatchRequestV2,),
                 "ProcessStatelessBatchV2":
                     (epb.ProcessStatelessBatchRequestV2,)}
        out = []
        for method, req in requests:
            rpc = channel.unary_unary(
                f"/{pes.SERVICE}/{method}",
                request_serializer=calls[method][0].SerializeToString,
                response_deserializer=epb.ProcessBatchResponseV2.FromString)
            out.append(rpc(req, timeout=TIMEOUT).SerializeToString(
                deterministic=True))
        flush = channel.unary_unary(
            f"/{pes.SERVICE}/GetFlushStatus",
            request_serializer=empty_pb2.Empty.SerializeToString,
            response_deserializer=epb.GetFlushStatusResponse.FromString)
        out.append(flush(empty_pb2.Empty(), timeout=TIMEOUT)
                   .SerializeToString(deterministic=True))
    return out


def impl_server(impl):
    for pkg in PKGS:
        svc = mod(pkg, "services.executor_service")
        if isinstance(impl, svc.ExecutorServiceImpl):
            return svc.ExecutorServer(impl)
    raise TypeError(type(impl))


CASES = ("micro_rom", "devnet0", "devnet0_fork8", "devnet0_fork77")


@pytest.fixture(scope="module")
def executor_answers():
    """case -> package -> the responses to ``executor_requests(case)``."""
    out = {}
    for case in CASES:
        reqs = executor_requests(case)
        if case == "micro_rom":
            port = port_executor_service(micro_rom(PKGS[0]))
            jax = fixtures.jax_executor_service(micro_rom(PKGS[1]))
        else:
            port = port_executor_service()
            jax = fixtures.jax_executor_service()
        out[case] = {PKGS[0]: serve_executor(port, reqs),
                     PKGS[1]: serve_executor(jax, reqs)}
    return out


@pytest.mark.parametrize("case", CASES)
def test_executor_responses_equal(executor_answers, case):
    port, jax = (executor_answers[case][p] for p in PKGS)
    assert port == jax


def _responses(answers) -> list:
    return [epb.ProcessBatchResponseV2.FromString(b) for b in answers[:-1]]


def test_executor_cases_are_what_they_say(executor_answers):
    """Devnet batch 0 reaches its new state root under forks 9 and 8 with
    one block and one transaction; the micro-ROM writes one slot; the
    unsupported fork is refused as such."""
    with open(A7_BATCH0) as f:
        publics = json.loads(json.load(f)["proof"])["publics"]
    limbs = [int(v) for v in publics[NEW_STATE_ROOT:NEW_STATE_ROOT + 8]]
    want = sum(v << (32 * i) for i, v in enumerate(limbs)).to_bytes(32, "big")
    for case in ("devnet0", "devnet0_fork8"):
        stateless, batch = _responses(executor_answers[case][PKGS[0]])
        if case == "devnet0":
            assert stateless.error == epb.EXECUTOR_ERROR_NO_ERROR
            assert stateless.new_state_root == want
        assert batch.error == epb.EXECUTOR_ERROR_NO_ERROR
        assert batch.new_state_root == want
        assert batch.cnt_steps == 6589 and batch.fork_id == 9 - (
            case == "devnet0_fork8")
        assert len(batch.block_responses) == 1
        assert len(batch.block_responses[0].responses) == 1
    micro, _ = _responses(executor_answers["micro_rom"][PKGS[0]])
    assert micro.error == epb.EXECUTOR_ERROR_NO_ERROR
    assert micro.new_state_root != b"\x00" * 32
    assert micro.cnt_poseidon_hashes == 4
    _, refused = _responses(executor_answers["devnet0_fork77"][PKGS[0]])
    assert refused.error == epb.EXECUTOR_ERROR_UNSUPPORTED_FORK_ID


def test_executor_devnet0_equals_the_fixture(executor_answers):
    """Devnet batch 0's two responses equal the JAX package's, committed
    as tests/data/executor_devnet0.json (chip_smoke.py phase 11 reads
    them too)."""
    want = fixtures.read_executor_devnet0()
    got = executor_answers["devnet0"][PKGS[0]]
    assert got[:2] == [want["process_stateless_batch_v2"],
                       want["process_batch_v2"]]


@pytest.mark.slow
def test_executor_devnet0_fixture_derived_again():
    text = fixtures.executor_devnet0_jax()
    with open(os.path.join(fixtures.DATA, f"{fixtures.EXECUTOR}.json")) as f:
        assert f.read() == text


def test_jax_run_services_executor_fails_devnet0():
    """The reference fault the port mends (ROADMAP queue 3): the JAX
    package's executor service as its main.py builds it has no labels and
    sets no registers, so devnet batch 0 comes back as an error with no
    state root; the port's answers the batch."""
    from xlayer_prover_tpu import main as jmain
    from xlayer_prover_tpu.executor.executor import Executor as JExecutor
    from xlayer_prover_tpu.services.executor_service import \
        ExecutorServiceImpl as JImpl
    from xlayer_prover_tpu.state.hashdb import HashDB as JHashDB
    rom, machine = jmain._load_rom(None)
    executor = JExecutor.__new__(JExecutor)
    executor.rom, executor.main = rom, machine
    impl = JImpl(executor, JHashDB())
    stateless, batch = devnet.devnet0_executor_requests()
    for method, req in (("process_stateless_batch_v2", stateless),
                        ("process_batch_v2", batch)):
        resp = getattr(impl, method)(req, None)
        assert resp.error == epb.EXECUTOR_ERROR_UNSPECIFIED
        assert resp.new_state_root == b""
    # with its labels set but no registers, a ROM assert still refuses it
    executor.start_label, executor.stop_label = "start", "finalizeExecution"
    resp = JImpl(executor, JHashDB()).process_stateless_batch_v2(stateless,
                                                                 None)
    assert resp.error == epb.EXECUTOR_ERROR_UNSPECIFIED
    resp = port_executor_service().process_stateless_batch_v2(stateless,
                                                              None)
    assert resp.error == epb.EXECUTOR_ERROR_NO_ERROR


def test_executor_error_path_equal():
    """A ROM that asserts falsely: both services answer the same error."""
    prog = [{"CONST": 1, "setA": 1}, {"CONST": 2, "assert": 1},
            {"CONST": 0}]
    labels = {"start": 0, "finalizeExecution": 2}
    answers = []
    for pkg, build in ((PKGS[0], port_executor_service),
                       (PKGS[1], fixtures.jax_executor_service)):
        rom = mod(pkg, "executor.rom").Rom.from_json(
            {"program": prog, "labels": labels, "constants": {}})
        resp = build(rom).process_batch_v2(
            epb.ProcessBatchRequestV2(old_state_root=b"\x00" * 32), None)
        answers.append(resp.SerializeToString(deterministic=True))
    assert answers[0] == answers[1]
    assert epb.ProcessBatchResponseV2.FromString(answers[0]).error \
        == epb.EXECUTOR_ERROR_UNSPECIFIED


def test_make_client_equal():
    """``make_client``'s three calls against the port's server."""
    impl = port_executor_service(micro_rom(PKGS[0]))
    with served(pes.ExecutorServer(impl)) as (server, _c):
        for pkg in PKGS:
            process, flush, stateless = mod(
                pkg, "services.executor_service").make_client(server.port)
            resp = process(epb.ProcessBatchRequestV2(
                old_state_root=b"\x00" * 32, context_id=f"mc-{pkg}"),
                timeout=TIMEOUT)
            assert resp.error == epb.EXECUTOR_ERROR_NO_ERROR
            assert flush(empty_pb2.Empty(), timeout=TIMEOUT).last_flush_id \
                == impl.flushes
            assert stateless(epb.ProcessStatelessBatchRequestV2(),
                             timeout=TIMEOUT).error \
                == epb.EXECUTOR_ERROR_UNSPECIFIED


# ---------------------------------------------------------------------------
# Full tracer and forks
# ---------------------------------------------------------------------------

def traced_devnet0(pkg: str, trace_config: dict):
    """Devnet batch 0 executed by `pkg`'s fork_9 interpreter under a
    FullTracer (``trace_config`` its TraceConfig).  -> the BatchTrace as a
    dict"""
    rom, machine = mod(pkg, "main")._load_rom(None)
    ft = mod(pkg, "executor.full_tracer")
    batch0 = devnet.build_devnet_inputs(None, 1)[0]
    inp = mod(pkg, "executor.input").BatchInput(
        **{f.name: getattr(batch0, f.name)
           for f in dataclasses.fields(batch0)})
    hashdb = mod(pkg, "state.hashdb").HashDB()
    inp.load_db(hashdb)
    ctx = mod(pkg, "executor.main_sm").Context(rom, hashdb,
                                               input_vars=inp.input_vars())
    inp.setup_registers(ctx)
    ctx.full_tracer = ft.FullTracer(rom, ft.TraceConfig(**trace_config))
    machine.execute(ctx)
    return dataclasses.asdict(ctx.full_tracer.batch)


@pytest.mark.parametrize("trace_config", [
    {}, {"enabled": True, "enable_memory": True}],
    ids=["events", "opcode_steps"])
def test_full_tracer_equal(trace_config):
    port, jax = (traced_devnet0(pkg, trace_config) for pkg in PKGS)
    assert port == jax
    tx = port["blocks"][0]["responses"][0]
    assert tx["opcodes"] > 0 and port["gas_used"] > 0
    assert len(port["blocks"]) == 1 and port["new_state_root"] > 0
    assert bool(tx["steps"]) == bool(trace_config)


def test_full_tracer_event_names_equal():
    """The event dispatch's name mapping, and the tracer's tables."""
    port, jax = (mod(pkg, "executor.full_tracer") for pkg in PKGS)
    for name in ("onStartBatch", "onFinishTx", "onUpdateStorage",
                 "onOpcode", "onError", "storeLog", "onFinishBlock"):
        assert port._snake(name) == jax._snake(name)
    assert port.INVALID_BATCH_ERRORS == jax.INVALID_BATCH_ERRORS
    assert (port.FullTracer._CALL_OPS, port.FullTracer._RET_OPS) == (
        jax.FullTracer._CALL_OPS, jax.FullTracer._RET_OPS)


@pytest.mark.parametrize("fork", range(1, 10))
def test_fork_rom_equal(fork):
    """Each fork's bundled ROM, loaded through the registry, equals the
    JAX package's line for line."""
    port, jax = (mod(pkg, "executor.forks").ForkRegistry() for pkg in PKGS)
    assert port.supported(fork) and jax.supported(fork)
    a, b = port.rom(fork), jax.rom(fork)
    assert (a.labels, a.constants) == (b.labels, b.constants)
    assert [dataclasses.asdict(x) for x in a.program] == \
        [dataclasses.asdict(x) for x in b.program]


def test_fork_registry_refuses_unknown_forks():
    port = mod(PKGS[0], "executor.forks")
    assert port.SUPPORTED_FORKS == mod(PKGS[1], "executor.forks") \
        .SUPPORTED_FORKS
    reg = port.ForkRegistry()
    assert reg.rom(0) is None and reg.executor(77) is None
    assert reg.executor(9) is reg.executor(9)


@pytest.mark.parametrize("trace", [False, True], ids=["fast", "traced"])
def test_process_batch_equal(trace):
    """``Executor.process_batch``, the execute-only path, on the
    micro-ROM: the same registers, counters, storage actions and, when
    traced, the same per-step records as the JAX package's (its native
    core turned off: the port has the Python interpreter alone)."""
    ctxs = []
    for pkg in PKGS:
        rom = micro_rom(pkg)
        ex_mod = mod(pkg, "executor.executor")
        main_sm = mod(pkg, "executor.main_sm")
        executor = ex_mod.Executor.__new__(ex_mod.Executor)
        executor.rom = rom
        executor.main = main_sm.MainExecutor(rom, max_steps=64)
        executor.start_label, executor.stop_label = "start", \
            "finalizeExecution"
        if pkg == PKGS[1]:
            executor._native = False
        ctxs.append(executor.process_batch(
            mod(pkg, "state.hashdb").HashDB(), batch_uuid="pb",
            input_vars={"oldStateRoot": 0}, trace=trace))
    port, jax = ctxs
    assert list(port.regs.SR) == list(jax.regs.SR) and any(port.regs.SR)
    assert dataclasses.asdict(port.counters) == dataclasses.asdict(
        jax.counters)
    assert [dataclasses.asdict(a) for a in port.required.storage] == \
        [dataclasses.asdict(a) for a in jax.required.storage]
    assert len(port.required.storage) == 1
    assert (port.trace is None) == (jax.trace is None) == (not trace)
    if trace:
        assert port.trace == jax.trace and len(port.trace) == 3
