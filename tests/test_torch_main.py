"""Port parity: the entry point ``xlayer_prover_tpu_torch/main.py``
against the JAX package's ``main.py``, on the CPU.

Every mode dispatches to the same command in both packages (the port's
commands that prove get ``--device``); ``--prove-toy --device cpu`` and
``--process-batch`` on devnet batch 0 (written in the reference's input
format by ``utils/devnet.input_json``) print the JAX main's JSON apart
from its seconds; the script generators write the same files; the
executor client counts the answers without an error (the JAX client
counts those with error 0, EXECUTOR_ERROR_UNSPECIFIED: ROADMAP queue 3);
the
state backends of ROADMAP item 17 are served and their self-tests run
the port's test modules, the self-test of unported code is refused;
``chip_smoke.py`` phase 11's file mode and its ``--run-services``
process run here on the CPU.  ``--gen-batch-proof`` and
``--prove-from-cmpols`` prove devnet batch 0 at 2^16 and are in the slow
tier (over an hour on the CPU)."""

import contextlib
import importlib
import io
import json
import os
import sys

import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401
from xlayer_prover_tpu_torch import main as pmain
from xlayer_prover_tpu_torch.utils import devnet

PORT, JAX = PKGS = ("xlayer_prover_tpu_torch", "xlayer_prover_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = ("cmd_process_batch", "cmd_gen_batch_proof",
            "cmd_prove_from_cmpols", "cmd_prove_toy", "cmd_run_services",
            "cmd_script_generators", "cmd_self_tests", "cmd_executor_client")


def mod(pkg: str, name: str = "main"):
    return importlib.import_module(f"{pkg}.{name}")


def run_main(pkg: str, argv) -> tuple[int, str]:
    """`pkg`'s main(argv) in this process.  -> (rc, its standard output)"""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod(pkg).main(argv)
    return rc, out.getvalue()


def config_file(tmp_path, name: str, **cfg) -> str:
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


DISPATCH = [
    (["--process-batch", "in.json"], {}, "cmd_process_batch"),
    (["--gen-batch-proof", "in.json", "--n-bits", "12"], {},
     "cmd_gen_batch_proof"),
    (["--prove-from-cmpols", "cm.npz"], {}, "cmd_prove_from_cmpols"),
    (["--prove-toy"], {}, "cmd_prove_toy"),
    ([], {"runKeccakScriptGenerator": True}, "cmd_script_generators"),
    ([], {"runSHA256ScriptGenerator": True}, "cmd_script_generators"),
    ([], {"runExecutorClient": True}, "cmd_executor_client"),
    ([], {"runExecutorClientMultithread": True}, "cmd_executor_client"),
    ([], {"runKeccakTest": True}, "cmd_self_tests"),
    ([], {"runBlakeTest": True}, "cmd_self_tests"),
    (["--run-services"], {}, "cmd_run_services"),
    ([], {"runExecutorServer": True}, "cmd_run_services"),
    ([], {"runAggregatorClient": True}, "cmd_run_services"),
    ([], {"runHashDBServer": True}, "cmd_run_services"),
    ([], {}, None),
]


@pytest.mark.parametrize("argv,cfg,command", DISPATCH,
                         ids=[f"{i}-{d[2] or 'help'}"
                              for i, d in enumerate(DISPATCH)])
def test_mode_dispatch(tmp_path, monkeypatch, argv, cfg, command):
    """Each package dispatches the same argv and config to the same
    command; the port's proving commands get the device asked for."""
    path = config_file(tmp_path, "cfg", **cfg)
    chosen = {}

    def recorder(pkg, name):
        def command(*args):
            chosen[pkg] = (name, args)
            return 0
        return command

    for pkg in PKGS:
        m = mod(pkg)
        for name in COMMANDS:
            monkeypatch.setattr(m, name, recorder(pkg, name))
        rc, _out = run_main(pkg, ["-c", path, *argv, *(
            ["--device", "cpu"] if pkg == PORT else [])])
        assert rc == (0 if command else 1)
    if command is None:
        assert not chosen
        return
    assert chosen[PORT][0] == chosen[JAX][0] == command
    port_args, jax_args = chosen[PORT][1][1:], chosen[JAX][1][1:]
    if command in ("cmd_gen_batch_proof", "cmd_prove_from_cmpols",
                   "cmd_prove_toy", "cmd_run_services"):
        assert port_args == (*jax_args, "cpu")
    else:
        assert port_args == jax_args


def test_device_defaults_to_the_card(monkeypatch):
    seen = []
    monkeypatch.setattr(pmain, "cmd_prove_toy",
                        lambda cfg, device: seen.append(device) or 0)
    assert pmain.main(["--prove-toy"]) == 0
    assert seen == ["cuda"]


def _without_seconds(line: str) -> dict:
    out = json.loads(line)
    for key in ("seconds", "steps_per_s", "prove_s", "verify_s"):
        assert key not in out or out.pop(key) >= 0
    return out


def test_prove_toy_equal():
    port = run_main(PORT, ["--prove-toy", "--device", "cpu"])
    jax = run_main(JAX, ["--prove-toy"])
    assert port[0] == jax[0] == 0
    assert _without_seconds(port[1]) == _without_seconds(jax[1]) == {
        "proof_bytes": _without_seconds(jax[1])["proof_bytes"],
        "verified": True}


@pytest.fixture(scope="module")
def devnet0_file(tmp_path_factory):
    """Devnet batch 0 in the reference's input format."""
    path = tmp_path_factory.mktemp("entry") / "devnet_batch0.json"
    path.write_text(json.dumps(devnet.input_json(
        devnet.build_devnet_inputs(None, 1)[0])))
    return str(path)


def test_input_json_round_trips(devnet0_file):
    """The input file reads back as devnet batch 0 in both packages."""
    want = devnet.build_devnet_inputs(None, 1)[0]
    for pkg in PKGS:
        inp = mod(pkg, "executor.input").BatchInput.load(devnet0_file)
        for name in ("old_state_root", "old_acc_input_hash", "old_batch_num",
                     "chain_id", "fork_id", "batch_l2_data",
                     "sequencer_addr", "timestamp_limit"):
            assert getattr(inp, name) == getattr(want, name), name
        db = mod(pkg, "state.hashdb").HashDB()
        inp.load_db(db)
        assert db.db.nodes == {k: list(v) for k, v in want.db_raw.items()}
        assert db.db.programs == want.programs_raw


def test_process_batch_equal(devnet0_file):
    port = run_main(PORT, ["--process-batch", devnet0_file])
    jax = run_main(JAX, ["--process-batch", devnet0_file])
    assert port[0] == jax[0] == 0
    got = _without_seconds(port[1])
    assert got == _without_seconds(jax[1])
    assert got["steps"] == 6589 and got["storage_ops"] > 0


def test_script_generators_equal(tmp_path):
    """runKeccakScriptGenerator / runSHA256ScriptGenerator: the same
    script files and the same JSON line."""
    outs = {}
    for pkg in PKGS:
        files = {k: str(tmp_path / f"{pkg}_{k}.json")
                 for k in ("keccak", "sha256")}
        path = config_file(tmp_path, pkg, runKeccakScriptGenerator=True,
                           runSHA256ScriptGenerator=True,
                           keccakScriptFile=files["keccak"],
                           sha256ScriptFile=files["sha256"])
        rc, line = run_main(pkg, ["-c", path])
        assert rc == 0
        docs = {}
        for k, f in files.items():
            with open(f) as fh:
                docs[k] = json.load(fh)
        outs[pkg] = (json.loads(line), docs)
    port, jax = outs[PORT], outs[JAX]
    assert port[1] == jax[1]
    assert [v["gates"] for v in port[0].values()] == \
        [v["gates"] for v in jax[0].values()]
    assert port[1]["keccak"]["nGates"] > 0


@pytest.mark.parametrize("key,value", [
    ("hashDB64", True), ("databaseURL", "postgresql://db/state"),
    ("databaseURL", "state.sqlite"), ("dbCacheSynchURL", "loopback"),
    ("loadDBToMemCache", True)])
def test_run_services_serves_state_backends(tmp_path, monkeypatch, key,
                                            value):
    """``main.py --run-services --device cpu`` with a key of the state
    backends (ROADMAP item 17): the HashDB service runs over the backend
    the key selects and stops on SIGINT with 0 (the cached stack closed,
    its flushed generations stored); a postgres DSN fails on the missing
    driver as in the JAX package; hashDB64 hashes on the device asked
    for, and without --device on the card, which is not here."""
    from tests.test_torch_config import _free_port, run_services
    if value == "state.sqlite":
        value = str(tmp_path / value)
    if value == "loopback":
        value = f"127.0.0.1:{_free_port()}"
    extra = {"databaseURL": str(tmp_path / "warm.sqlite")} \
        if key in ("dbCacheSynchURL", "loadDBToMemCache") else {}
    path = config_file(tmp_path, "cfg", runHashDBServer=True,
                       hashDBServerPort=0, hashDBFolder=str(tmp_path / "h"),
                       **extra, **{key: value})
    seen = []
    monkeypatch.setattr(pmain, "cmd_run_services",
                        lambda cfg, device: seen.append((cfg, device)))
    pmain.main(["-c", path, "--run-services", "--device", "cpu"])
    pmain.main(["-c", path, "--run-services"])
    monkeypatch.undo()
    (cfg, device), (_cfg, default) = seen
    assert (device, default) == ("cpu", "cuda")
    if key == "databaseURL" and value.startswith("postgresql"):
        with pytest.raises(ModuleNotFoundError, match="psycopg2"):
            run_services(pmain, cfg, monkeypatch, device=device)
        return
    made, rc = run_services(pmain, cfg, monkeypatch, device=device)
    backend = made["impl"][0].hashdb
    assert rc == 0 and len(made["synch"]) == (key == "dbCacheSynchURL")
    if key == "hashDB64":
        assert type(backend).__name__ == "HashDB64"
        assert backend.sm.smt.device.type == "cpu"
        if not pmain_cuda():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run_services(pmain, cfg, monkeypatch, device=default)
    else:
        assert type(backend.db).__name__ == "CachedDB"
        assert not backend.db.multi_write._thread.is_alive()


def pmain_cuda() -> bool:
    import torch
    return torch.cuda.is_available()


@pytest.mark.parametrize("flag", ["runBlakeTest"])
def test_self_tests_of_unported_code_refused(tmp_path, flag):
    path = config_file(tmp_path, "cfg", **{flag: True})
    with pytest.raises(ValueError, match="not ported"):
        pmain.main(["-c", path])


@pytest.mark.parametrize("flag,target", [
    ("runDatabaseCacheTest", "tests/test_torch_db_caches.py"),
    ("runDatabasePerformanceTest", "tests/test_torch_db_caches.py"),
    ("runPageManagerTest", "tests/test_torch_state64.py"),
    ("runKeyValueTreeTest", "tests/test_torch_state64.py"),
    ("runSMT64Test", "tests/test_torch_state64.py")])
def test_self_tests_of_the_state_backends(tmp_path, monkeypatch, flag,
                                          target):
    """The self-tests of ROADMAP item 17's modules run the port's test
    module of that module."""
    import subprocess
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda args, cwd: calls.append((args, cwd)) or 0)
    path = config_file(tmp_path, "cfg", **{flag: True})
    assert pmain.main(["-c", path]) == 0
    (args, cwd), = calls
    assert cwd == ROOT and args[args.index("not slow") + 1:] == [target]


def test_self_tests_run_the_port_modules(tmp_path, monkeypatch):
    """runHashDBTest and runUnitTest run the port's own test modules."""
    import subprocess
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda args, cwd: calls.append((args, cwd)) or 0)
    path = config_file(tmp_path, "cfg", runHashDBTest=True,
                       runUnitTest=True)
    assert pmain.main(["-c", path]) == 0
    (args, cwd), = calls
    targets = args[args.index("not slow") + 1:]
    assert cwd == ROOT and "tests/test_torch_entry_services.py" in targets
    assert all(t.startswith("tests/test_torch_") for t in targets)
    assert "tests/test_torch_main.py" in targets
    assert len(targets) == len(set(targets))


def test_executor_client(tmp_path):
    """runExecutorClient against the port's executor server: the port's
    client counts the answers without an error, and none from a ROM that
    fails.  The JAX client counts the answers with error 0,
    EXECUTOR_ERROR_UNSPECIFIED, and not those with EXECUTOR_ERROR_NO_ERROR
    (1): a reference fault the port mends."""
    from tests.test_torch_entry_services import (micro_rom,
                                                 port_executor_service,
                                                 served)
    from xlayer_prover_tpu_torch.services.executor_service import \
        ExecutorServer
    from xlayer_prover_tpu_torch.executor.rom import Rom
    inp = tmp_path / "input.json"
    inp.write_text(json.dumps({"oldStateRoot": "0x" + "00" * 32,
                               "batchL2Data": "0x0102", "chainID": 1,
                               "forkID": 9}))
    bad = Rom.from_json({"program": [{"CONST": 1, "setA": 1},
                                     {"CONST": 2, "assert": 1},
                                     {"CONST": 0}],
                         "labels": {"start": 0, "finalizeExecution": 2},
                         "constants": {}})
    counts = {}
    for name, rom in (("ok", micro_rom(PORT)), ("failing", bad)):
        impl = port_executor_service(rom)
        with served(ExecutorServer(impl)) as (server, _channel):
            path = config_file(tmp_path, name, runExecutorClient=True,
                               executorClientPort=server.port,
                               executorClientLoops=2,
                               inputFile=str(inp))
            for pkg in PKGS:
                rc, line = run_main(pkg, ["-c", path])
                assert rc == 0
                counts[(name, pkg)] = json.loads(line)["ok_responses"]
    assert counts == {("ok", PORT): 2, ("ok", JAX): 0,
                      ("failing", PORT): 0, ("failing", JAX): 2}


def test_main_file_mode_as_a_process():
    """chip_smoke.py phase 11 (a) on the CPU: ``main.py --prove-toy`` as a
    process says verified."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    out = chip_smoke.entry_file_mode("cpu")
    assert out["line"]["verified"] is True and out["start_s"] > 0


def test_run_services_as_a_process(tmp_path):
    """chip_smoke.py phase 11 (b) on the CPU: ``main.py --run-services``
    as a process answers HashDB, executor (devnet batch 0, equal to the
    JAX fixture) and status calls, fails GenStatelessBatchProof as the JAX
    main does, and exits with 0 on SIGINT."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    report = chip_smoke.entry_services(str(tmp_path))
    assert report["steps"] == 6589 and report["flush_id"] == 1
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["runHashDBServer"] and cfg["runExecutorServer"] \
        and cfg["runAggregatorClient"]


@pytest.mark.slow
def test_gen_batch_proof_and_prove_from_cmpols_equal(tmp_path, devnet0_file):
    """--gen-batch-proof with saveProofToFile and zkevmCmPols, then
    --prove-from-cmpols over the saved trace, on devnet batch 0 at 2^16
    (the port on the CPU's plain kernels: over an hour): the proof files
    of both packages byte-equal."""
    proofs = {}
    for pkg in PKGS:
        out_dir = tmp_path / pkg
        out_dir.mkdir()
        cm = str(out_dir / "cm.npz")
        path = config_file(tmp_path, pkg, saveProofToFile=True,
                           saveProofsDir=str(out_dir), zkevmCmPols=cm)
        dev = ["--device", "cpu"] if pkg == PORT else []
        rc, line = run_main(pkg, ["-c", path, "--gen-batch-proof",
                                  devnet0_file, *dev])
        assert rc == 0 and json.loads(line)["verified"]
        proofs[pkg] = (out_dir / "batch_proof.json").read_text()
        rc, line = run_main(pkg, ["-c", path, "--prove-from-cmpols", cm,
                                  *dev])
        assert rc == 0 and json.loads(line)["verified"]
    assert proofs[PORT] == proofs[JAX]
