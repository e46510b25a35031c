"""Port parity: ``xlayer_prover_tpu_torch/utils/config.py`` against the
JAX package's ``utils/config.py``, field by field, on the CPU.

The same reference-style config file (camelCase keys, aliases, legacy
spellings, unknown keys) loads into equal Configs
(``dataclasses.asdict``); every environment override lands on the same
field with the same type; ``check()`` passes and refuses the same
configs; ``print()`` logs the same lines.  The port's entry point builds
the state backend that each key of ROADMAP item 17 selects, as the JAX
main.py does."""

import dataclasses
import json
import os

import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401
from xlayer_prover_tpu.utils import config as jconfig
from xlayer_prover_tpu.utils.log import zklog as jlog
from xlayer_prover_tpu_torch import main as pmain
from xlayer_prover_tpu_torch.utils import config as pconfig
from xlayer_prover_tpu_torch.utils.log import zklog as plog

CONFIGS = (pconfig.Config, jconfig.Config)

# a config in the reference's style: its own spellings (aliases, legacy
# names, derived snake_case), every type, and keys no field takes
REFERENCE_STYLE = {
    "runAggregatorClient": True, "aggregatorClientHost": "agg.example",
    "aggregatorClientPort": 50081, "runExecutorServer": True,
    "executorServerPort": 50071, "runHashDBServer": True,
    "hashDBServerPort": 50061, "hashDBURL": "local", "databaseURL": "local",
    "proverName": "tpu-prover-7", "forkID": 8, "inputFile": "in.json",
    "jsonLogs": False, "dbMTCacheSize": 2048, "dbProgramCacheSize": 64,
    "proverID": "p-1", "ECRecoverPrecalc": True,
    "ECRecoverPrecalcNThreads": 4, "loadDBToMemTimeout": 5000,
    "aggregatorClientWatchdogTimeout": 90, "dbMultiWrite": False,
    "dbMultiWriteSingleQuerySize": 1024, "maxHashDBThreads": 2,
    "maxStateDBThreads": 3, "runFileExecutor": "x.json",
    "cleanerPollingPeriod": 10, "requestsPersistence": 20,
    "saveResponseToFile": True, "zkevmCmPols": "cm.npz",
    "zkevmConstPols": "c.bin", "finalStarkZkey": "f.zkey",
    "recursive1Verkey": "r1.verkey.json", "c12aExec": "c12a.exec",
    "maxSteps": 4096, "saveProofToFile": True, "saveProofsDir": "out",
    "zkevmConstantsTree": "tree.bin", "keccakScriptFile": "k.json",
    "runKeccakScriptGenerator": False, "executorClientLoops": 3,
    "log2DbMTAssociativeCacheSize": 20, "maxExecutorThreads": 7,
    "useMainExecGenerated": False, "outputPath": "runs",
    "unknownKey": 1, "anotherOne": {"nested": [1, 2]},
}

# a value of each environment override's type -> (raw, parsed)
ENV_VALUES = {bool: ("yes", True), int: ("123", 123), str: ("env-v", "env-v")}


def loaded(tmp_path, data: dict):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(data))
    return [C.load(str(path)) for C in CONFIGS]


def test_fields_equal():
    port, jax = ([(f.name, f.type, f.default) for f in dataclasses.fields(C)
                  if f.name != "extra"] for C in CONFIGS)
    assert port == jax and len(port) > 130
    assert pconfig.Config._ENV_MAP == jconfig.Config._ENV_MAP
    assert pconfig.Config._JSON_ALIASES == jconfig.Config._JSON_ALIASES


def test_defaults_equal():
    port, jax = (dataclasses.asdict(C()) for C in CONFIGS)
    assert port == jax


def test_reference_style_file_equal(tmp_path):
    port, jax = loaded(tmp_path, REFERENCE_STYLE)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert (port.aggregator_client_host, port.fork_id, port.max_steps,
            port.max_hashdb_threads, port.run_file_execute,
            port.zkevm_cm_pols_file, port.db_mt_cache_mb) == (
        "agg.example", 8, 4096, 3, "x.json", "cm.npz", 2048)
    assert port.extra == {"unknownKey": 1, "anotherOne": {"nested": [1, 2]}}
    assert port.check() is port and jax.check() is jax


def test_environment_overrides_equal(tmp_path, monkeypatch):
    for attr, env in pconfig.Config._ENV_MAP.items():
        raw, _parsed = ENV_VALUES[type(getattr(pconfig.Config(), attr))]
        monkeypatch.setenv(env, raw)
    port, jax = loaded(tmp_path, REFERENCE_STYLE)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    for attr in pconfig.Config._ENV_MAP:
        kind = type(getattr(pconfig.Config(), attr))
        assert getattr(port, attr) == ENV_VALUES[kind][1], attr
    # no file: the environment alone
    port, jax = (C.load(None) for C in CONFIGS)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert port.prover_name == "env-v" and port.max_steps == 123


@pytest.mark.parametrize("data", [
    {"nBits": 0}, {"nBits": 31}, {"blowupBits": 0}, {"nQueries": 0},
    {"runAggregatorClient": True, "aggregatorClientHost": ""}],
    ids=["n_bits_0", "n_bits_31", "blowup_0", "queries_0", "no_host"])
def test_check_refuses_as_the_reference(tmp_path, data):
    for cfg in loaded(tmp_path, data):
        with pytest.raises(AssertionError):
            cfg.check()


def test_print_equal(tmp_path, monkeypatch):
    logged = {}
    for cfg, log, name in zip(loaded(tmp_path, REFERENCE_STYLE),
                              (plog, jlog), ("port", "jax")):
        lines = logged.setdefault(name, [])
        monkeypatch.setattr(log, "info", lines.append)
        cfg.print()
    assert logged["port"] == logged["jax"]
    assert "config.prover_name = tpu-prover-7" in logged["port"]


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sqlite_state(path: str) -> tuple:
    """A sqlite node store holding a consolidated classic-SMT state and
    its state-root sentinel (the JAX package writes it).  -> the root"""
    from xlayer_prover_tpu.state.database import CachedDB, SqlDB
    from xlayer_prover_tpu.state.hashdb import HashDB
    db = CachedDB(SqlDB(path))
    hdb = HashDB(db)
    root = (0, 0, 0, 0)
    for i in range(1, 9):
        root = tuple(hdb.set("b", root, (i, 2 * i, 3, 4), 100 + i).new_root)
    fid, _ = hdb.consolidate("b")
    assert db.multi_write.wait_stored(fid, timeout=30)
    db.multi_write.close()
    return root


def run_services(pkg_main, cfg, monkeypatch, **kw):
    """`pkg_main`.cmd_run_services(cfg) until its first wait, which
    raises KeyboardInterrupt (SIGINT) on the main thread.  -> (the
    HashDBServiceImpls and CacheSynchThreads it made, its return code)"""
    import importlib
    import threading
    import time

    pkg = pkg_main.__name__.rsplit(".", 1)[0]
    svc = importlib.import_module(f"{pkg}.services.hashdb_service")
    dbm = importlib.import_module(f"{pkg}.state.database")
    made = {"impl": [], "synch": []}

    class Impl(svc.HashDBServiceImpl):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made["impl"].append(self)

    class Synch(dbm.CacheSynchThread):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made["synch"].append(self)

    sleep = time.sleep

    def interrupted(seconds):
        if threading.current_thread() is threading.main_thread():
            raise KeyboardInterrupt
        sleep(seconds)

    monkeypatch.setattr(svc, "HashDBServiceImpl", Impl)
    monkeypatch.setattr(dbm, "CacheSynchThread", Synch)
    monkeypatch.setattr(time, "sleep", interrupted)
    try:
        rc = pkg_main.cmd_run_services(cfg, **kw)
    finally:
        monkeypatch.undo()
    return made, rc


def chain(backend) -> list:
    """The type names down a backend's stack: the HashDB, then a
    CachedDB under it and the CachedDB's store."""
    names = [type(backend).__name__]
    db = getattr(backend, "db", None)
    if type(db).__name__ == "CachedDB":
        names += ["CachedDB", type(db.backend).__name__]
    return names


STATE_CASES = [("hashDB64", True), ("databaseURL", "postgresql://db/state"),
               ("databaseURL", "sqlite"), ("dbCacheSynchURL", "loopback"),
               ("loadDBToMemCache", True)]


@pytest.mark.parametrize("key,value", STATE_CASES,
                         ids=[f"{k}-{v}" for k, v in STATE_CASES])
def test_state_backends_built_as_the_jax_main(tmp_path, monkeypatch, key,
                                              value):
    """Each config key of the state backends (ROADMAP item 17) builds, in
    the port's ``--run-services``, the backend that the JAX main.py
    builds: HashDB64 on its file; PostgresDB, which fails on the missing
    psycopg2 as in the JAX package; HashDB over CachedDB over SqlDB with
    the configured cache sizes; the cache synch thread (to a loopback
    port); the warm start, which caches the same nodes."""
    from xlayer_prover_tpu import main as jmain
    jax_sql = str(tmp_path / "jax.sqlite")
    port_sql = str(tmp_path / "port.sqlite")
    data = {"runHashDBServer": True, "hashDBServerPort": 0,
            "dbMTCacheSize": 3, "dbProgramCacheSize": 2, key: value}
    if key == "hashDB64":
        data["hashDBFileName"] = "state64"
    elif value != "postgresql://db/state":
        data["databaseURL"] = "sqlite"
    if key == "dbCacheSynchURL":
        data[key] = f"127.0.0.1:{_free_port()}"
    if key == "loadDBToMemCache":
        root = sqlite_state(port_sql)
        assert sqlite_state(jax_sql) == root
    out = {}
    for name, main_mod, sql, kw in (("port", pmain, port_sql,
                                     {"device": "cpu"}),
                                    ("jax", jmain, jax_sql, {})):
        cfg_data = dict(data, hashDBFolder=str(tmp_path / f"h64_{name}"))
        if cfg_data.get("databaseURL") == "sqlite":
            cfg_data["databaseURL"] = sql
        cfg = loaded(tmp_path, cfg_data)[0 if name == "port" else 1]
        if value == "postgresql://db/state":
            with pytest.raises(ImportError) as err:
                run_services(main_mod, cfg, monkeypatch, **kw)
            out[name] = (type(err.value), str(err.value))
            continue
        made, rc = run_services(main_mod, cfg, monkeypatch, **kw)
        assert rc == 0
        (impl,), synch = made["impl"], made["synch"]
        backend = impl.hashdb
        got = [chain(backend), len(synch)]
        db = getattr(backend, "db", None)
        if hasattr(db, "mt_cache"):
            got += [db.mt_cache.max_bytes, db.program_cache.max_bytes,
                    sorted(db.mt_cache._d)]
        for t in synch:
            assert t.db is db and not t._thread.is_alive()
        if key == "hashDB64":
            got.append(os.path.exists(os.path.join(
                cfg.hashdb_folder, "state64.blob")))
        out[name] = got
    assert out["port"] == out["jax"]
    expect = {"hashDB64": ["HashDB64"], "databaseURL": ["HashDB", "CachedDB",
                                                        "SqlDB"]}
    if value == "postgresql://db/state":
        assert out["port"][0] is ModuleNotFoundError
        assert "psycopg2" in out["port"][1]
    elif key in expect:
        assert out["port"][0] == expect[key]
    if key == "dbCacheSynchURL":
        assert out["port"][1] == 1
    if key == "loadDBToMemCache":
        assert root in out["port"][4] and len(out["port"][4]) > 8
    if key == "hashDB64":
        assert out["port"][-1] is True
