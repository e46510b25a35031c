"""Port parity: ``xlayer_prover_tpu_torch/utils/config.py`` against the
JAX package's ``utils/config.py``, field by field, on the CPU.

The same reference-style config file (camelCase keys, aliases, legacy
spellings, unknown keys) loads into equal Configs
(``dataclasses.asdict``); every environment override lands on the same
field with the same type; ``check()`` passes and refuses the same
configs; ``print()`` logs the same lines.  The port's entry point refuses
the keys that select a state backend of ROADMAP item 17."""

import dataclasses
import json

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


@pytest.mark.parametrize("key,value,attr", [
    ("hashDB64", True, "hashdb64"),
    ("databaseURL", "postgresql://db/state", "database_url"),
    ("databaseURL", "/var/lib/state.sqlite", "database_url"),
    ("dbCacheSynchURL", "prover-a:50061", "db_cache_synch_url"),
    ("loadDBToMemCache", True, "load_db_to_mem_cache")])
def test_unported_state_keys_refused(tmp_path, key, value, attr):
    """Each key of ROADMAP item 17 loads as in the JAX package, and the
    port's entry point refuses it with a ValueError naming the key, for
    the HashDB server that would use it; the defaults pass."""
    port, jax = loaded(tmp_path, {"runHashDBServer": True, key: value})
    assert getattr(port, attr) == getattr(jax, attr) == value
    with pytest.raises(ValueError, match=rf"^config {key}=.*ROADMAP item 17"):
        pmain.refuse_unported_state(port)
    with pytest.raises(ValueError, match=key):
        pmain.cmd_run_services(port)
    pmain.refuse_unported_state(pconfig.Config())
    assert set(pmain.UNPORTED_STATE_KEYS) == {
        "hashdb64", "database_url", "db_cache_synch_url",
        "load_db_to_mem_cache"}
