"""The port stands alone: no module of xlayer_prover_tpu_torch, and not
chip_smoke.py, imports JAX or anything of the JAX package
xlayer_prover_tpu (its jax-free modules included)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "xlayer_prover_tpu")
SOURCES = sorted((ROOT / "xlayer_prover_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(tree):
    """Top-level package names of every import statement in `tree`
    (function-local imports included; relative imports stay inside the
    package and give none)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_guard_sees_every_import_form():
    src = ("import jax.numpy\nfrom xlayer_prover_tpu.stark import air\n"
           "def f():\n    import importlib\n"
           "    importlib.import_module('jaxlib')\n"
           "from . import gl\n")
    assert sorted(_imported(ast.parse(src))) == [
        "importlib", "jax", "jaxlib", "xlayer_prover_tpu"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported(ast.parse(path.read_text()))) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", [
    "ops/poseidon_bn254.py", "stark/commitment.py", "fields/bn254.py",
    "snark/r1cs.py", "snark/final_circuit.py", "recursion/stack.py",
    "fields/bn254_tower.py", "ops/bn254_mont.py", "ops/bn254_msm.py",
    "ops/ntt_fr.py", "snark/groth16.py", "snark/zkey.py",
    "snark/snarkjs_io.py"])
def test_final_stage_modules_are_checked(module):
    """The final stage's modules (the BN128 scheme, the R1CS, Groth16 and
    its curve, NTT and file-format modules) are among the sources the
    guard above reads."""
    assert ROOT / "xlayer_prover_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "prover_service.py", "cascade.py", "utils/log.py", "utils/timer.py"])
def test_request_path_modules_are_checked(module):
    """The request path's modules (the service, the cascade, the logger
    and the timer) are among the sources the guard above reads."""
    assert ROOT / "xlayer_prover_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "ops/keccak.py", "utils/keccak.py", "models/zkevm/gates.py",
    "models/zkevm/keccak_gates.py", "models/zkevm/sha256_gates.py",
    "models/zkevm/gate_sm.py", "models/zkevm/padding_kk.py",
    "models/zkevm/padding_kk_sm.py", "models/zkevm/keccak_chain_sm.py",
    "models/zkevm/padding_sha_sm.py", "models/zkevm/sha_chain_sm.py",
    "models/zkevm/zkevm_air.py"])
def test_chain_modules_are_checked(module):
    """The Keccak-F and SHA-256-F chains' modules are among the sources
    the guard above reads."""
    assert ROOT / "xlayer_prover_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "main.py", "utils/config.py", "utils/watchdog.py", "executor/forks.py",
    "executor/full_tracer.py", "executor/executor.py",
    "services/aggregator.py", "services/executor_service.py",
    "services/hashdb_service.py", "services/gen/aggregator_pb2.py",
    "services/gen/executor_pb2.py", "services/gen/hashdb_pb2.py",
    "state/hashdb.py"])
def test_entry_modules_are_checked(module):
    """The entry point's modules (main.py, the config, the watchdog, the
    forks, the full tracer, the gRPC services and their generated
    messages) are among the sources the guard above reads."""
    assert ROOT / "xlayer_prover_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("name", ["__init__.py", "aggregator_pb2.py",
                                  "executor_pb2.py", "hashdb_pb2.py"])
def test_generated_messages_are_byte_copies(name):
    """The port's services/gen/ files are byte-for-byte the JAX package's:
    both register the same .proto files in protobuf's default pool, which
    refuses a second file of the same name that differs."""
    port = ROOT / "xlayer_prover_tpu_torch" / "services" / "gen" / name
    jax = ROOT / "xlayer_prover_tpu" / "services" / "gen" / name
    assert port.read_bytes() == jax.read_bytes()


def test_main_file_modes_need_no_grpc():
    """xlayer_prover_tpu_torch.main imports, and its file mode
    --process-batch dispatches, with grpc and protobuf not importable."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "for name in ('grpc', 'google.protobuf'):\n"
        "    sys.modules[name] = None\n"
        "from xlayer_prover_tpu_torch import main\n"
        "seen = []\n"
        "main.cmd_process_batch = lambda cfg, path, rom: seen.append(path)"
        " or 0\n"
        "assert main.main(['--process-batch', 'in.json']) == 0\n"
        "assert seen == ['in.json']\n"
        "from xlayer_prover_tpu_torch.executor import (executor, forks,\n"
        "                                              full_tracer)\n"
        "from xlayer_prover_tpu_torch.utils import config, watchdog\n"
        "assert 'grpc' not in sys.modules or sys.modules['grpc'] is None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("module", [
    "snark/plonk.py", "snark/fflonk.py", "ops/fr_poly.py", "stark/zkin.py",
    "ops/blake2b.py"])
def test_fflonk_modules_are_checked(module):
    """The PLONK conversion, fflonk, its Fr polynomial kernels' wrappers,
    the zkin export and Blake2b are among the sources the guard above
    reads (each imports nothing of JAX or of the JAX package)."""
    path = ROOT / "xlayer_prover_tpu_torch" / module
    assert path in SOURCES
    assert not set(_imported(ast.parse(path.read_text()))) & set(FORBIDDEN)
