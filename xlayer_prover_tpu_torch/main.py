"""The prover's entry point (reference: src/main.cpp): config, services,
file runs.

The port's own copy of ``xlayer_prover_tpu/main.py``, with the same modes
(mirroring the reference's config-driven entry points):
  * --process-batch INPUT.json   execute a batch on the zkEVM ROM (fast
                                 path, no proof) and print counters + roots
  * --gen-batch-proof INPUT.json execute, prove and verify a batch
  * --prove-from-cmpols CM.npz   prove a saved committed trace
  * --prove-toy                  generate + verify a toy-circuit proof
                                 (the standalone STARK harness pattern,
                                 test/prover/main.cpp:6-30)
  * --run-services               start the services the config enables:
                                 HashDB and Executor servers, the
                                 aggregator client (gRPC)
  * config flags: the Keccak / SHA-256 script generators, the executor
    client and the self-tests (the port's own test modules)

One option is the port's own: ``--device`` (default ``cuda``) is where
the proofs are made and the hashdb64 store hashes its consolidations;
``--device cpu`` runs every kernel's plain PyTorch version on the CPU.
``grpc`` and the generated ``_pb2`` modules are imported only where a
gRPC path runs, so the file modes need neither.

Usage: python3 -m xlayer_prover_tpu_torch.main [-c config.json] MODE...
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .utils.config import Config
from .utils.log import zklog

def _load_rom(path: str | None):
    from .executor import rom_functions as rf
    from .executor.main_sm import MainExecutor
    from .executor.rom import Rom

    rom = Rom.load(path) if path else Rom.load_fork(9)
    ex = MainExecutor(rom, max_steps=1 << 23)
    rf.register_all(ex)
    return rom, ex


def cmd_process_batch(cfg: Config, input_path: str, rom_path=None) -> int:
    from .executor.input import BatchInput
    from .executor.main_sm import Context, MainExecutor
    from .state.hashdb import HashDB

    rom, ex = _load_rom(rom_path)
    inp = BatchInput.load(input_path)
    hashdb = HashDB()
    inp.load_db(hashdb)
    ctx = Context(rom, hashdb, input_vars=inp.input_vars())
    inp.setup_registers(ctx)
    t0 = time.perf_counter()
    ex.execute(ctx)
    dt = time.perf_counter() - t0
    sr = MainExecutor._root_quad(ctx.regs.SR)
    new_root = sr[0] | (sr[1] << 64) | (sr[2] << 128) | (sr[3] << 192)
    out = {
        "steps": ctx.counters.steps,
        "binary": ctx.counters.binary,
        "arith": ctx.counters.arith,
        "keccak_f": ctx.counters.keccak_f,
        "poseidon_g": ctx.counters.poseidon_g,
        "storage_ops": len(ctx.required.storage),
        "new_state_root": hex(new_root),
        "seconds": round(dt, 3),
        "steps_per_s": round(ctx.counters.steps / dt),
    }
    print(json.dumps(out))
    return 0


def cmd_prove_toy(cfg: Config, device: str) -> int:
    from .models.toy import fib
    from .stark import prover, verifier

    air = fib.build_air(n_bits=5, n_queries=8)
    const_np, cm1_np, publics = fib.gen_trace(air)
    setup = prover.Setup.build(air, const_np, device=device)
    t0 = time.perf_counter()
    proof = prover.gen_proof(setup, cm1_np, publics)
    t1 = time.perf_counter()
    verifier.verify(air, setup.verkey, proof)
    t2 = time.perf_counter()
    print(json.dumps({"prove_s": round(t1 - t0, 3),
                      "verify_s": round(t2 - t1, 3),
                      "proof_bytes": len(proof.to_json()),
                      "verified": True}))
    return 0


def cmd_gen_batch_proof(cfg: Config, input_path: str, rom_path=None,
                        n_bits: int = 16, device: str = "cuda") -> int:
    """runFileGenBatchProof (reference main.cpp:594-701): prove a saved
    batch input end-to-end, optionally dumping the committed trace
    (zkevmCmPolsAfterExecutor) and the proof JSON."""
    from .executor.input import BatchInput
    from .executor.rom import Rom
    from .prover_service import BatchProver
    from .stark import verifier

    rom = Rom.load(rom_path) if rom_path else Rom.load_fork(9)
    engine = BatchProver(rom, n_bits=n_bits, max_steps=1 << 22,
                         device=device)
    inp = BatchInput.load(input_path)
    t0 = time.perf_counter()
    res = engine.execute_only(inp)
    t1 = time.perf_counter()
    if cfg.zkevm_cm_pols_file:
        BatchProver.save_cm_pols(cfg.zkevm_cm_pols_file, res)
        zklog.info(f"saved committed trace to {cfg.zkevm_cm_pols_file}")
    engine.setup(cfg.zkevm_constants_tree)   # preload/persist const tree
    proof = engine.prove_from_trace(res.cm1_np, res.publics)
    t2 = time.perf_counter()
    verifier.verify(engine.air, engine.setup().verkey, proof)
    out = {"execute_s": round(t1 - t0, 3), "prove_s": round(t2 - t1, 3),
           "steps": res.ctx.counters.steps, "verified": True}
    if cfg.save_proof_to_file:
        dest = (cfg.save_proofs_dir or ".") + "/batch_proof.json"
        with open(dest, "w") as f:
            f.write(proof.to_json())
        out["proof_file"] = dest
    print(json.dumps(out))
    return 0


def cmd_prove_from_cmpols(cfg: Config, path: str, rom_path=None,
                          n_bits: int = 16, device: str = "cuda") -> int:
    """Resume proving from a saved committed trace without re-executing
    (the reference's mmap'd zkevmCmPols re-run)."""
    from .executor.rom import Rom
    from .prover_service import BatchProver
    from .stark import verifier

    rom = Rom.load(rom_path) if rom_path else Rom.load_fork(9)
    engine = BatchProver(rom, n_bits=n_bits, max_steps=1 << 22,
                         device=device)
    cm1, publics = BatchProver.load_cm_pols(path)
    engine.setup(cfg.zkevm_constants_tree)   # preload/persist const tree
    t0 = time.perf_counter()
    proof = engine.prove_from_trace(cm1, publics)
    t1 = time.perf_counter()
    verifier.verify(engine.air, engine.setup().verkey, proof)
    print(json.dumps({"prove_s": round(t1 - t0, 3), "verified": True}))
    return 0


def state_backend(cfg: Config, device: str = "cuda"):
    """The HashDB service's state backend as the JAX main.py builds it:
    ``HashDB64`` on its paged file for hashDB64 (hashing on `device`), a
    ``HashDB`` over ``CachedDB`` (LRU + associative caches, MultiWrite
    write-behind) over ``PostgresDB`` for a postgres DSN or ``SqlDB`` for
    any other databaseURL but "local" (reference main.cpp:404-440), else
    None (the service's in-memory ``HashDB``)."""
    import os

    if cfg.hashdb64:
        from .state.hashdb64 import HashDB64
        os.makedirs(cfg.hashdb_folder, exist_ok=True)
        return HashDB64(path=os.path.join(cfg.hashdb_folder,
                                          cfg.hashdb_file_name),
                        device=device)
    if cfg.database_url and cfg.database_url != "local":
        from .state.database import CachedDB, SqlDB
        from .state.hashdb import HashDB
        if cfg.database_url.startswith(("postgres://", "postgresql://")):
            from .state.postgres import PostgresDB
            sql = PostgresDB(dsn=cfg.database_url)
        else:
            sql = SqlDB(cfg.database_url)
        return HashDB(db=CachedDB(
            backend=sql,
            mt_cache_bytes=cfg.db_mt_cache_mb * (1 << 20),
            program_cache_bytes=cfg.db_program_cache_mb * (1 << 20)))
    return None


def start_state_services(cfg: Config, node_db) -> list:
    """Under a cached node store: the boot-time warm start
    (loadDBToMemCache, on a thread of its own with
    loadDBToMemCacheInParallel) and the cache synch thread
    (dbCacheSynchURL, reference database.cpp:96,1872-1966), as the JAX
    main.py starts them.  -> the threads to stop"""
    from .state.database import CacheSynchThread, load_db_to_mem_cache

    threads = []
    if cfg.hashdb64:
        return threads
    if cfg.load_db_to_mem_cache and hasattr(node_db, "read_state_root"):
        timeout_s = cfg.load_db_to_mem_timeout_us / 1e6
        if cfg.load_db_to_mem_cache_in_parallel:
            import threading
            threading.Thread(target=load_db_to_mem_cache, args=(node_db,),
                             kwargs={"timeout_s": timeout_s}, daemon=True,
                             name="loadDb2MemCache").start()
        else:
            n = load_db_to_mem_cache(node_db, timeout_s=timeout_s)
            zklog.info(f"loadDb2MemCache: warmed {n} nodes")
    if cfg.db_cache_synch_url and hasattr(node_db, "write_cache_only"):
        from .services.hashdb_service import HashDBRemote
        host, _, port = cfg.db_cache_synch_url.rpartition(":")
        threads.append(CacheSynchThread(
            node_db, HashDBRemote(host or "localhost", int(port))))
        zklog.info(f"dbCacheSynch -> {cfg.db_cache_synch_url}")
    return threads


def cmd_run_services(cfg: Config, device: str = "cuda") -> int:
    """The services the config enables, until SIGINT.  As in the JAX
    package, the aggregator client drives ``ProverService({})``: a
    service with no batch prover and no setup (ROADMAP queue 3).  On
    SIGINT the servers stop, then the state backend is closed: what was
    flushed reaches its store."""
    from .executor.executor import Executor
    from .prover_service import ProverService
    from .services.executor_service import ExecutorServer, ExecutorServiceImpl
    from .state.hashdb import HashDB

    threads = []
    backend = None
    if cfg.run_hashdb_server:
        from .services.hashdb_service import HashDBServer, HashDBServiceImpl
        backend = state_backend(cfg, device)
        impl = HashDBServiceImpl(backend)
        server = HashDBServer(impl, cfg.hashdb_server_port).start()
        zklog.info(f"hashdb service listening on :{server.port} "
                   f"(backend={'hashdb64' if cfg.hashdb64 else 'classic'})")
        threads.append(server)
        threads += start_state_services(cfg, getattr(impl.hashdb, "db",
                                                     None))
    if cfg.run_executor_server:
        rom, ex_machine = _load_rom(None)
        # no AIR: the service only executes (Executor.__init__ would build
        # the 2^16 zkEVM AIR); the labels are the ones __init__ sets, which
        # the JAX package leaves unset here (ROADMAP queue 3)
        executor = Executor.__new__(Executor)
        executor.rom = rom
        executor.main = ex_machine
        executor.start_label = "start"
        executor.stop_label = "finalizeExecution"
        impl = ExecutorServiceImpl(executor, HashDB())
        server = ExecutorServer(impl, cfg.executor_server_port).start()
        zklog.info(f"executor service listening on :{server.port}")
        threads.append(server)
    if cfg.run_aggregator_client:
        from .services.aggregator import AggregatorClient
        prover_svc = ProverService({})
        client = AggregatorClient(prover_svc, cfg.aggregator_client_host,
                                  cfg.aggregator_client_port,
                                  prover_name=cfg.prover_name,
                                  fork_id=cfg.fork_id)
        client.start()
        zklog.info(f"aggregator client -> {client.target}")
        threads.append(client)
    if not threads:
        zklog.warning("no services enabled in config")
        return 1
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        for t in threads:
            t.stop()
        if backend is not None:
            getattr(backend, "db", backend).close()
    return 0


def cmd_script_generators(cfg: Config) -> int:
    """runKeccakScriptGenerator / runSHA256ScriptGenerator
    (main.cpp keccak/sha script dumps): levelize the gate circuit and
    write the script JSON to the configured file slot."""
    import numpy as np

    out = {}
    jobs = []
    if cfg.run_keccak_script_generator:
        jobs.append(("keccak", cfg.keccak_script_file or
                     "keccak_script.json"))
    if cfg.run_sha256_script_generator:
        jobs.append(("sha256", cfg.sha256_script_file or
                     "sha256_script.json"))
    for kind, path in jobs:
        if kind == "keccak":
            from .models.zkevm import keccak_gates as mod
        else:
            from .models.zkevm import sha256_gates as mod
        script = mod.build_script()
        doc = {
            "kind": kind,
            "nInputs": script.n_inputs,
            "nWires": script.n_wires,
            "nGates": script.n_gates,
            "depth": len(script.levels),
            "outputs": [int(w) for w in np.asarray(script.outputs)],
            "program": [{"op": int(op), "a": int(a), "b": int(b),
                         "r": int(r)} for (op, a, b, r) in script.gates],
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        out[kind] = {"file": path, "gates": script.n_gates}
        zklog.info(f"{kind} gate script -> {path} ({script.n_gates} gates)")
    print(json.dumps(out))
    return 0


_SELF_TESTS = {
    # config flag -> the port's test modules (the reference's run*Test
    # modes, config.hpp:40-60); they hold the port against the JAX
    # package, so they run where both are installed
    "run_keccak_test": ["tests/test_torch_chains.py"],
    "run_sha256_test": ["tests/test_torch_chains.py"],
    "run_storage_sm_test": ["tests/test_torch_storage_sm.py"],
    "run_climb_key_sm_test": ["tests/test_torch_storage_sm.py"],
    "run_binary_sm_test": ["tests/test_torch_binary_sm.py"],
    "run_mem_align_sm_test": ["tests/test_torch_zkevm_air.py"],
    "run_ecrecover_test": ["tests/test_torch_zkevm_executor.py"],
    "run_check_tree_test": ["tests/test_torch_state.py"],
    "run_database_cache_test": ["tests/test_torch_db_caches.py"],
    "run_database_performance_test": ["tests/test_torch_db_caches.py"],
    "run_page_manager_test": ["tests/test_torch_state64.py"],
    "run_key_value_tree_test": ["tests/test_torch_state64.py"],
    "run_smt64_test": ["tests/test_torch_state64.py"],
    "run_hashdb_test": ["tests/test_torch_state.py",
                        "tests/test_torch_entry_services.py",
                        "tests/test_torch_state64.py"],
    "run_unit_test": ["tests/test_torch_*.py"],
}
# the flags whose subject the port lacks (the BLAKE2b of the FFLONK
# transcript)
_UNPORTED_TESTS = ("run_blake_test",)


def cmd_self_tests(cfg: Config) -> int:
    """Dispatch the enabled run*Test flags to the port's test modules."""
    import glob
    import os
    import subprocess

    unported = [f for f in _UNPORTED_TESTS if getattr(cfg, f)]
    if unported:
        raise ValueError(f"self-tests {unported} test code that is not "
                         "ported (ops/blake2b.py)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    targets = []
    for flag, mods in _SELF_TESTS.items():
        if getattr(cfg, flag):
            for pattern in mods:
                for m in sorted(glob.glob(pattern, root_dir=root)):
                    if m not in targets:
                        targets.append(m)
    if not targets:
        zklog.warning("no self-test flags enabled")
        return 1
    rc = subprocess.call([sys.executable, "-m", "pytest", "-q",
                          "-m", "not slow", *targets], cwd=root)
    return rc


def cmd_executor_client(cfg: Config) -> int:
    """runExecutorClient / runExecutorClientMultithread
    (executor_client.cpp): drive ProcessBatchV2 against a running
    executor service, `executor_client_loops` times per thread."""
    import concurrent.futures as futures

    import grpc

    from .services.executor_service import SERVICE
    from .services.gen import executor_pb2

    if not cfg.input_file:
        zklog.error("executor client needs inputFile")
        return 1
    with open(cfg.input_file) as f:
        data = json.load(f)
    target = f"{cfg.executor_client_host}:{cfg.executor_client_port}"

    def one_run(i: int):
        channel = grpc.insecure_channel(target)
        call = channel.unary_unary(
            f"/{SERVICE}/ProcessBatchV2",
            request_serializer=(
                executor_pb2.ProcessBatchRequestV2.SerializeToString),
            response_deserializer=(
                executor_pb2.ProcessBatchResponseV2.FromString))
        req = executor_pb2.ProcessBatchRequestV2(
            old_state_root=bytes.fromhex(
                data.get("oldStateRoot", "0x" + "00" * 32)[2:]),
            old_acc_input_hash=bytes.fromhex(
                data.get("oldAccInputHash", "0x" + "00" * 32)[2:]),
            batch_l2_data=bytes.fromhex(
                data.get("batchL2Data", "0x")[2:]),
            chain_id=int(data.get("chainID", 1)),
            fork_id=int(data.get("forkID", 9)),
        )
        ok = 0
        try:
            for _ in range(max(1, cfg.executor_client_loops)):
                resp = call(req, timeout=120)
                if resp.error == executor_pb2.EXECUTOR_ERROR_NO_ERROR:
                    ok += 1
        finally:
            channel.close()
        return ok

    n_threads = (cfg.max_executor_threads
                 if cfg.run_executor_client_multithread else 1)
    with futures.ThreadPoolExecutor(max_workers=n_threads) as pool:
        results = list(pool.map(one_run, range(n_threads)))
    print(json.dumps({"threads": n_threads, "ok_responses": sum(results)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="xlayer-prover-tpu-torch")
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--process-batch", metavar="INPUT_JSON")
    ap.add_argument("--gen-batch-proof", metavar="INPUT_JSON")
    ap.add_argument("--prove-from-cmpols", metavar="CMPOLS_NPZ")
    ap.add_argument("--n-bits", type=int, default=16)
    ap.add_argument("--rom", default=None)
    ap.add_argument("--prove-toy", action="store_true")
    ap.add_argument("--run-services", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where proofs are made and the hashdb64 store "
                         "hashes: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = Config.load(args.config).check()
    if cfg.json_logs:
        zklog.json_mode = True

    if args.process_batch:
        return cmd_process_batch(cfg, args.process_batch, args.rom)
    if args.gen_batch_proof:
        return cmd_gen_batch_proof(cfg, args.gen_batch_proof, args.rom,
                                   args.n_bits, args.device)
    if args.prove_from_cmpols:
        return cmd_prove_from_cmpols(cfg, args.prove_from_cmpols, args.rom,
                                     args.n_bits, args.device)
    if args.prove_toy:
        return cmd_prove_toy(cfg, args.device)
    if cfg.run_keccak_script_generator or cfg.run_sha256_script_generator:
        return cmd_script_generators(cfg)
    if cfg.run_executor_client or cfg.run_executor_client_multithread:
        return cmd_executor_client(cfg)
    if any(getattr(cfg, f) for f in (*_SELF_TESTS, *_UNPORTED_TESTS)):
        return cmd_self_tests(cfg)
    if args.run_services or cfg.run_executor_server \
            or cfg.run_aggregator_client or cfg.run_hashdb_server:
        return cmd_run_services(cfg, args.device)
    ap.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
