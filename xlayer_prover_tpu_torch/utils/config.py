"""Runtime configuration (reference: src/config/config.{hpp,cpp}).

The port's own copy of ``xlayer_prover_tpu/utils/config.py``.  One JSON
file -> typed Config dataclass; environment variables override file
values (reference behavior, src/config/README.md); check() validates.
Only the fields the prover consumes are typed; unknown file keys are
preserved in ``extra`` so reference config files load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Config:
    # services
    run_aggregator_client: bool = False
    run_aggregator_server: bool = False
    run_executor_server: bool = False
    run_hashdb_server: bool = False
    aggregator_client_host: str = "127.0.0.1"
    aggregator_client_port: int = 50081
    aggregator_server_port: int = 50081
    executor_server_port: int = 50071
    hashdb_server_port: int = 50061
    hashdb_url: str = "local"
    # prover
    prover_name: str = "tpu-prover"
    fork_id: int = 9
    save_proofs_dir: str = ""
    input_file: str = ""
    # state
    database_url: str = "local"
    database_file: str = ""
    # proving geometry
    n_bits: int = 23
    blowup_bits: int = 1
    n_queries: int = 32
    # observability
    json_logs: bool = False
    executor_time_statistics: bool = False
    log_executor_server_input: bool = False
    log_remote_db_reads: bool = False
    db_metrics: bool = False
    # file-driven runs (reference runFileGen* modes, config.hpp:35-63)
    run_file_gen_batch_proof: str = ""
    run_file_gen_aggregated_proof: str = ""
    run_file_gen_final_proof: str = ""
    run_file_process_batch: str = ""
    save_input_to_file: bool = False
    save_output_to_file: bool = False
    save_proof_to_file: bool = False
    save_responses_to_file: bool = False
    output_path: str = "output"
    # executor behavior
    use_main_exec_generated: bool = True      # native fast path (nexec)
    executor_rom_file: str = ""
    process_batch_cache_size: int = 0
    max_executor_threads: int = 20
    full_tracer_enabled: bool = True
    # prover behavior
    max_prover_threads: int = 8
    prover_server_timeout_s: int = 0
    aggregator_client_watchdog_timeout_s: int = 60
    aggregator_client_max_streams: int = 0
    cleaner_polling_period_s: int = 600
    requests_persistence_s: int = 3600
    generate_proof: bool = True
    recursion_queries: int = 8
    # state / database
    db_read_retry_counter: int = 10
    db_read_retry_delay_ms: int = 100
    db_connections_pool_size: int = 30
    db_multiwrite: bool = True
    db_multiwrite_single_query_size: int = 20 << 20
    db_mt_cache_mb: int = 1024
    db_program_cache_mb: int = 512
    hashdb64: bool = False
    kvdb_max_versions: int = 131072
    # proving artifacts (the reference's 75 GB archive slots)
    zkevm_cm_pols_file: str = ""
    zkevm_const_pols_file: str = ""
    zkevm_verkey_file: str = ""
    final_zkey_file: str = ""
    # counters / capacity
    no_counters: bool = False
    max_steps: int = 1 << 23
    # --- full reference surface (config.hpp:15-202) ----------------------
    prover_id: str = ""                       # proverID: per-process UUID
    run_executor_client: bool = False
    run_executor_client_multithread: bool = False
    run_hashdb_test: bool = False
    run_aggregator_client_mock: bool = False
    run_file_process_batch_multithread: str = ""
    run_file_execute: str = ""
    # script generators + self-test modes (the reference's run*Test flags;
    # each maps to a tests/ module here — see main.run_self_tests)
    run_keccak_script_generator: bool = False
    run_sha256_script_generator: bool = False
    run_keccak_test: bool = False
    run_storage_sm_test: bool = False
    run_climb_key_sm_test: bool = False
    run_binary_sm_test: bool = False
    run_mem_align_sm_test: bool = False
    run_sha256_test: bool = False
    run_blake_test: bool = False
    run_ecrecover_test: bool = False
    run_database_cache_test: bool = False
    run_check_tree_test: bool = False
    run_database_performance_test: bool = False
    run_page_manager_test: bool = False
    run_key_value_tree_test: bool = False
    run_smt64_test: bool = False
    run_unit_test: bool = False
    check_tree_root: str = "auto"
    # executor behavior
    execute_in_parallel: bool = True
    use_main_exec_c: bool = False             # reference marks do-not-use
    dont_load_rom_offsets: bool = False
    executor_rom_line_traces: bool = False
    opcode_tracer: bool = False
    ecrecover_precalc: bool = False
    ecrecover_precalc_n_threads: int = 16
    full_tracer_trace_reserve_size: int = 256 * 1024
    # save-to-file debug taps
    save_request_to_file: bool = False
    save_db_reads_to_file: bool = False
    save_db_reads_to_file_on_change: bool = False
    save_files_in_subfolders: bool = False
    # DB cache preload + associative cache geometry
    load_db_to_mem_cache: bool = False
    load_db_to_mem_cache_in_parallel: bool = False
    load_db_to_mem_timeout_us: int = 30 * 1000 * 1000
    use_associative_cache: bool = False
    log2_db_mt_associative_cache_size: int = 25
    log2_db_mt_associative_cache_indexes_size: int = 28
    log2_db_kv_associative_cache_size: int = 25
    log2_db_kv_associative_cache_indexes_size: int = 28
    log2_db_versions_associative_cache_size: int = 25
    log2_db_versions_associative_cache_indexes_size: int = 28
    # executor client (a test client of the executor service)
    executor_client_host: str = "127.0.0.1"
    executor_client_port: int = 50071
    executor_client_loops: int = 1
    executor_client_check_new_state_root: bool = False
    executor_client_reset_db: bool = False
    # hashdb64 file store
    hashdb_file_name: str = "hashdb"
    hashdb_file_size_gb: int = 128
    hashdb_folder: str = "hashdb"
    db_cache_synch_url: str = ""
    # aggregator tuning
    aggregator_client_mock_timeout_us: int = 60 * 1000 * 1000
    aggregator_client_max_recv_msg_size: int = 100 << 20
    # logging taps
    log_executor_server_input_json: bool = False
    log_executor_server_input_gas_threshold: int = 0
    log_executor_server_responses: bool = False
    log_executor_server_txs: bool = True
    # memory-mapped artifact files
    map_const_pols_file: bool = False
    map_constants_tree_file: bool = False
    # database plumbing
    db_nodes_table_name: str = "state.nodes"
    db_program_table_name: str = "state.program"
    db_connections_pool: bool = True
    db_clear_cache: bool = False
    db_get_tree: bool = True
    db_read_only: bool = False
    # state manager
    state_manager: bool = True
    state_manager_purge: bool = True
    # thread pools
    max_hashdb_threads: int = 8
    # file-driven run inputs/outputs (the reference's 75 GB archive slots;
    # artifact roles map onto Setup/engine caches here — stark_info.py
    # consumes the starkinfo ones, snark/zkey.py the zkey)
    input_file2: str = ""
    config_path: str = "config"
    zkevm_cm_pols_after_executor: str = ""
    c12a_cm_pols: str = ""
    recursive1_cm_pols: str = ""
    recursive2_cm_pols: str = ""
    recursivef_cm_pols: str = ""
    final_cm_pols: str = ""
    c12a_const_pols: str = ""
    recursive1_const_pols: str = ""
    recursive2_const_pols: str = ""
    recursivef_const_pols: str = ""
    zkevm_constants_tree: str = ""
    c12a_constants_tree: str = ""
    recursive1_constants_tree: str = ""
    recursive2_constants_tree: str = ""
    recursivef_constants_tree: str = ""
    final_verkey_file: str = ""
    zkevm_verifier: str = ""
    recursive1_verifier: str = ""
    recursive2_verifier: str = ""
    recursivef_verifier: str = ""
    final_verifier: str = ""
    c12a_verkey_file: str = ""
    recursive1_verkey_file: str = ""
    recursive2_verkey_file: str = ""
    recursivef_verkey_file: str = ""
    c12a_exec_file: str = ""
    recursive1_exec_file: str = ""
    recursive2_exec_file: str = ""
    recursivef_exec_file: str = ""
    publics_output: str = "public.json"
    proof_file: str = "proof.json"
    keccak_script_file: str = ""
    sha256_script_file: str = ""
    keccak_pols_file: str = ""
    sha256_pols_file: str = ""
    keccak_connections_file: str = ""
    sha256_connections_file: str = ""
    storage_rom_file: str = ""
    zkevm_stark_info: str = ""
    c12a_stark_info: str = ""
    recursive1_stark_info: str = ""
    recursive2_stark_info: str = ""
    recursivef_stark_info: str = ""
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    _ENV_MAP = {
        "run_aggregator_client": "RUN_AGGREGATOR_CLIENT",
        "run_aggregator_server": "RUN_AGGREGATOR_SERVER",
        "run_executor_server": "RUN_EXECUTOR_SERVER",
        "run_hashdb_server": "RUN_HASHDB_SERVER",
        "aggregator_client_host": "AGGREGATOR_CLIENT_HOST",
        "aggregator_client_port": "AGGREGATOR_CLIENT_PORT",
        "hashdb_url": "HASHDB_URL",
        "database_url": "DATABASE_URL",
        "prover_name": "PROVER_NAME",
        "executor_server_port": "EXECUTOR_SERVER_PORT",
        "hashdb_server_port": "HASHDB_SERVER_PORT",
        "json_logs": "JSON_LOGS",
        "use_main_exec_generated": "USE_MAIN_EXEC_GENERATED",
        "no_counters": "NO_COUNTERS",
        "max_steps": "MAX_STEPS",
        "final_zkey_file": "FINAL_ZKEY_FILE",
        "output_path": "OUTPUT_PATH",
        "db_multiwrite": "DB_MULTIWRITE",
        "full_tracer_enabled": "FULL_TRACER_ENABLED",
    }

    # camelCase aliases so reference-style config JSON loads directly
    _JSON_ALIASES = {
        "runAggregatorClient": "run_aggregator_client",
        "runAggregatorServer": "run_aggregator_server",
        "runExecutorServer": "run_executor_server",
        "runHashDBServer": "run_hashdb_server",
        "aggregatorClientHost": "aggregator_client_host",
        "aggregatorClientPort": "aggregator_client_port",
        "aggregatorServerPort": "aggregator_server_port",
        "executorServerPort": "executor_server_port",
        "hashDBServerPort": "hashdb_server_port",
        "hashDBURL": "hashdb_url",
        "databaseURL": "database_url",
        "proverName": "prover_name",
        "forkID": "fork_id",
        "inputFile": "input_file",
        "jsonLogs": "json_logs",
        "executorTimeStatistics": "executor_time_statistics",
        "hashDB64": "hashdb64",
        "kvDBMaxVersions": "kvdb_max_versions",
        "dbMTCacheSize": "db_mt_cache_mb",
        "dbProgramCacheSize": "db_program_cache_mb",
        "proverID": "prover_id",
        "runHashDBTest": "run_hashdb_test",
        "runECRecoverTest": "run_ecrecover_test",
        "ECRecoverPrecalc": "ecrecover_precalc",
        "ECRecoverPrecalcNThreads": "ecrecover_precalc_n_threads",
        "loadDBToMemTimeout": "load_db_to_mem_timeout_us",
        "hashDBFileName": "hashdb_file_name",
        "hashDBFileSize": "hashdb_file_size_gb",
        "hashDBFolder": "hashdb_folder",
        "aggregatorClientMockTimeout": "aggregator_client_mock_timeout_us",
        "aggregatorClientWatchdogTimeout":
            "aggregator_client_watchdog_timeout_s",
        "dbNumberOfPoolConnections": "db_connections_pool_size",
        "dbMultiWrite": "db_multiwrite",
        "dbMultiWriteSingleQuerySize": "db_multiwrite_single_query_size",
        "dbReadRetryDelay": "db_read_retry_delay_ms",
        "maxHashDBThreads": "max_hashdb_threads",
        "cleanerPollingPeriod": "cleaner_polling_period_s",
        "requestsPersistence": "requests_persistence_s",
        "saveResponseToFile": "save_responses_to_file",
        "zkevmCmPols": "zkevm_cm_pols_file",
        "zkevmConstPols": "zkevm_const_pols_file",
        "zkevmVerkey": "zkevm_verkey_file",
        "c12aVerkey": "c12a_verkey_file",
        "recursive1Verkey": "recursive1_verkey_file",
        "recursive2Verkey": "recursive2_verkey_file",
        "recursivefVerkey": "recursivef_verkey_file",
        "finalVerkey": "final_verkey_file",
        "finalStarkZkey": "final_zkey_file",
        "c12aExec": "c12a_exec_file",
        "recursive1Exec": "recursive1_exec_file",
        "recursive2Exec": "recursive2_exec_file",
        "recursivefExec": "recursivef_exec_file",
        # legacy spellings still present in the reference's shipped configs
        "maxStateDBThreads": "max_hashdb_threads",
        "runFileExecutor": "run_file_execute",
    }

    @classmethod
    def load(cls, path: Optional[str] = None) -> "Config":
        cfg = cls()
        if path:
            with open(path) as f:
                data = json.load(f)
            fields = {f.name for f in dataclasses.fields(cls)}

            def snake(k):
                out = []
                for i, ch in enumerate(k):
                    if ch.isupper():
                        if i and (not k[i - 1].isupper()
                                  or (i + 1 < len(k) and k[i + 1].islower())):
                            out.append("_")
                        out.append(ch.lower())
                    else:
                        out.append(ch)
                return "".join(out)

            for k, v in data.items():
                name = cls._JSON_ALIASES.get(k, k)
                if name not in fields:
                    name = snake(k)
                if name in fields and name != "extra":
                    setattr(cfg, name, v)
                else:
                    cfg.extra[k] = v
        for attr, env in cls._ENV_MAP.items():
            if env in os.environ:
                cur = getattr(cfg, attr)
                raw = os.environ[env]
                if isinstance(cur, bool):
                    setattr(cfg, attr, raw.lower() in ("1", "true", "yes"))
                elif isinstance(cur, int):
                    setattr(cfg, attr, int(raw))
                else:
                    setattr(cfg, attr, raw)
        return cfg

    def check(self):
        assert 0 < self.n_bits <= 30, "n_bits out of range"
        assert self.blowup_bits >= 1
        assert self.n_queries >= 1
        if self.run_aggregator_client:
            assert self.aggregator_client_host
        return self

    def print(self):
        from .log import zklog
        for f in dataclasses.fields(self):
            if f.name == "extra":
                continue
            zklog.info(f"config.{f.name} = {getattr(self, f.name)}")
