"""Proofs of the JAX package that the PyTorch port's CPU tests hold the
port's proofs against, byte for byte (``StarkProof.to_json()``).

    python tools/torch_proof_fixtures.py              # rewrite all
    python tools/torch_proof_fixtures.py binary_sm_n10_q4
    python tools/torch_proof_fixtures.py g16_devnet_root_r11

writes ``tests/data/<name>.proof.json`` (``tests/data/<name>.json`` for a
file of digests, ``DIGESTS``); a Groth16 case (``GROTH16``)
writes the JAX package's snarkjs files ``verification_key.json``,
``proof.json`` and ``public.json`` into ``tests/data/<name>/``: the fib
bn128 final circuit with random.Random(7) (``g16_fib_bn128_r7``, about
2 min on the CPU) and the devnet root's final circuit over the committed
RecursiveF proof with random.Random(11) (``g16_devnet_root_r11``, about
12 min: the recursion pair's build, the R1CS, the JAX package's native
fixed-base and MSMs, its Python NTTs).  The JAX prover takes minutes on
the CPU for these cases, so the fast tests read the files and the slow
tests (``-m slow``) prove each case with the JAX package again and compare.
Devnet batch 0 at the 2^18 chains geometry (the Keccak-F and SHA-256-F
chains on, ``CHAINS``): ``zkevm_devnet0_n18_chains`` writes
``tests/data/zkevm_devnet0_n18_chains.json``, the widths, plookups,
executor steps, each cm1 and const column's sha256, the publics and the
verkey of the JAX package's run (its Setup: minutes), and
``zkevm_devnet0_n18_chains_q4`` the JAX proof (hours on the CPU); named
together, they share one execution and Setup.
The executor service's answers to devnet batch 0 (``EXECUTOR``):
``executor_devnet0`` writes ``tests/data/executor_devnet0.json``, the JAX
package's ProcessStatelessBatchV2 and ProcessBatchV2 responses to
``utils/devnet.devnet0_executor_requests()`` (deterministic serialisation,
hex; the requests' context ids fixed), its service's initial registers set
as the port's are (``jax_executor_service``; a second).
The fflonk case (``FFLONK``): ``fflonk_seeded_n12`` writes
``tests/data/fflonk_seeded_n12.json``, the JAX package's fflonk keys (the
verifying key, the proving key's parts by sha256) and proof of the port's
``plonk.seeded_r1cs`` circuit at n = 2^12 (~30 s).
The state phase (``STATE64``): ``state64_2e18`` writes
``tests/data/state64_2e18.json``, the JAX package's roots and reads of
``chip_smoke.py`` phase 14's seeded 2^18-leaf state (``Smt64`` with the
native Poseidon, ~1-2 min) and its sqlite service's answers.
The devnet batch 0 proof (``devnet_batch0_n16_q4``) is the committed
``a7_state_devnet/batch_proof_0vdev0_nb16_q4.json``: it is read in place
and never rewritten, and only ``jax_proof`` proves it again.
The JAX package does not change, so a file goes stale only if its case
does.

Each case builder takes the package whose modules build it (the JAX
package or the port), so both build the same trace from one definition.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import random
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def binary_sm_case(pkg: str, n_bits: int = 10):
    """The Binary SM as its own AIR (n_bits 10, chunk_bits 2, 4 queries)
    with seven seeded 256-bit actions.  -> (air, layout, const, cm1,
    publics)"""
    sm = importlib.import_module(f"{pkg}.models.zkevm.binary_sm")
    air_mod = importlib.import_module(f"{pkg}.stark.air")
    b = air_mod.AirBuilder("binary-sm", n_bits, n_queries=4, fri_fold_bits=3)
    layout = sm.build(b, n_bits, 2)
    air = b.compile()
    const_np = np.zeros((air.n, air.const_width), dtype=np.uint64)
    sm.fill_fixed(layout, const_np)
    cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
    rng = np.random.default_rng(77)
    acts = []
    for op in ["ADD", "SUB", "AND", "XOR", "OR", "LT", "EQ"]:
        a = int(rng.integers(0, 1 << 62)) << 190 | int(rng.integers(0, 1 << 62))
        b_ = int(rng.integers(0, 1 << 62)) << 100 | int(rng.integers(0, 1 << 62))
        acts.append((op, a, b_))
    sm.expand_trace(layout, acts[:air.n // layout.rows_per_op], cm1)
    return air, layout, const_np, cm1, []


COMPOSITE_MEM = [("W", 3, 10, 0), ("R", 3, 10, 1), ("W", 8, 5, 2),
                 ("R", 8, 5, 4)]


def composite_case(pkg: str, seed: int = 20260816):
    """The miniature composite (Main dispatch + Binary + Memory, n_bits
    11, chunk_bits 2, 4 queries): an ADD and an XOR of two seeded 60-bit
    operands, two writes and two reads.  -> (air, layout, const, cm1,
    publics)"""
    composite = importlib.import_module(f"{pkg}.models.zkevm.composite")
    air, layout = composite.build(n_bits=11, chunk_bits=2, n_queries=4)
    rng = np.random.default_rng(seed)
    a = int(rng.integers(0, 1 << 60))
    b = int(rng.integers(0, 1 << 60))
    const_np, cm1, _ = composite.gen_trace(
        air, layout, [("ADD", a, b), ("XOR", a, b)], COMPOSITE_MEM)
    return air, layout, const_np, cm1, []


def zkevm_mini_case(pkg: str):
    """The mini-ROM executed into the zkEVM composite AIR at the geometry of
    the JAX package's zkEVM proof test (n_bits 13, chunk_bits 2, limb_bits
    8, 4 queries).  -> (air, layout, const, cm1, publics)"""
    from xlayer_prover_tpu_torch.models.zkevm import mini_rom
    if pkg == "xlayer_prover_tpu":
        from tests.test_zkevm_proof import mini_rom as jmini_rom
        from xlayer_prover_tpu.executor.executor import Executor
        from xlayer_prover_tpu.state.hashdb import HashDB
        ex = Executor(jmini_rom(), **mini_rom.GEOMETRIES[13])
        res = ex.execute(HashDB())
    else:
        ex, res = mini_rom.execute(13)
    return ex.air, ex.layout, res.const_np, res.cm1_np, res.publics


# keys that force every SMT mode: K1/K2 diverge at level 4 (insertFound),
# K3 sits alone on the other side of the root, K7 shares K3's first four
# bits (a get miss and zeroToZero against K3's leaf)
SMT_KEYS = {"K1": (4, 1, 1, 1), "K2": (6, 1, 1, 1), "K3": (5, 1, 1, 1),
            "K7": (7, 1, 1, 1)}
SMT_SCRIPT = [("set", "K1", 100), ("set", "K2", 200 << 130),
              ("set", "K3", 300), ("set", "K1", 111), ("get", "K1", None),
              ("get", "K7", None), ("set", "K7", 0), ("set", "K3", 0),
              ("set", "K2", 0), ("set", "K1", 0), ("get", "K1", None)]


def smt_script(pkg: str):
    """The all-modes SMT script of tests/test_storage_executor.py:_script
    (insertNotFound, insertFound, update, get hit and miss, zeroToZero,
    deleteNotFound, deleteFound, the root leaf's deletion) run by `pkg`'s
    SMT.  -> [SmtAction]"""
    smt_mod = importlib.import_module(f"{pkg}.state.smt")
    db_mod = importlib.import_module(f"{pkg}.state.database")
    se = importlib.import_module(f"{pkg}.executor.storage_executor")
    smt = smt_mod.Smt(db_mod.MemoryDB())
    root = (0, 0, 0, 0)
    actions = []
    for kind, key, value in SMT_SCRIPT:
        if kind == "set":
            res = smt.set(root, SMT_KEYS[key], value)
            root = res.new_root
            actions.append(se.SmtAction(is_set=True, set_result=res))
        else:
            res = smt.get(root, SMT_KEYS[key])
            actions.append(se.SmtAction(is_set=False, get_result=res))
    return actions


def storage_case(pkg: str, n_bits: int = 11):
    """Storage + ClimbKey + PoseidonG as one AIR (the JAX package's
    tests/test_storage_sm_air.py circuit: n_bits 11, 8 queries, FRI fold
    3 bits) over the bundled micro-ROM, with the all-modes SMT script
    replayed into it.  -> (air, layout, const, cm1, publics); layout is
    (storage, climb_key, poseidon_g)."""
    srom = importlib.import_module(f"{pkg}.executor.storage_rom")
    air_mod = importlib.import_module(f"{pkg}.stark.air")
    zk = f"{pkg}.models.zkevm"
    storage_sm = importlib.import_module(f"{zk}.storage_sm")
    climb_key_sm = importlib.import_module(f"{zk}.climb_key_sm")
    poseidon_g_sm = importlib.import_module(f"{zk}.poseidon_g_sm")
    b = air_mod.AirBuilder("storage", n_bits, n_queries=8, fri_fold_bits=3)
    sl = storage_sm.build(b, srom.StorageRom.load_default(), n_bits)
    cl = climb_key_sm.build(b, n_bits)
    pl = poseidon_g_sm.build(b, n_bits)
    storage_sm.bind(b, sl, cl, pl)
    air = b.compile()
    const_np = np.zeros((air.n, air.const_width), dtype=np.uint64)
    storage_sm.fill_fixed(sl, const_np)
    climb_key_sm.fill_fixed(cl, const_np)
    poseidon_g_sm.fill_fixed(pl, const_np)
    cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
    pg, ck = storage_sm.expand_into(sl, smt_script(pkg), cm1)
    climb_key_sm.expand_into(cl, ck, cm1)
    poseidon_g_sm.expand_into(pl, [list(t[0]) for t in pg], cm1)
    return air, (sl, cl, pl), const_np, cm1, []


def devnet_input(pkg: str):
    """Devnet batch 0 (tools/run_a7_cascade.py build_devnet_inputs): a
    genesis of two accounts, one signed EIP-155 transfer of 1000 wei at
    nonce 0, chain 1001, encoded as a witness and a datastream and decoded
    by `pkg`.  -> BatchInput"""
    devnet = importlib.import_module(f"{pkg}.utils.devnet")
    witness = importlib.import_module(f"{pkg}.state.witness")
    ds = importlib.import_module(f"{pkg}.state.datastream")
    inp_mod = importlib.import_module(f"{pkg}.executor.input")
    chain_id, priv1, priv2 = 1001, 0xA11CE, 0xB0B
    a1, a2 = devnet.address_of(priv1), devnet.address_of(priv2)
    g = devnet.build_genesis([devnet.Account(address=a1, balance=10 ** 18),
                              devnet.Account(address=a2, balance=5)])
    wres = witness.witness2db(devnet.encode_witness(g))
    tx = devnet.sign_legacy_tx(nonce=0, gas_price=10 ** 9, gas=21000, to=a2,
                               value=1000, data=b"", chain_id=chain_id,
                               priv=priv1)
    batch = ds.datastream2batch(devnet.encode_datastream(
        batch_number=1, chain_id=chain_id, fork_id=9, coinbase=a2,
        blocks=[{"block_number": 1, "timestamp": 100,
                 "delta_timestamp": 100, "l1_info_tree_index": 0,
                 "txs": [tx]}]))
    inp = inp_mod.BatchInput(old_state_root=wres.state_root,
                             chain_id=chain_id, fork_id=9,
                             batch_l2_data=ds.batch_to_l2_data(batch),
                             sequencer_addr=a2, timestamp_limit=200)
    inp.db_raw = {k: list(v) for k, v in wres.db.items()}
    inp.programs_raw = {k: bytes(v) for k, v in wres.programs.items()}
    return inp


def devnet_prover(pkg: str, geometry=None):
    """`pkg`'s BatchProver over the fork_9 ROM with the Storage SM at
    `geometry` (None: the devnet geometry, the port's
    ``utils/devnet.DEVNET_GEOMETRY``); the port's proves on the CPU."""
    from xlayer_prover_tpu_torch.utils import devnet
    geometry = geometry or devnet.DEVNET_GEOMETRY
    if pkg != "xlayer_prover_tpu":
        return devnet.devnet_prover(device="cpu", geometry=geometry)
    from xlayer_prover_tpu.executor.rom import Rom
    from xlayer_prover_tpu.executor.storage_rom import StorageRom
    from xlayer_prover_tpu.prover_service import BatchProver
    return BatchProver(Rom.load_fork(9), **geometry,
                       storage_rom=StorageRom.load_default())


def devnet_case(pkg: str):
    """Devnet batch 0 executed by `pkg`'s BatchProver.  -> (air, layout,
    const, cm1, publics)"""
    engine = devnet_prover(pkg)
    res = engine.execute_only(devnet_input(pkg))
    return (engine.air, engine.executor.layout, res.const_np, res.cm1_np,
            res.publics)


def column_digests(table) -> list:
    """The sha256 of each column of a (rows, width) table of field
    elements, over the column's little-endian uint64 bytes, as hex.
    chip_smoke.py keeps a copy (it cannot import this tool); a CPU test
    holds the two equal."""
    table = np.asarray(table)
    return [hashlib.sha256(np.ascontiguousarray(table[:, j], dtype="<u8")
                           .tobytes()).hexdigest()
            for j in range(table.shape[1])]


# devnet batch 0 at the 2^18 geometry with the Keccak-F and SHA-256-F
# chains on (the port's ``utils/devnet.DEVNET_CHAINS_GEOMETRY``): a digest
# file CHAINS (tests/data/<CHAINS>.json) and the JAX proof CHAINS_PROOF
CHAINS = "zkevm_devnet0_n18_chains"
CHAINS_PROOF = "zkevm_devnet0_n18_chains_q4"
_CHAINS_RUN = {}


def chains_run_jax():
    """The JAX BatchProver at the chains geometry, its execution of devnet
    batch 0 and its Setup, built once a process (the digest file and the
    proof share them).  -> (engine, ExecutionResult, Setup)"""
    if not _CHAINS_RUN:
        from xlayer_prover_tpu_torch.utils import devnet
        engine = devnet_prover("xlayer_prover_tpu",
                               devnet.DEVNET_CHAINS_GEOMETRY)
        res = engine.execute_only(devnet_input("xlayer_prover_tpu"))
        _CHAINS_RUN["run"] = (engine, res, engine.setup())
    return _CHAINS_RUN["run"]


def chains_digests(air, steps, cm1, const_np, publics, verkey) -> dict:
    """What the chains fixture holds of one execution: the widths, the
    plookup count, the executor's steps, each cm1 and const column's
    ``column_digests``, the publics and the verkey."""
    return {"widths": [air.cm1_width, air.cm2_width, air.cm3_width,
                       air.const_width],
            "n_plookups": len(air.plookups),
            "executor_steps": int(steps),
            "cm1": column_digests(cm1), "const": column_digests(const_np),
            "publics": [int(p) for p in publics],
            "verkey": [int(v) for v in verkey]}


def chains_fixture_jax() -> str:
    """The chains digest file of the JAX package's run, as JSON text."""
    engine, res, setup = chains_run_jax()
    return json.dumps(chains_digests(
        engine.air, res.ctx.counters.steps, res.cm1_np, setup.const_n_np,
        res.publics, setup.verkey), indent=1)


def chains_proof_jax() -> str:
    """The JAX package's proof of devnet batch 0 at the chains geometry."""
    engine, res, _setup = chains_run_jax()
    return engine.prove_from_trace(res.cm1_np, res.publics).to_json()


def read_chains() -> dict:
    with open(os.path.join(DATA, f"{CHAINS}.json")) as f:
        return json.load(f)


def fib_inner(pkg: str):
    """The fib toy (n_bits 4, 2 queries) proven by `pkg`'s prover (the
    port's on the CPU): the inner proof of the JAX package's
    tests/test_recursion.py.  -> (air, setup, proof)"""
    fib = importlib.import_module(f"{pkg}.models.toy.fib")
    prover = importlib.import_module(f"{pkg}.stark.prover")
    air = fib.build_air(n_bits=4, n_queries=2)
    const_np, cm1, publics = fib.gen_trace(air)
    kw = {} if pkg == "xlayer_prover_tpu" else {"device": "cpu"}
    setup = prover.Setup.build(air, const_np, **kw)
    return air, setup, prover.gen_proof(setup, cm1, publics)


# the two fib traces (a0, b0, seed) whose proofs the service case
# aggregates; chip_smoke.py FIB_SVC_TRACES holds the same
SVC_FIB_TRACES = ((1, 1, 0), (2, 3, 1))


def svc_agg_fib_jax() -> str:
    """The JAX package's ``ProverService({"batch": (fib air, setup)},
    recursion_queries=4)`` answering GEN_AGGREGATED_PROOF over the proofs
    of the two fib traces ``SVC_FIB_TRACES`` (n_bits 4, 2 queries): the
    recursion pair with no chain link, both proofs lifted, then
    aggregated.  -> ``json.dumps`` of the RecursiveProof's ``to_json()``,
    the text of the service's artifact file"""
    from xlayer_prover_tpu.models.toy import fib
    from xlayer_prover_tpu.prover_service import (ProverRequest,
                                                  ProverService,
                                                  RequestState, RequestType)
    from xlayer_prover_tpu.stark import prover
    air = fib.build_air(n_bits=4, n_queries=2)
    setup = None
    proofs = []
    for a0, b0, seed in SVC_FIB_TRACES:
        const_np, cm1, publics = fib.gen_trace(air, a0=a0, b0=b0, seed=seed)
        setup = setup or prover.Setup.build(air, const_np)
        proofs.append(prover.gen_proof(setup, cm1, publics))
    svc = ProverService({"batch": (air, setup)}, recursion_queries=4)
    try:
        req = ProverRequest(RequestType.GEN_AGGREGATED_PROOF,
                            {"proof1": proofs[0], "proof2": proofs[1]})
        svc.submit(req)
        svc.wait(req.uuid, timeout=4 * 3600)
        if req.state != RequestState.COMPLETED:
            raise RuntimeError(f"GEN_AGGREGATED_PROOF {req.state}: "
                               f"{req.error}")
    finally:
        svc.shutdown()
    return json.dumps(req.proof.to_json())


def rec1_fib_case(pkg: str, inner=None):
    """Recursive1 over the fib inner proof at its own minimal domain
    (2^13 rows, 4 queries): the gate AIR of the traced fib verifier with
    its constant columns and witness.  `inner` is (verkey, proof JSON) of
    the inner proof; None proves it with `pkg` (``fib_inner``).  -> (air,
    layout, const, cm1, publics)"""
    engine = importlib.import_module(f"{pkg}.recursion.engine")
    gate_air = importlib.import_module(f"{pkg}.recursion.gate_air")
    vc = importlib.import_module(f"{pkg}.recursion.verifier_circuit")
    if inner is None:
        air, setup, proof = fib_inner(pkg)
        verkey = setup.verkey
    else:
        fib = importlib.import_module(f"{pkg}.models.toy.fib")
        proof_mod = importlib.import_module(f"{pkg}.stark.proof")
        air = fib.build_air(n_bits=4, n_queries=2)
        verkey, proof = inner[0], proof_mod.StarkProof.from_json(inner[1])
    tracer, _pw = engine.Recursive1.trace(air, verkey)
    gair, layout = gate_air.build(tracer, n_queries=4)
    kw = {} if pkg == "xlayer_prover_tpu" else {"device": "cpu"}
    const_np = np.zeros((gair.n, gair.const_width), dtype=np.uint64)
    gate_air.fill_fixed(layout, const_np, **kw)
    cm1 = np.zeros((gair.n, gair.cm1_width), dtype=np.uint64)
    vals = gate_air.fill_witness(layout, vc.flatten_proof(air, proof), cm1,
                                 **kw)
    return gair, layout, const_np, cm1, gate_air.publics_of(layout, vals)


def fib_bn128_case(pkg: str):
    """The fib toy (n_bits 4, 2 queries) over the BN128 commitment scheme
    (Poseidon-BN254 arity-16 trees, TranscriptBN128), as the JAX package's
    tests/test_final_circuit.py builds it.  -> (air, layout, const, cm1,
    publics)"""
    fib = importlib.import_module(f"{pkg}.models.toy.fib")
    air = fib.build_air(n_bits=4, n_queries=2)
    air.scheme = "bn128"
    const_np, cm1, publics = fib.gen_trace(air)
    return air, None, const_np, cm1, publics


def devnet_root_proof(pkg: str):
    """The committed aggregate root of the devnet cascade as `pkg`'s
    StarkProof."""
    proof_mod = importlib.import_module(f"{pkg}.stark.proof")
    with open(os.path.join(ROOT, "a7_state_devnet",
                           "aggregate_root_nb16_q4.json")) as f:
        return proof_mod.StarkProof.from_json(json.load(f)["proof"])


def recf_devnet_engine_jax():
    """The JAX package's RecursiveF engine (4 queries) over the devnet
    root's verifier: the recursion pair over the devnet AIR and
    DEVNET_VERKEY with the zkEVM chain spec (its recursive2 is the root's
    verifier), then RecursiveF over recursive2's AIR and verkey."""
    from xlayer_prover_tpu.recursion import engine, stack
    jeng = devnet_prover("xlayer_prover_tpu")
    link, out_map = stack.zkevm_chain_spec(jeng.air.n_publics)
    st = stack.RecursionStack(jeng.air, DEVNET_VERKEY, n_queries=4,
                              link=link, out_map=out_map)
    rec2 = st.rec2()
    root = devnet_root_proof("xlayer_prover_tpu")
    assert [int(v) for v in rec2.verkey] == \
        [int(v) for v in root.publics[:4]]
    return engine.RecursiveF(rec2.air, rec2.verkey, n_queries=4)


def recf_devnet_root_jax() -> str:
    """RecursiveF over the committed devnet aggregate root, proven by the
    JAX package on the CPU.  -> the proof's JSON"""
    recf = recf_devnet_engine_jax()
    return recf.prove(devnet_root_proof("xlayer_prover_tpu")).to_json()


def _groth16_jax(air, verkey, proof, rng):
    """The JAX package's Groth16 over the final circuit of a bn128 proof:
    setup, then prove, with one `rng` (as its RecursionStack.finalize
    does).  -> (vk, proof, publics)"""
    from xlayer_prover_tpu.snark import final_circuit, groth16
    r1cs, witness, _fb = final_circuit.build_final_circuit(air, verkey,
                                                           proof)
    pk, vk = groth16.setup(r1cs, rng=rng)
    g_proof = groth16.prove(pk, r1cs, witness, rng=rng)
    publics = witness[1:1 + r1cs.n_public]
    assert groth16.verify(vk, g_proof, publics)
    return vk, g_proof, publics


def g16_fib_bn128_jax():
    """Groth16 over the fib bn128 final circuit with random.Random(7), as
    the JAX package's tests/test_final_circuit.py
    test_groth16_final_roundtrip runs it."""
    from xlayer_prover_tpu.stark import prover
    air, _layout, const_np, cm1, publics = fib_bn128_case("xlayer_prover_tpu")
    setup = prover.Setup.build(air, const_np)
    proof = prover.gen_proof(setup, cm1, publics)
    return _groth16_jax(air, setup.verkey, proof, random.Random(7))


def g16_devnet_root_jax():
    """Groth16 over the final circuit of the committed devnet RecursiveF
    proof (``recF_devnet_root_q4``) with random.Random(11): the cascade's
    finalize(wrap="groth16", rng=random.Random(11))
    (tools/run_a7_cascade.py)."""
    from xlayer_prover_tpu.stark.proof import StarkProof
    recf = recf_devnet_engine_jax()
    proof = StarkProof.from_json(read("recF_devnet_root_q4"))
    return _groth16_jax(recf.air, recf.setup.verkey, proof,
                        random.Random(11))


def jax_executor_service(rom=None, labels=("start", "finalizeExecution")):
    """The JAX package's ExecutorServiceImpl over `rom` (None: its fork_9
    ROM), built as its ``main.py --run-services`` builds it (no AIR) but
    with the executor's labels, which that path leaves unset, and with the
    initial register file set from each request's input vars before its
    interpreters run (each fork's too), as the port's service sets it: the
    JAX service leaves the registers at zero, and every real fork_9 batch
    then fails a ROM assert (ROADMAP queue 3).  -> the service"""
    from xlayer_prover_tpu import main as jmain
    from xlayer_prover_tpu.executor import rom_functions as rf
    from xlayer_prover_tpu.executor.executor import Executor
    from xlayer_prover_tpu.executor.forks import ForkRegistry
    from xlayer_prover_tpu.executor.main_sm import MainExecutor, scalar_to_fea
    from xlayer_prover_tpu.services.executor_service import \
        ExecutorServiceImpl
    from xlayer_prover_tpu.state.hashdb import HashDB

    def with_registers(main):
        run = main.execute

        def execute(ctx, *labels):
            iv = ctx.input_vars
            ctx.regs.B = scalar_to_fea(int(iv.get("oldStateRoot", 0)))
            ctx.regs.C = scalar_to_fea(int(iv.get("oldAccInputHash", 0)))
            ctx.regs.SP = int(iv.get("oldBatchNum", 0))
            ctx.regs.GAS = int(iv.get("chainID", 0))
            ctx.regs.CTX = int(iv.get("forkID", 0))
            ctx.regs.SR = scalar_to_fea(int(iv.get("oldStateRoot", 0)))
            return run(ctx, *labels)
        main.execute = execute
        return main

    class Registry(ForkRegistry):
        def executor(self, fork_id):
            known = fork_id in self._execs
            main = super().executor(fork_id)
            return main if main is None or known else with_registers(main)

    if rom is None:
        rom, main = jmain._load_rom(None)
    else:
        main = MainExecutor(rom, max_steps=1 << 23)
        rf.register_all(main)
    executor = Executor.__new__(Executor)
    executor.rom = rom
    executor.main = with_registers(main)
    executor.start_label, executor.stop_label = labels
    impl = ExecutorServiceImpl(executor, HashDB())
    impl._forks = Registry()
    return impl


def executor_devnet0_jax() -> str:
    """The JAX package's answers to devnet batch 0's two executor requests
    (``utils/devnet.devnet0_executor_requests``), in the order a fresh
    service takes them (stateless first: it leaves the pre-state in the
    service's HashDB), as JSON: each response's deterministic
    serialisation in hex."""
    from xlayer_prover_tpu_torch.utils import devnet
    impl = jax_executor_service()
    stateless, batch = devnet.devnet0_executor_requests()
    out = {"process_stateless_batch_v2": impl.process_stateless_batch_v2(
               stateless, None),
           "process_batch_v2": impl.process_batch_v2(batch, None)}
    return json.dumps({k: v.SerializeToString(deterministic=True).hex()
                       for k, v in out.items()}, indent=1) + "\n"


def read_executor_devnet0() -> dict:
    """The committed ``executor_devnet0`` responses: name -> bytes."""
    with open(os.path.join(DATA, f"{EXECUTOR}.json")) as f:
        return {k: bytes.fromhex(v) for k, v in json.load(f).items()}


EXECUTOR = "executor_devnet0"
# the seeded R1CS of chip_smoke.py phase 13 (b): plonk.seeded_r1cs(seed,
# constraints) of the port (3,979 gates, n = 2^12) under fflonk with
# random.Random(rng_seed); the file records the three
FFLONK = "fflonk_seeded_n12"
FFLONK_CASE = {"seed": 20261018, "constraints": 760, "rng_seed": 5}


def fflonk_case(pkg: str):
    """The seeded R1CS of FFLONK_CASE converted by `pkg`'s plonk module.
    -> (circuit, wire values, publics, the R1CS)"""
    from xlayer_prover_tpu_torch.snark.plonk import seeded_r1cs
    plonk = importlib.import_module(f"{pkg}.snark.plonk")
    r1cs, witness = seeded_r1cs(FFLONK_CASE["seed"],
                                FFLONK_CASE["constraints"])
    circ = plonk.r1cs_to_plonk(r1cs)
    vals = plonk.plonk_witness(circ, r1cs, witness)
    return circ, vals, witness[1:1 + r1cs.n_public], r1cs


def fflonk_seeded_jax() -> str:
    """The JAX package's fflonk setup and proof of FFLONK_CASE (one
    random.Random(rng_seed) for both, as the tests of its fflonk do): the
    verifying key, proof and publics (``fflonk.to_json``), the proving
    key's parts by sha256 (``fflonk.key_digests``), n and the gate
    count.  -> the file's JSON text"""
    from xlayer_prover_tpu.snark import fflonk
    from xlayer_prover_tpu_torch.snark import fflonk as port_fflonk
    circ, vals, publics, _r1cs = fflonk_case("xlayer_prover_tpu")
    rng = random.Random(FFLONK_CASE["rng_seed"])
    pk, vk = fflonk.setup(circ, rng=rng)
    proof = fflonk.prove(pk, circ, vals, publics, rng=rng)
    assert fflonk.verify(vk, proof, publics)
    out = {**FFLONK_CASE, "n": circ.n, "gates": len(circ.gates),
           **port_fflonk.to_json(vk, proof, publics),
           "pk_sha256": port_fflonk.key_digests(pk)}
    return json.dumps(out, indent=1) + "\n"


def read_fflonk() -> dict:
    with open(os.path.join(DATA, f"{FFLONK}.json")) as f:
        return json.load(f)


# chip_smoke.py phase 14's seeded state (chip_smoke.state_case) and its
# sqlite processes, answered by the JAX package
STATE64 = "state64_2e18"


def state64_sqlite_jax(path: str) -> dict:
    """The JAX HashDB service over ``CachedDB(SqlDB(path))`` as its main.py
    builds it for databaseURL with loadDBToMemCache, taking phase 14's
    sqlite script (``chip_smoke.state_sqlite_script``) in a first service
    and then, over the same file, a second one warm from it; the JAX
    main.py does not store at exit what was flushed, so each service's
    sender is waited for.  -> the answers of both, decoded"""
    import chip_smoke
    from xlayer_prover_tpu.services.hashdb_service import HashDBServiceImpl
    from xlayer_prover_tpu.state.database import (CachedDB, SqlDB,
                                                  load_db_to_mem_cache)
    from xlayer_prover_tpu.state.hashdb import HashDB
    from xlayer_prover_tpu.utils.config import Config

    cfg = Config()
    case = chip_smoke.state_sqlite_case()
    answers = {}
    for name in ("first", "warm"):
        db = CachedDB(backend=SqlDB(path),
                      mt_cache_bytes=cfg.db_mt_cache_mb * (1 << 20),
                      program_cache_bytes=cfg.db_program_cache_mb * (1 << 20))
        impl = HashDBServiceImpl(HashDB(db))
        warmed = load_db_to_mem_cache(
            db, timeout_s=cfg.load_db_to_mem_timeout_us / 1e6)

        def call(rpc, req):
            return getattr(impl, chip_smoke.STATE_RPCS[rpc][2])(req, None)

        answers[name] = chip_smoke.state_sqlite_script(
            call, case, answers.get("first", {}).get("new_root"))
        answers[name]["warmed"] = warmed
        assert db.multi_write.wait_stored(
            db.flush_status()["last_flush_id"], timeout=60)
        db.multi_write.close()
        db.backend._conn.close()
    return answers


def state64_fixture(n_keys: int = None) -> dict:
    """The JAX package's roots and reads of chip_smoke.py phase 14's
    seeded operations at `n_keys` leaves (default chip_smoke.STATE_KEYS):
    Smt64.set_many of the whole state (write_tree's root), of the
    consolidation's batch and of the services' Set batch (ConsolidateState's
    root); the sampled Gets at the first consolidated root and 16 of them
    at the second (values, 64 hex digits); the sqlite processes' answers
    (``state64_sqlite_jax``).  Smt64 over an in-memory Database64: the KV
    history, which holds no root, is left out."""
    import tempfile

    import chip_smoke
    from xlayer_prover_tpu.state.hashdb64 import Database64, Smt64

    n = n_keys or chip_smoke.STATE_KEYS
    case = chip_smoke.state_case(n)
    smt = Smt64(Database64())
    root = smt.set_many((0, 0, 0, 0), dict(zip(case["keys"],
                                               case["values"])))
    first = smt.set_many(root, case["batch"])
    reads = [f"{smt.get(first, k)[0]:064x}" for k in case["reads"]]
    second = smt.set_many(first, case["rpc_batch"])
    after = [f"{smt.get(second, k)[0]:064x}" for k in case["reads"][:16]]
    with tempfile.TemporaryDirectory() as tmp:
        sqlite = state64_sqlite_jax(os.path.join(tmp, "nodes.sqlite"))
    return {"seed": chip_smoke.STATE_SEED, "keys": n,
            "write_tree_root": list(root),
            "consolidated": [list(first), list(second)], "reads": reads,
            "reads_after": after, "sqlite": sqlite}


def state64_jax() -> str:
    return json.dumps(state64_fixture(), indent=1) + "\n"


CASES = {"binary_sm_n10_q4": binary_sm_case,
         "composite_n11_q4": composite_case,
         "zkevm_mini_n13_q4": zkevm_mini_case,
         "storage_n11_q8": storage_case,
         "devnet_batch0_n16_q4": devnet_case,
         "rec1_fib_n13_q4": rec1_fib_case,
         "fib_bn128_n4_q2": fib_bn128_case}
# proofs that are not one Setup + gen_proof of a case: name -> the JAX
# package's proof JSON
PROOFS = {"recF_devnet_root_q4": recf_devnet_root_jax,
          "svc_agg_fib_q4": svc_agg_fib_jax,
          CHAINS_PROOF: chains_proof_jax}
# JSON files of the JAX package that are not proofs: name -> its text,
# written as tests/data/<name>.json
DIGESTS = {CHAINS: chains_fixture_jax, EXECUTOR: executor_devnet0_jax,
           FFLONK: fflonk_seeded_jax, STATE64: state64_jax}
# Groth16 proofs of the JAX package: name -> (vk, proof, publics), written
# as snarkjs files (SNARKJS_FILES) into tests/data/<name>/
GROTH16 = {"g16_fib_bn128_r7": g16_fib_bn128_jax,
           "g16_devnet_root_r11": g16_devnet_root_jax}
SNARKJS_FILES = ("verification_key.json", "proof.json", "public.json")
# the verkey (constant-tree root) of the devnet AIR at
# DEVNET_GEOMETRY: the port's Setup.build on the CPU gave these limbs (the
# slow tests/test_torch_recursion.py::test_devnet_verkey_is_the_setup_root
# builds it again); the verifier circuit replays the committed devnet
# proof only under the verkey that proof was made with
DEVNET_VERKEY = [14832465569959553833, 11155289007394171011,
                 2647493096237404943, 5862035215467919731]
# committed elsewhere, as {"level": 0, "proof": <to_json()>}: read, never
# rewritten
IN_PLACE = {"devnet_batch0_n16_q4": os.path.join(
    ROOT, "a7_state_devnet", "batch_proof_0vdev0_nb16_q4.json")}


def path(name: str) -> str:
    return IN_PLACE.get(name, os.path.join(DATA, f"{name}.proof.json"))


def read(name: str) -> str:
    with open(path(name)) as f:
        text = f.read()
    return json.loads(text)["proof"] if name in IN_PLACE else text


def snarkjs_dir(name: str) -> str:
    return os.path.join(DATA, name)


def write_groth16(name: str, out_dir: str):
    """The JAX package's Groth16 case `name` as its snarkjs files
    (verification_key.json, proof.json, public.json) in `out_dir`."""
    from xlayer_prover_tpu.snark import snarkjs_io
    vk, g_proof, publics = GROTH16[name]()
    os.makedirs(out_dir, exist_ok=True)
    vk_path, proof_path, pub_path = (os.path.join(out_dir, f)
                                     for f in SNARKJS_FILES)
    snarkjs_io.export_vk(vk, vk_path)
    snarkjs_io.export_proof(g_proof, proof_path)
    snarkjs_io.export_publics(publics, pub_path)
    assert snarkjs_io.verify_files(vk_path, pub_path, proof_path)


def jax_proof(name: str) -> str:
    """The JAX package's proof of case `name` on the CPU, as JSON."""
    if name in PROOFS:
        return PROOFS[name]()
    from xlayer_prover_tpu.stark import prover
    air, _layout, const_np, cm1, publics = CASES[name]("xlayer_prover_tpu")
    setup = prover.Setup.build(air, const_np)
    return prover.gen_proof(setup, cm1, publics).to_json()


def main(names) -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(DATA, exist_ok=True)
    for name in names or [c for c in (*CASES, *DIGESTS, *PROOFS, *GROTH16)
                          if c not in IN_PLACE]:
        if name in IN_PLACE:
            raise SystemExit(f"{path(name)} is read in place, never "
                             f"rewritten")
        if name in DIGESTS:
            out = os.path.join(DATA, f"{name}.json")
            with open(out, "w") as f:
                f.write(DIGESTS[name]())
            print(f"wrote {out}", flush=True)
            continue
        if name in GROTH16:
            write_groth16(name, snarkjs_dir(name))
            print(f"wrote {snarkjs_dir(name)}")
            continue
        text = jax_proof(name)
        with open(path(name), "w") as f:
            f.write(text)
        print(f"wrote {path(name)} ({len(text)} bytes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
