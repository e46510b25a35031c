#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xlayer_prover_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full run: builds the kernels, proves
                                     # the 2^20-row Binary SM AIR, the
                                     # mini-ROM's zkEVM composite AIR at
                                     # 2^13 rows, then the whole devnet
                                     # cascade (four batches through the
                                     # fork_9 ROM at 2^16 rows served by
                                     # ProverService, two lifts and two
                                     # aggregations at 2^18 rows,
                                     # RecursiveF and Groth16), then the
                                     # request path on the fib toy,
                                     # then devnet batch 0 at 2^18 rows
                                     # with the Keccak-F and SHA-256-F
                                     # chains, then the entry point
                                     # (main.py as processes, devnet
                                     # batch 0 served over gRPC), then
                                     # the streamed sections: batch 0 at
                                     # 2^18 under 16 GiB and at 2^20;
                                     # after phase 8, phase 13: the
                                     # devnet root's final circuit under
                                     # fflonk

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build the CUDA kernels from
     xlayer_prover_tpu_torch/csrc with nvcc (sm_90a) into build/kernels/;
  2. hold each kernel against its plain PyTorch version on the card, bit
     for bit, and time both at the main path's shapes: poseidon_permute
     on 2^20 states; poseidon_linear_hash at widths 5, 8, 9, 20 and 39
     (4,096 rows each), at the first tree level (2^20 x 8) and at the cm1
     leaves (2^21 x 39), the rows it is timed on (edge and non-canonical
     rows included in all); gl_mul on 2^24 pairs;
  3. prove the fib toy (n_bits=5, 8 queries) on the card and on the CPU:
     the proofs must be byte-equal and verify;
  4. the main path at full size: the zkEVM Binary state machine as its own
     AIR (``binary_sm.seeded_case``: n_bits=20, chunk_bits=4, 8 queries,
     FRI fold 3 bits, 4,096 seeded 256-bit actions; its trace is made
     before phase 2, which times gl_mul at the AIR's LDE shape):
     Setup.build, gen_proof, verify, and a tampered trace that must be
     refused; the launch counts of this phase show that the proof went
     through poseidon_linear_hash (every Merkle leaf and level) and gl_mul.
     poseidon_permute is off this path; its row reports its count, 0;
  5. zkevm: the mini-ROM (``models/zkevm/mini_rom.py``) executed by the
     port's Executor into the composite AIR without Storage and ClimbKey
     (Main + Binary, Memory, Arith, PoseidonG, PaddingPG, MemAlign and
     ArithEC, the Main<->Memory permutation) at n_bits 13 (chunk_bits 2,
     limb_bits 8, 4 queries): Setup.build and gen_proof (launches counted
     from 0); the card's proof must be byte-equal to the JAX package's,
     committed as tests/data/zkevm_mini_n13_q4.proof.json, and verify.
     Phase 6 proves the same circuit with Storage and ClimbKey at 2^16;
  6. the devnet cascade, the main path of this slice
     (``xlayer_prover_tpu_torch/cascade.py``, the port of
     ``tools/run_a7_cascade.py --devnet 4``) in a fresh state directory,
     build/a7_state_devnet/, launches counted from 0 over the whole run:
     the devnet Setup (fork_9 ROM with the Storage and ClimbKey SMs, 519
     committed columns, 2^16 rows, chunk_bits 4, limb_bits 16, 4
     queries); four chained batch proofs, read back from their
     a7_state_devnet/ files (the cascade's depth, cut for the time limit:
     ``CASCADE_READ_BACK``; phase 11 proves batch 0 again as a
     GenStatelessBatchProof served by ``ProverService``); the
     recursion pair over the devnet AIR and verkey (gate AIRs at 2^18
     rows, the zkEVM chain link), the lifts recursive1_0 and
     recursive1_1, aggregate_01 over them and aggregate_root over
     aggregate_01 and aggregate_23 (recursive1_2, recursive1_3 and
     aggregate_23 read back from a7_state_devnet/, the same depth cut);
     verify_root; ``finalize(root,
     wrap="groth16", snark=True, rng=random.Random(11))`` and Groth16's
     verify.  Every other stage must run (none resumed) and launch its
     kernels; its seconds, launches and peak device memory print as one
     ``cascade`` line before the kernels line.
     Then the batch checks: each batch proof byte-equal to its
     a7_state_devnet/ file and verified, newStateRoot_k ==
     oldStateRoot_{k+1}, the batch publics head equal to
     PROOF_a7_cascade_devnet.json's; batch 0 executed again, whose trace
     with a forged sRD value and whose claim of a wrong new-state-root
     public must both be refused; phase 2's kernels held bit for bit at the
     devnet shapes (the cm1 leaves, 2^17 x 519, against the plain version
     on their first 2^16 rows; an LDE stage, 2^16 x 519);
  7. the recursion checks: the four stages proven in phase 6, each
     byte-equal to its a7_state_devnet/ file, and all seven verified (the
     root also through ``finalize(wrap="stark")``); batch
     proof 0 with a root limb moved by one and the pair recursive1_1 +
     recursive1_0 (the wrong order) must raise ValueError at witness time,
     and the root with a payload public changed must be refused by the
     verifier; the kernels held bit for bit at the recursive1 shapes (the
     cm1 leaves, 2^19 x 60, their first 2^16 rows against the plain
     version; an LDE stage, 2^18 x 60);
  8. the final-stage checks: RecursiveF (recursive1 over the BN128
     commitment scheme: Poseidon-BN254 arity-16 trees, TranscriptBN128)
     over recursive2 byte-equal to the JAX package's, committed as
     tests/data/recF_devnet_root_q4.proof.json, and verified; the proof
     with one Fr root moved and with a payload public changed refused.
     The Groth16 proof (setup with the fixed-base kernels, h with the Fr
     NTT, the G1 and G2 MSMs): its verification_key.json, proof.json and
     public.json (written by the port's snarkjs_io into build/) byte-equal
     to tests/data/g16_devnet_root_r11/, accepted from the files alone,
     refused with a changed public; its publics the 52
     ``groth16_publics`` of PROOF_a7_cascade_devnet.json.  Then the
     Poseidon-BN254 kernels held bit for bit at its shapes (the cm1, cm3,
     const and cm4 leaves and the first tree level), and each shape the
     stage launched them at (recorded around the wrappers, written to
     build/poseidon_bn254_final_shapes.json) timed again: their time in
     the stage, summed by shape;
  9. the request path on the fib toy (n_bits 4, 2 queries), launches
     counted from 0: ``ProverService({"batch": (air, setup)},
     recursion_queries=4)`` serves two GEN_BATCH_PROOFs, a
     GEN_AGGREGATED_PROOF over them (the recursion pair with no chain
     link) byte-equal to the JAX service's,
     tests/data/svc_agg_fib_q4.proof.json, a GEN_FINAL_PROOF (the default
     wrap, "stark") returning the verified root, and a GEN_BATCH_PROOF
     cancelled while it runs (the card kept busy ahead of it), which must
     end CANCELLED at a round boundary; the next request must complete.
     Every request must end COMPLETED, or the phase raises with its
     error.
 10. the chains path, devnet batch 0 at 2^18 rows
     (``utils/devnet.DEVNET_CHAINS_GEOMETRY``: the fork_9 ROM with the
     Storage SM and the Keccak-F and SHA-256-F chains, one gate slot of 48
     instances each; 669 / 600 / 999 / 361 columns, 100 plookups), launches
     counted from 0 and the peak device memory reset before the setup:
     the setup, then one GEN_BATCH_PROOF request to
     ``ProverService(batch_prover=...)`` that must end COMPLETED.  Held
     against tests/data/zkevm_devnet0_n18_chains.json (the JAX package's,
     ``tools/torch_proof_fixtures.py``): the widths and plookups, the sha256
     of every cm1 and const column of the request's execution, the
     executor's steps, the publics and the verkey; the proof byte-equal to
     tests/data/zkevm_devnet0_n18_chains_q4.proof.json where that JAX
     proof was made; it verifies (the service verifies it before the
     request completes), and with one evaluation or one public changed it
     is refused.  The port's ``gates.execute`` run on the card
     over the Keccak slot's 48 input states equals
     ``execute_all_wires_np`` at the script's outputs; phase 2's kernels
     held bit for bit and timed at the chains shapes (the cm1 leaves,
     2^19 x 669, against the plain version on their first 2^16 rows; an
     LDE stage, 2^18 x 669).  Its seconds
     (setup, execution, STARK by round, verification), peak memory and
     launches print as the ``chains_2e18`` line.
 11. the entry point (``xlayer_prover_tpu_torch/main.py`` and the gRPC
     services), (a) and (b) side by side as two processes: (a)
     ``python3 -m xlayer_prover_tpu_torch.main --prove-toy`` as a process
     on the card, whose JSON line must say verified; (b)
     ``main.py -c build/entry/config.json --run-services`` as a process
     with the HashDB and executor servers and the aggregator client on
     loopback ports, the client connected to a ``MockAggregatorServer``
     made here: a HashDB Set / Get / GetFlushStatus round trip, devnet
     batch 0 through ProcessStatelessBatchV2 and then ProcessBatchV2 (the
     responses byte-equal to the JAX package's,
     tests/data/executor_devnet0.json, the new state root the committed
     batch proof's), GetStatus with the configured prover name, and a
     GenStatelessBatchProof whose GetProof gives RESULT_INTERNAL_ERROR (the
     service of ``--run-services`` has no batch prover, as in the JAX
     package); then SIGINT, and the process must exit with 0; (c) in this
     process, ``AggregatorClient(ProverService(batch_prover=
     devnet.devnet_prover()))`` over loopback gRPC, launches counted from
     0 and the peak memory reset before the setup: devnet batch 0 as
     GenStatelessBatchProof, its GetProof RESULT_COMPLETED_OK with the
     proof text byte-equal to a7_state_devnet/'s batch proof 0 (as the
     cascade's stage file writes it) and verified; a second request
     cancelled while pending (RESULT_CANCEL), an unknown id
     (RESULT_ERROR); every launch from the service's worker thread.  The
     request's seconds (execution, STARK, verification), the wire's own
     seconds, the processes' start-up seconds, peak memory and launches
     print as the ``entry`` line.
 12. the StarkInfo memory plan and the streamed sections
     (``stark/stark_info.memory_plan``, ``stark/prover.section_plan``):
     (a) poseidon_linear_hash with a carried capacity over RATE-aligned
     column blocks read in place, at 2^20 x 39 and 2^19 x 669, bit-equal
     to the one-shot digest and to its plain version (first 4,096 rows),
     timed at the streamed LDE's block (2^19 and 2^21 rows x 64, its
     ``more_shapes`` in the kernels line); (b) phase 10's devnet batch 0
     at 2^18 proven again under a budget of 16 GiB (the JAX memory_plan's
     default), where the plan streams (the extended sections in
     page-locked host memory, LDE and leaves a column block at a time,
     the quotient and round 5 over row windows), launches counted from 0:
     byte-equal to phase 10's proof, verified, the allocator's peak at
     or under 16 GiB; the plan, windows, seconds by round, copies and
     peaks print as the ``stream_2e18`` line; (c) devnet batch 0 at 2^20
     rows with the chains (``devnet.devnet_geometry(20)``) as one
     GEN_BATCH_PROOF to ``ProverService(batch_prover=...)`` under the
     card's own memory, where the plan streams, launches counted from 0:
     verified, a changed evaluation and a changed public refused, the
     publics those of tests/data/zkevm_devnet0_n18_chains.json; its
     execution, STARK by round, verification, rows a second, peak device
     and host memory, the host <-> device copies' seconds and GB/s and
     the launches print as the ``chains_2e20`` line.
 13. the PLONK conversion and the fflonk wrap, run after phase 8 (which
     it reads): (b) the seeded R1CS of tests/data/fflonk_seeded_n12.json
     (``plonk.seeded_r1cs``: 3,979 gates, n = 2^12) converted, set up and
     proven with random.Random(its rng seed): the verifying key, the
     proving key's parts (by sha256) and the proof equal to the JAX
     package's file, verified; (c) the devnet root's final circuit, phase
     8's R1CS and witness (kept from the cascade's finalize, no second
     build), launches counted from 0 and the peak reset first:
     ``plonk.r1cs_to_arrays`` (one host pass with the witness), then
     ``fflonk.setup`` and ``fflonk.prove`` with random.Random(11), the
     cascade's seed, on the card; ``fflonk.verify`` must accept, and
     refuse the proof with its z evaluation changed and with a changed
     public; the gates, n, SRS points, the conversion's, setup's
     (by part) and proof's seconds (NTTs, the identities, divisions,
     evaluations, each commitment), verification's, the peaks and the
     launches print as the ``fflonk`` line; (a) fr_eval,
     fr_div_binomial, fr_scan_mul and fr_pointwise bit-equal to their
     plain versions at small shapes (chain boundaries, the look-back's
     tile edges, and ~10^5 tiles checked by the division's identity at
     random points; fr_eval at 5 to 9 points about its tile and past its
     grid, every coefficient r - 1; fr_scan_mul's product look-back,
     prefix and suffix, over up to 514 tiles, its repeated form across
     its tables' 2^L and at tau^i's length against the host) and at 2^20
     rows of each devnet use, then
     timed at every shape of (c)'s wrap with their bounds and launches a
     wrap (the kernels line's rows, ``launches`` from the ``fflonk``
     path; a line of launches x (ms - bound) a wrap for each kernel);
     fr_ntt at 2^26 and 2^27: the round trip, and 8
     positions of the forward transform equal to fr_eval's values there
     and to the host's sums for a 3-term input.
Phase 2 also holds the two Poseidon-BN254 kernels against their plain
versions (and prints how many warps of each an SM holds):
poseidon_bn254_permute at every width t = 2..17 on 3 states fewer and 5
more than the batch at which the launcher turns from 8 lanes a state to 4
(the library's poseidon_bn254_few_states), on extreme states (each of 0,
1, r - 1, r, r + 1, 2^256 - 1 in every lane, lanes mixed over them, and
inputs above r), on 2^16 of the 2^20 t = 17 states it is timed on and on
the 8,192 (a 2^17-leaf tree's first level) it is timed on too;
poseidon_bn254_leaf_hash at widths 1, 3, 4, 5, 6, 39, 48, 50, 51, 60 and
519 and at the 2^17 x 60 rows it is timed on.
And Groth16's kernels: bn254_fixed_base_g1 / _g2 on 2^12 + 37 scalars
(``bn254_msm.fixed_base_cases``: 0, 1, 255, 256, r - 1, r - 2, 2^253,
bytes of 0xFF, d 2^(8w) at every window, r and a scalar whose last
addition doubles, blocks all at infinity, a block with one live lane, a
ragged last block; their tables' build timed on the host), then
bn254_msm_g1 / _g2 on 2^14 points made by them (points at infinity,
zero scalars, r - 1, a repeated point, a point beside its negation, one
point under the signed digits +5 and -5 in a window, digits of 2^(c - 1)
and -(2^(c - 1) - 1) in every window, a bucket of a quarter of the
points across 64 chunks; 10-bit windows) against the plain version
(the step-by-step model ``_msm_model`` is held on the CPU, by
tests/test_torch_msm.py), and on the 2^20 points they are
timed on (16-bit windows, as on the main path) with all but 8,212
scalars set to 0, each MSM's stages timed at 2^20 with CUDA events,
fr_ntt either side of each pass boundary (2^0 .. 2^3, 2^7, 2^10 .. 2^12,
2^22, 2^23: one, two and three passes; at 2^22 and 2^23 the forward
transform, the inverse by the round trip), on edge values, the round trip,
and at phase 8's three shapes (a 2^20 inverse, the 2^21 forward and
inverse), each timed, with its device launches a call (counted by the
library at each launch);
its 2^21 forward twiddle table built on the card (fr_ntt_twiddles,
timed) equal to the host-built one (the inverse tables are held by the
inverse transforms), their cold build timed on the host; fr_mul_sub at
2^21 with edge values; each timed at the devnet root's shapes (2^20
scalars and points, 2^21 values).  The cascade's final stage builds its
twiddle tables anew; phase 8 prints h's split (g16_h_eval_s,
g16_h_ntt_s).
Phase 2 times each plain version on the call it is held against (one
call) and its kernels over few repetitions, which leaves room for phase
13 in the time limit; the checks are the same.
It prints a ``{"kernels": [...]}`` line (``launches``: the count on the
cascade, the main path that launches every kernel, 0 included, and for
fflonk's four kernels the count on the ``fflonk`` path;
``launches_by_path`` has every path's, the cascade's batch, recursion and
final parts, ``chains_2e18``, phase 10's, ``entry_2e16``, phase 11's (c),
``stream_2e18`` and ``chains_2e20``, phase 12's (b) and (c), and
``fflonk``, phase 13's (c))
and ends with
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT_MUL_PER_CLK_SM = 64            # 32-bit integer multiplies, cc 9.0
GL_MUL_MULS = 4                    # 32x32->64 partial products/element
FR_PROD32 = 2 * 64                 # 32-bit multiplies of a full product
                                   # of two 8 x 32-bit words Fr values
FR_SQR32 = 2 * 36                  # of a square (36 distinct word pairs)
FR_REDC32 = 8 * 17                 # of one Montgomery reduction
FR_MUL = FR_PROD32 + FR_REDC32     # a reduced product, M (Fq or Fr)
FR_SQ = FR_SQR32 + FR_REDC32       # a reduced square, S
# an Fq2 product counts as 3 Fq products, a square as 2
CURVE_OPS = {"g1": {"mixed": 7 * FR_MUL + 4 * FR_SQ,
                    "full": 11 * FR_MUL + 5 * FR_SQ, "mul": FR_MUL,
                    "point_bytes": 64},
             "g2": {"mixed": 7 * 3 * FR_MUL + 4 * 2 * FR_MUL,
                    "full": 11 * 3 * FR_MUL + 5 * 2 * FR_MUL,
                    "mul": 3 * FR_MUL, "point_bytes": 128}}
SEED = 20261016                    # kernel inputs of phase 2
SHAPE_PLAIN_ROWS = 1 << 16         # check_shapes: leaf rows held to plain
# the kernels that every Setup.build + gen_proof of a path launches
GL_PATH_KERNELS = ("poseidon_linear_hash", "gl_mul")
G16_KERNELS = ("bn254_msm_g1", "bn254_msm_g2", "bn254_fixed_base_g1",
               "bn254_fixed_base_g2", "fr_ntt", "fr_ntt_twiddles",
               "fr_mul_sub")
FINAL_KERNELS = ("poseidon_bn254_leaf_hash", "poseidon_bn254_permute",
                 "gl_mul", *G16_KERNELS)
FFLONK_KERNELS = ("fr_eval", "fr_div_binomial", "fr_scan_mul",
                  "fr_pointwise")
# the paths driven with the launch counts set to 0 just before: each must
# launch these kernels
PATH_KERNELS = {"binary_sm_2e20": GL_PATH_KERNELS,
                "zkevm_2e13": GL_PATH_KERNELS,
                "cascade": (*GL_PATH_KERNELS, *FINAL_KERNELS[:2],
                            *G16_KERNELS),
                "service_fib": GL_PATH_KERNELS,
                "chains_2e18": GL_PATH_KERNELS,
                "entry_2e16": GL_PATH_KERNELS,
                "stream_2e18": GL_PATH_KERNELS,
                "chains_2e20": GL_PATH_KERNELS,
                "fflonk": (*FFLONK_KERNELS, "fr_ntt", "fr_ntt_twiddles",
                           "bn254_msm_g1", "bn254_fixed_base_g1")}
# the cascade's parts (``cascade_groups``): each stage of a part must
# launch these kernels
STAGE_KERNELS = {"cascade_batches": GL_PATH_KERNELS,
                 "cascade_recursion": GL_PATH_KERNELS,
                 "cascade_final": FINAL_KERNELS}
RECF_FIXTURE = os.path.join(REPO, "tests", "data",
                            "recF_devnet_root_q4.proof.json")
G16_FIXTURE = os.path.join(REPO, "tests", "data", "g16_devnet_root_r11")
G16_OUT = os.path.join(REPO, "build", "g16_devnet_root_r11")
# the shape of every Poseidon-BN254 launch of phase 8, with its launches
# (xlayer_prover_tpu_torch/poseidon_bn254_times.py --shapes reads it)
BN254_SHAPES = os.path.join(REPO, "build", "poseidon_bn254_final_shapes.json")
SNARKJS_FILES = ("verification_key.json", "proof.json", "public.json")
CASCADE_RECORD = os.path.join(REPO, "PROOF_a7_cascade_devnet.json")
ZKEVM_FIXTURE = os.path.join(REPO, "tests", "data",
                             "zkevm_mini_n13_q4.proof.json")
NEW_STATE_ROOT = 19                # publics[19:27]: newStateRoot limbs
A7 = os.path.join(REPO, "a7_state_devnet")
# the cascade's stage files and record, made anew in each run
CASCADE_DIR = os.path.join(REPO, "build", "a7_state_devnet")
# The cascade's depth, cut for the run's time limit: the stages named
# here are read back from their committed a7_state_devnet/ files (the
# port's own proofs, made on the card) instead of being proven again.
# The four batch proofs (cut when phase 12 came; phase 11 proves batch 0
# again as a served request, and phase 7 proves batch 0's trace with a
# wrong public) and the second half of the recursion tree (recursive1_2,
# recursive1_3, aggregate_23, cut when phase 13 came).  The lifts of
# batches 0 and 1, aggregate_01 over them, aggregate_root over
# aggregate_01 and the read-back aggregate_23, and the final stage are
# proven here; phases 6 and 7 check every stage's proof as before.
CASCADE_READ_BACK = ("batch_proof_0vdev0", "batch_proof_1vdev1",
                     "batch_proof_2vdev2", "batch_proof_3vdev3",
                     "recursive1_2", "recursive1_3", "aggregate_23")
CASCADE_OUT = os.path.join(REPO, "build", "PROOF_a7_cascade_devnet.json")
RECURSION_STAGES = ("recursive1_0", "recursive1_1", "recursive1_2",
                    "recursive1_3", "aggregate_01", "aggregate_23",
                    "aggregate_root")
SVC_AGG_FIXTURE = os.path.join(REPO, "tests", "data",
                               "svc_agg_fib_q4.proof.json")
# the fib traces (a0, b0, seed) of phase 9, those of the fixture
# (tests/test_torch_prover_service.py holds the two equal)
FIB_SVC_TRACES = ((1, 1, 0), (2, 3, 1))
# phase 10's JAX fixtures (tools/torch_proof_fixtures.py): the digests,
# publics and verkey of devnet batch 0 at the 2^18 chains geometry, and
# the JAX proof where it was made
CHAINS_FIXTURE = os.path.join(REPO, "tests", "data",
                              "zkevm_devnet0_n18_chains.json")
CHAINS_PROOF = os.path.join(REPO, "tests", "data",
                            "zkevm_devnet0_n18_chains_q4.proof.json")
# phase 11: the entry point's files (config, logs) and the JAX package's
# executor responses to devnet batch 0 (tools/torch_proof_fixtures.py)
ENTRY_DIR = os.path.join(REPO, "build", "entry")
EXECUTOR_FIXTURE = os.path.join(REPO, "tests", "data",
                                "executor_devnet0.json")
ENTRY_PROVER_NAME = "entry-smoke-prover"
ENTRY_START_S = 300.0              # a process's start, a service's answer
ENTRY_PROOF_S = 900.0              # GetProof's wait for the served proof
A7_BATCH0 = os.path.join(A7, "batch_proof_0vdev0_nb16_q4.json")


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(torch, fn):
    """(fn(), its ms on the card) of one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _rand_below(rng, n: int, mod: int) -> list:
    """n seeded Python ints below `mod` (< 2^256), each a 256-bit draw
    reduced: the bytes of all n drawn at once."""
    raw = rng.bytes(32 * n)
    return [int.from_bytes(raw[i:i + 32], "little") % mod
            for i in range(0, 32 * n, 32)]


def _max_abs_err(got, ref) -> int:
    """Largest |got - ref| over the uint64 patterns (0 when bit-equal)."""
    import torch
    if torch.equal(got, ref):
        return 0
    bad = (got != ref).nonzero(as_tuple=True)
    g = got[bad].cpu().numpy().view("uint64")
    r = ref[bad].cpu().numpy().view("uint64")
    return max(abs(int(a) - int(b)) for a, b in zip(g, r))


def print_ptxas(logs: dict):
    """The kernels, registers and spills of each library's ptxas log."""
    for name, log in logs.items():
        print(f"built {name}:", flush=True)
        for ln in log.splitlines():
            if any(k in ln for k in ("entry function", "registers", "spill")):
                print("  " + ln.strip(), flush=True)


def _require(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def column_digests(table) -> list:
    """The sha256 of each column of a (rows, width) table of field
    elements, over the column's little-endian uint64 bytes, as hex: the
    copy of tools/torch_proof_fixtures.column_digests (a CPU test holds
    the two equal)."""
    import hashlib

    import numpy as np
    table = np.asarray(table)
    return [hashlib.sha256(np.ascontiguousarray(table[:, j], dtype="<u8")
                           .tobytes()).hexdigest()
            for j in range(table.shape[1])]


def poseidon_mul32() -> int:
    """32-bit multiplies of one Poseidon permutation in its fewest-multiply
    form, the sparse partial rounds of ``poseidon_constants.sparse_form``
    (which the kernels run).  A product by a constant c costs 0
    multiplies (c = 0 or 1), 2 (c < 2^32) or 4 (32x32->64 partial
    products); the x^7 S-box is two squares (3 each) and two products."""
    from xlayer_prover_tpu_torch.ops import poseidon_constants as pc

    def cost(c):
        return 0 if c < 2 else 2 if c < 1 << 32 else 4

    sf = pc.sparse_form()
    _, mds = pc.get_params()
    dense = sum(cost(c) for row in mds for c in row)
    pre = sum(cost(c) for row in sf.pre for c in row)
    sparse = sum(cost(m00) + sum(map(cost, v)) + sum(map(cost, w))
                 for m00, v, w in sf.sparse)
    sboxes = pc.WIDTH * pc.FULL_ROUNDS + pc.PARTIAL_ROUNDS
    return (pc.FULL_ROUNDS - 1) * dense + pre + sparse + sboxes * 14


def bn254_mul32(t: int) -> int:
    """32-bit multiplies of one Poseidon-BN254 permutation of width t in
    its fewest-multiply form, over the compressed rounds the kernels run:
    the x^5 S-box is two squares and a product, each reduced; a
    dot-product output (a matrix row, a partial round's s0) is t
    unreduced products and one reduction; a partial round's t - 1 lane
    updates are a reduced product each.  8 full rounds of t S-boxes and
    t dot products, then each partial round's S-box, s0 and lane
    updates.  The Montgomery conversions in and out are left out."""
    from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn
    sbox = 2 * (FR_SQR32 + FR_REDC32) + FR_PROD32 + FR_REDC32
    dot = t * FR_PROD32 + FR_REDC32
    full = t * sbox + t * dot
    partial = sbox + dot + (t - 1) * (FR_PROD32 + FR_REDC32)
    return pbn.N_ROUNDS_F * full + pbn.N_ROUNDS_P[t - 2] * partial


def leaf_mul32(width: int) -> int:
    """32-bit multiplies of one BN128 leaf hash of a row of `width`
    Goldilocks words (none for a row of width <= 4: its packing)."""
    if width <= 4:
        return 0
    n_fr = -(-width // 3)
    full, tail = divmod(n_fr, 16)
    return full * bn254_mul32(17) + (bn254_mul32(tail + 1) if tail else 0)


def resident_warps(lib) -> dict:
    """Warps an SM holds of the Poseidon-BN254 kernel each shape runs on
    (the launchers choose the group of lanes a state from t and n)."""
    fn = lib.poseidon_bn254_resident_warps
    return {"permute_t17_2e20": fn(17, 0, 1 << 20, 0),
            "permute_t17_512": fn(17, 0, 512, 0),
            "leaf_hash_w60": fn(5, 1, 1 << 17, 60),
            "leaf_hash_w6": fn(3, 1, 1 << 17, 6)}


def bn254_permute_work(n: int) -> dict:
    """Bytes and 32-bit multiplies of poseidon_bn254_permute over n
    states of t = 17: each state read and written once."""
    return {"bytes": 2 * 17 * 32 * n, "ops": bn254_mul32(17) * n}


def bn254_leaf_work(m: int, width: int) -> dict:
    """Bytes and 32-bit multiplies of poseidon_bn254_leaf_hash over m rows
    of `width` words: each row read once, each Fr digest written once."""
    return {"bytes": (width + 4) * 8 * m, "ops": leaf_mul32(width) * m}


def msm_work(group: str, points, scalars) -> dict:
    """Bytes and 32-bit multiplies of an MSM over these inputs, whatever
    computes it: Pippenger with signed c-bit digits (negating a point is
    free, so 2^(c - 1) buckets a window) over the pairs of a finite point
    and a nonzero scalar, a mixed addition (7 M + 4 S) for each nonzero
    digit of those pairs and two full additions (11 M + 5 S) a bucket for
    the running sums, at the c (2 .. 20) that makes it least; each point
    and scalar read once."""
    from xlayer_prover_tpu_torch.ops import bn254_msm
    live = (points != 0).any(-1) & (scalars != 0).any(-1)
    ops = CURVE_OPS[group]
    least = min(
        int((bn254_msm.signed_digits(scalars[live], c) != 0).sum())
        * ops["mixed"] + bn254_msm.n_windows(c) * (2 << (c - 1))
        * ops["full"] for c in range(2, bn254_msm.MAX_WINDOW_BITS + 1))
    return {"bytes": points.shape[0] * (ops["point_bytes"] + 32),
            "ops": least}


def fixed_base_work(group: str, scalars) -> dict:
    """Bytes and 32-bit multiplies of a fixed-base batch over these
    scalars: 8-bit windows over a precomputed table, a mixed addition for
    each nonzero byte of a scalar, and 3 products a nonzero scalar for a
    batch normalisation; each scalar read and each point written once."""
    ops = CURVE_OPS[group]
    nbytes = sum(int((((scalars >> (8 * k)) & 0xFF) != 0).sum())
                 for k in range(8))
    nonzero = int((scalars != 0).any(-1).sum())
    return {"bytes": scalars.shape[0] * (32 + ops["point_bytes"]),
            "ops": nbytes * ops["mixed"] + nonzero * 3 * ops["mul"]}


def ntt_work(n: int, inverse: bool = False) -> dict:
    """Bytes and 32-bit multiplies of one Fr NTT of n values: the (n / 2)
    log2 n butterflies less the n - 1 whose twiddle is w^0 = 1 (one a
    group in every stage) need a product each, and the inverse's scale n
    more; one read and one write of n x 32 bytes."""
    products = (n // 2) * (n.bit_length() - 1) - (n - 1)
    return {"bytes": 2 * 32 * n,
            "ops": (products + (n if inverse else 0)) * FR_MUL}


def mul_sub_work(n: int) -> dict:
    """a b - c over n Fr values: one product each, three reads and a
    write of n x 32 bytes."""
    return {"bytes": 4 * 32 * n, "ops": n * FR_MUL}


def int_mul_rate(torch) -> float:
    """32-bit integer multiplies a second of the card at its top clock."""
    from xlayer_prover_tpu_torch import device
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(device.smi("clocks.max.sm").split()[0]) * 1e6
    return sms * INT_MUL_PER_CLK_SM * clock_hz


def phase_kernels(torch, rng, n_ext_half_cols: int):
    """Each kernel against its plain version, bit for bit, and timed."""
    import numpy as np

    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.ops import poseidon_gl

    P = gl.P
    cuda = torch.device("cuda")
    int_rate = int_mul_rate(torch)
    edges = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, 1 << 63,
                      P, P + 1, (1 << 64) - 1], dtype=np.uint64)
    rows = []

    # -- poseidon_permute: 2^20 seeded states + edge rows ------------------
    n = 1 << 20
    states = rng.integers(0, P, size=(n, 12), dtype=np.uint64)
    states[0:len(edges)] = edges[:, None]
    states[len(edges)] = [P + k for k in range(12)]
    states[len(edges) + 1] = [(1 << 64) - 1 - k for k in range(12)]
    states[len(edges) + 2:len(edges) + 66] = rng.integers(
        P, (1 << 64) - 1, size=(64, 12), dtype=np.uint64, endpoint=True)
    t = gl.from_u64_np(states, cuda)
    got = poseidon_gl.permute(t)
    # the plain version timed on the call it is held against (one call)
    ref, plain_ms = _timed(torch, lambda: poseidon_gl._permute_plain(t))
    err = _max_abs_err(got, ref)
    _require(err == 0, "poseidon_permute equals its plain version")
    del got, ref
    ms = _cuda_ms(lambda: poseidon_gl.permute(t), 10)
    rows.append({
        "name": "poseidon_permute", "route": "cuda",
        "more_shapes": [],
        "source": "xlayer_prover_tpu_torch/csrc/poseidon_gl.cu",
        "replaces": "xlayer_prover_tpu/ops/pallas_poseidon.py:209",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bytes": 192 * n, "ops": poseidon_mul32() * n, "shape": [n, 12],
        "plain_shape": [n, 12]})
    del t
    torch.cuda.empty_cache()

    # -- poseidon_linear_hash: every width class, then the main path's -----
    def hash_rows(count, width):
        r = rng.integers(0, P, size=(count, width), dtype=np.uint64)
        r[0:len(edges)] = edges[:, None]
        r[len(edges):len(edges) + 8] = rng.integers(
            P, (1 << 64) - 1, size=(8, width), dtype=np.uint64,
            endpoint=True)
        return gl.from_u64_np(r, cuda)

    err = 0
    for width in (5, 8, 9, 20, 39):
        r = hash_rows(4096, width)
        err = max(err, _max_abs_err(poseidon_gl.linear_hash(r, width),
                                    poseidon_gl._linear_hash_plain(r, width)))
    # the main path's shapes, each held on the very rows it is timed on:
    # the first tree level (2^20 x 8) and the cm1 leaves (2^21 x 39)
    level = hash_rows(1 << 20, 8)
    err = max(err, _max_abs_err(poseidon_gl.linear_hash(level, 8),
                                poseidon_gl._linear_hash_plain(level, 8)))
    leaves = hash_rows(1 << 21, 39)
    got = poseidon_gl.linear_hash(leaves, 39)
    torch.cuda.empty_cache()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = poseidon_gl._linear_hash_plain(leaves, 39)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max(err, _max_abs_err(got, ref))
    _require(err == 0, "poseidon_linear_hash equals its plain version")
    del got, ref
    torch.cuda.empty_cache()
    ms = _cuda_ms(lambda: poseidon_gl.linear_hash(leaves, 39), 5)
    level_ms = _cuda_ms(lambda: poseidon_gl.linear_hash(level, 8), 10)
    print(f"kernel poseidon_linear_hash at [1048576, 8] (first tree level): "
          f"{level_ms:.4f} ms (bound "
          f"{poseidon_mul32() * (1 << 20) / int_rate * 1e3:.4f} ms by "
          f"operations)", flush=True)
    rows.append({
        "name": "poseidon_linear_hash", "route": "cuda",
        "more_shapes": [],
        "source": "xlayer_prover_tpu_torch/csrc/poseidon_gl.cu",
        "replaces": "xlayer_prover_tpu/ops/poseidon_gl.py:153",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bytes": (39 + 4) * 8 * (1 << 21),
        "ops": poseidon_mul32() * 5 * (1 << 21), "shape": [1 << 21, 39],
        "plain_shape": [1 << 21, 39]})
    del leaves, level
    torch.cuda.empty_cache()

    # -- gl_mul: 2^24 seeded pairs + every edge pair ------------------------
    m = 1 << 24
    a = rng.integers(0, P, size=m, dtype=np.uint64)
    b = rng.integers(0, P, size=m, dtype=np.uint64)
    a[:edges.size ** 2] = np.repeat(edges, edges.size)
    b[:edges.size ** 2] = np.tile(edges, edges.size)
    ta, tb = gl.from_u64_np(a, cuda), gl.from_u64_np(b, cuda)
    err = _max_abs_err(gl.gl_mul(ta, tb), gl._mul_plain(ta, tb))
    s = tb[7].clone()
    err = max(err, _max_abs_err(gl.gl_mul(ta, s), gl._mul_plain(ta, s)))
    del ta, tb
    # timed at the main path's largest shape: one butterfly stage of the
    # cm1 LDE, (n_ext / 2) x cm1_width elements
    ta = torch.randint(-(1 << 63), (1 << 63) - 1, (n_ext_half_cols,),
                       dtype=torch.int64, device=cuda)
    tb = torch.randint(-(1 << 63), (1 << 63) - 1, (n_ext_half_cols,),
                       dtype=torch.int64, device=cuda)
    err = max(err, _max_abs_err(gl.gl_mul(ta, tb), gl._mul_plain(ta, tb)))
    _require(err == 0, "gl_mul equals its plain version")
    ms = _cuda_ms(lambda: gl.gl_mul(ta, tb), 20)
    plain_ms = _cuda_ms(lambda: gl._mul_plain(ta, tb), 1)
    rows.append({
        "name": "gl_mul", "route": "cuda",
        "more_shapes": [],
        "source": "xlayer_prover_tpu_torch/csrc/gl_mul.cu",
        "replaces": "xlayer_prover_tpu/fields/gl.py:154",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bytes": 24 * n_ext_half_cols, "ops": GL_MUL_MULS * n_ext_half_cols,
        "shape": [n_ext_half_cols], "plain_shape": [n_ext_half_cols]})
    del ta, tb
    torch.cuda.empty_cache()

    for r in rows:
        _bound(r, int_rate)
    return rows


def phase_bn254_kernels(torch, rng):
    """The two Poseidon-BN254 kernels against their plain versions, bit for
    bit, and timed (phase 2)."""
    import numpy as np

    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.ops import bn254_mont
    from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn

    from xlayer_prover_tpu_torch import kernels

    cuda = torch.device("cuda")
    int_rate = int_mul_rate(torch)
    fr = pbn.P
    top = (1 << 256) - 1
    edges = bn254_mont.to_words([0, 1, fr - 1, fr, fr + 1, top]
                                ).view(np.uint64)
    lib = kernels.load("poseidon_bn254")
    print("poseidon_bn254 resident warps an SM: " + json.dumps(
        resident_warps(lib)), flush=True)

    def fr_states(n, t):
        """Seeded 256-bit inputs (most above r, which the kernel reduces;
        every other state below 2^252) with the extreme states first: each
        edge in every lane, then lanes mixed over r - 1, 0, r, 2^256 - 1,
        1 and r - 1 beside 2^256 - 1."""
        w = rng.integers(0, (1 << 64) - 1, size=(n, t, 4), dtype=np.uint64,
                         endpoint=True)
        w[1::2, :, 3] >>= np.uint64(4)
        w[:len(edges)] = edges[:, None, :]
        for k, cyc in enumerate(((fr - 1, 0, fr, top, 1), (fr - 1, top)),
                                len(edges)):
            w[k] = bn254_mont.to_words([cyc[i % len(cyc)] for i in range(t)]
                                       ).view(np.uint64)
        return w

    err = 0
    # a batch just under the library's threshold runs at 8 lanes a state
    # and one just over it at 4 (t >= 6; one lane at t <= 5), each with a
    # ragged last warp
    few = lib.poseidon_bn254_few_states()
    for t, n_states in ((t, n) for t in range(2, 18)
                        for n in (few - 3, few + 5)):
        w = fr_states(n_states, t)
        x = gl.from_u64_np(w, cuda)
        got = pbn.permute(x, t)
        err = max(err, _max_abs_err(got, pbn._permute_plain(x, t)))
        host = [v for k in (2, 3, 6, 7, 9) for v in pbn.host_permute(
            bn254_mont.from_words(w[k]))]
        _require(bn254_mont.from_words(got[[2, 3, 6, 7, 9]]) == host,
                 f"poseidon_bn254_permute t={t} equals host_permute")
    n = 1 << 20
    x = gl.from_u64_np(fr_states(n, 17), cuda)
    head = x[:1 << 16]
    # the plain version timed on the call it is held against (one call)
    ref, plain_ms = _timed(torch, lambda: pbn._permute_plain(head, 17))
    err = max(err, _max_abs_err(pbn.permute(head, 17), ref))
    del ref
    level = x[:8192]
    err = max(err, _max_abs_err(pbn.permute(level, 17),
                                pbn._permute_plain(level, 17)))
    _require(err == 0, "poseidon_bn254_permute equals its plain version")
    ms = _cuda_ms(lambda: pbn.permute(x, 17), 2)
    level_ms = _cuda_ms(lambda: pbn.permute(level, 17), 5)
    level_bound, _ = _bound_ms(bn254_permute_work(8192), int_rate)
    print(f"kernel poseidon_bn254_permute at [8192, 17, 4] (a 2^17-leaf "
          f"tree's first level): {level_ms:.4f} ms (bound "
          f"{level_bound:.4f} ms)", flush=True)
    rows = [{
        "name": "poseidon_bn254_permute", "route": "cuda",
        "source": "xlayer_prover_tpu_torch/csrc/poseidon_bn254.cu",
        "replaces": "xlayer_prover_tpu/native/posbn.cpp:139",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bn254_permute_work(n), "shape": [n, 17, 4],
        "plain_shape": [1 << 16, 17, 4],
        "more_shapes": [{"shape": [8192, 17, 4], "ms": level_ms,
                         "bound_ms": level_bound}]}]
    del x, head, level
    torch.cuda.empty_cache()

    err = 0
    for width in (1, 3, 4, 5, 6, 39, 48, 50, 51, 60, 519):
        r = rng.integers(0, (1 << 64) - 1, size=(4096, width),
                         dtype=np.uint64, endpoint=True)
        r[:6] = np.array([0, 1, gl.P - 1, gl.P, 1 << 63, (1 << 64) - 1],
                         dtype=np.uint64)[:, None]
        r[6, ::2], r[6, 1::2] = 0, (1 << 64) - 1
        t = gl.from_u64_np(r, cuda)
        got = pbn.leaf_hash(t, width)
        err = max(err, _max_abs_err(got, pbn._leaf_hash_plain(t, width)))
        _require(bn254_mont.from_words(got[[5, 6, 9]]) ==
                 [pbn.leaf_hash_host([int(v) for v in r[k]])
                  for k in (5, 6, 9)],
                 f"poseidon_bn254_leaf_hash width {width} equals the host "
                 "leaf hash")
    m, width = 1 << 17, 60
    leaves = torch.randint(-(1 << 63), (1 << 63) - 1, (m, width),
                           dtype=torch.int64, device=cuda)
    got = pbn.leaf_hash(leaves, width)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = pbn._leaf_hash_plain(leaves, width)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max(err, _max_abs_err(got, ref))
    _require(err == 0, "poseidon_bn254_leaf_hash equals its plain version")
    del got, ref
    ms = _cuda_ms(lambda: pbn.leaf_hash(leaves, width), 2)
    rows.append({
        "name": "poseidon_bn254_leaf_hash", "route": "cuda",
        "more_shapes": [],
        "source": "xlayer_prover_tpu_torch/csrc/poseidon_bn254.cu",
        "replaces": "xlayer_prover_tpu/native/posbn.cpp:215",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bn254_leaf_work(m, width), "shape": [m, width],
        "plain_shape": [m, width]})
    del leaves
    torch.cuda.empty_cache()
    for r in rows:
        _bound(r, int_rate)
    return rows


def _flat(pt) -> list:
    """An affine G1 or G2 point's coordinates as a flat list of ints ([]
    at infinity)."""
    if pt is None:
        return []
    return [v for c in pt for v in (c if isinstance(c, tuple) else (c,))]


def _curve_inputs(torch, rng, gen_group: str, n: int):
    """n seeded points of G1 or G2 made on the card by the fixed-base
    kernel (held against its plain version before), and n scalars, with
    every edge of the MSM kernels among the first rows: points at
    infinity, zero scalars, r - 1, one point repeated under one scalar, a
    point beside its negation, one point under the signed digits +5 and
    -5 in window 0, scalars whose every window holds the digit 2^(c - 1)
    or -(2^(c - 1) - 1) (c = window_bits(n)), and scalar 1 on a quarter of
    the rows (the heavy bucket of Groth16's witnesses, which spans many
    chunks of the bucket sums)."""
    from xlayer_prover_tpu_torch.fields import bn254, bn254_tower
    from xlayer_prover_tpu_torch.ops import bn254_mont, bn254_msm

    cuda = torch.device("cuda")
    r = bn254.R
    c = bn254_msm.window_bits(n)
    ks = [int(v) % r for v in rng.integers(1, 1 << 63, size=n)]
    gen = bn254.G1_GEN if gen_group == "g1" else bn254_tower.G2_GEN
    fixed = getattr(bn254_msm, f"fixed_base_{gen_group}")
    pts = fixed(gen, torch.from_numpy(bn254_mont.to_words(ks)).to(cuda))
    sc = _rand_below(rng, n, r)
    sc[0] = sc[1] = 0
    sc[2] = r - 1
    sc[n // 4:n // 2] = [1] * (n // 2 - n // 4)
    sc[9:17] = [sc[8]] * 8
    pts[3] = 0
    pts[9:17] = pts[8]
    fw = pts.shape[1] // 2                # words of a coordinate
    neg = [(bn254.P - v) % bn254.P for v in bn254_mont.from_words(
        pts[6, fw:].reshape(-1, 4).cpu())]
    pts[7] = pts[6]
    pts[7, fw:] = torch.from_numpy(bn254_mont.to_words(neg)).reshape(-1).to(
        cuda)
    sc[7] = sc[6]
    half, high = 1 << (c - 1), sc[17] >> (c + 2) << c
    pts[18] = pts[17]
    sc[17], sc[18] = high | 5, high | ((1 << c) - 5)
    windows = range(0, bn254_msm.SCALAR_BITS - c, c)
    sc[19] = sum(half << w for w in windows)
    sc[20] = sum((half + 1) << w for w in windows)
    return pts, torch.from_numpy(bn254_mont.to_words(sc)).to(cuda)


def phase_g16_kernels(torch, rng):
    """Groth16's kernels against their plain versions on the card, bit for
    bit, with every edge among the inputs, at small shapes and at the
    main path's (the MSMs' 16-bit windows, the NTT at 2^21 and a 2^20
    inverse), then timed at the devnet root's shapes (phase 2): the MSMs
    and fixed-base batches at 2^20, the NTT and a b - c at 2^21."""
    from xlayer_prover_tpu_torch.fields import bn254, bn254_tower
    from xlayer_prover_tpu_torch.ops import bn254_mont, bn254_msm, ntt_fr

    cuda = torch.device("cuda")
    int_rate = int_mul_rate(torch)
    r = bn254.R
    small, mid, big = 1 << 12, 1 << 14, 1 << 20
    rows = []
    src = "xlayer_prover_tpu_torch/csrc/bn254_msm_{}.cu"
    msm_cpp = "xlayer_prover_tpu/native/msm.cpp:{}"

    def words(vals):
        return torch.from_numpy(bn254_mont.to_words(vals)).to(cuda)

    # -- fixed base: the edges of bn254_msm.fixed_base_cases at 2^12 + 37
    # scalars (a ragged last block, blocks all at infinity, a block with
    # one live lane), then timed on 2^20 seeded scalars -----------------
    for group, gen, line, ops in (("g1", bn254.G1_GEN, 481, bn254_msm.FQ1_OPS),
                                  ("g2", bn254_tower.G2_GEN, 495,
                                   bn254_msm.FQ2_OPS)):
        fn = getattr(bn254_msm, f"fixed_base_{group}")
        t0 = time.perf_counter()
        bn254_msm._device_table(gen, cuda)
        table_s = time.perf_counter() - t0
        ks = bn254_msm.fixed_base_cases(small + 37, SEED)
        sc = words(ks)
        got = fn(gen, sc)
        ref, plain_ms = _timed(torch, lambda: bn254_msm._fixed_base_plain(
            ops, gen, sc))
        err = _max_abs_err(got, ref)
        _require(err == 0, f"bn254_fixed_base_{group} equals its plain "
                 "version")
        w = bn254_msm.FB_CASE_BLOCK
        live = got[2 * w:4 * w].any(-1).nonzero().flatten().tolist()
        _require(live == [w + 77], f"bn254_fixed_base_{group} gives "
                 "zero words for k = 0 and only there")
        host = getattr(bn254_msm, f"{group}_points")(got[4:6].cpu())
        want = [bn254.g1_to_affine(bn254.g1_mul(bn254.g1_from_affine(gen), k))
                if group == "g1" else bn254_tower.g2_mul(gen, k)
                for k in ks[4:6]]
        _require(host == want, f"bn254_fixed_base_{group} of r - 1 and "
                 "r - 2 equals the host's")
        big_sc = words(_rand_below(rng, big, r))
        ms = _cuda_ms(lambda: fn(gen, big_sc), 1)
        rows.append({
            "name": f"bn254_fixed_base_{group}", "route": "cuda",
            "more_shapes": [],
            "source": src.format(group), "replaces": msm_cpp.format(line),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **fixed_base_work(group, big_sc), "shape": [big],
            "plain_shape": [len(ks)]})
        print(f"fixed base {group}: its table of 32 x 255 points built on "
              f"the host in {table_s:.3f} s", flush=True)
        del big_sc, got, ref
        torch.cuda.empty_cache()

    # -- MSM: edge inputs at 2^14 (c = 10: 26 windows of 512 buckets, a
    # bucket of a quarter of the points across 64 chunks) against the plain
    # version (the step-by-step model _msm_model is held on the CPU, by
    # tests/test_torch_msm.py); then the timed 2^20 inputs
    # (c = 16, the main path's layout) with every 128th scalar and the
    # edge rows kept and the rest set to 0, against the plain version over
    # the kept rows (the others add nothing); then each stage timed on the
    # full 2^20 inputs -----------------------------------------------------
    for group, line, ops in (("g1", 288, bn254_msm.FQ1_OPS),
                             ("g2", 318, bn254_msm.FQ2_OPS)):
        fn = getattr(bn254_msm, f"msm_{group}")
        affine = getattr(bn254_msm, f"to_affine_{group}")
        err = 0
        for n in (mid, big):
            pts, sc = _curve_inputs(torch, rng, group, n)
            idx = torch.arange(n, device=cuda)
            keep = (idx % 128 == 0) | (idx < 21) | (n == mid)
            got = fn(pts, torch.where(keep[:, None], sc, 0))
            ref, ms = _timed(torch, lambda: bn254_msm._msm_plain(
                ops, pts[keep], sc[keep]))
            a, b = _flat(affine(got)), _flat(affine(ref))
            err = max([err] + [abs(u - v) for u, v in zip(a, b)])
            _require(a == b and len(a) > 0, f"bn254_msm_{group} at {n} "
                     "points equals its plain version (affine)")
            if n == mid:
                plain_ms = ms
                print(f"bn254_msm_{group} at {n}: equal to _msm_plain in "
                      "affine", flush=True)
        _require(affine(fn(pts, torch.zeros_like(sc))) is None,
                 f"bn254_msm_{group} of zero scalars is infinity")
        ms = _cuda_ms(lambda: fn(pts, sc), 2)
        stages = []
        bn254_msm._msm(f"bn254_msm_{group}", ops, pts, sc, stages=stages)
        torch.cuda.synchronize()
        split = {}
        for (_, a), (stage, b) in zip(stages, stages[1:]):
            split[stage] = split.get(stage, 0.0) + a.elapsed_time(b)
        print(f"bn254_msm_{group} at {big} points, ms by stage: "
              + json.dumps(split), flush=True)
        rows.append({
            "name": f"bn254_msm_{group}", "route": "cuda",
            "more_shapes": [],
            "source": src.format(group), "replaces": msm_cpp.format(line),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **msm_work(group, pts, sc), "shape": [big],
            "plain_shape": [mid]})
        del pts, sc, idx, keep
        torch.cuda.empty_cache()

    # -- the Fr NTT: the 2^21 forward's twiddle table expanded on the card
    # against the host-built one, and timed (the inverse tables are held
    # by the transforms below, bit-equal at their shapes); the kernel
    # bit-equal to its plain version either side of each pass boundary
    # (2^11 values a block: one pass to 2^11, two to 2^22, three beyond;
    # above 2^12 the inverse by the round trip), on edge values, the round
    # trip, and at phase 8's three shapes, each timed; the device launches
    # of one call counted by the library -----------------------------
    err = 0
    tw_rows, table_s = [], {}
    for bits in (0, 1, 2, 3, 7, 10, 11, 12, 22, 23):
        if bits <= 12:                         # uniform below r
            x = words(_rand_below(rng, 1 << bits, r))
        else:
            # in bulk: words 0-2 take every 64-bit value, word 3 is
            # below 2^60, so the value is below 2^252 < r
            x = rng.integers(-(1 << 63), 1 << 63, size=(1 << bits, 4),
                             dtype="int64")
            x[:, 3] &= (1 << 60) - 1
            x = torch.from_numpy(x).to(cuda)
        x0 = x.clone()
        for inverse in (False, True) if bits <= 12 else (False,):
            err = max(err, _max_abs_err(ntt_fr.ntt(x, inverse),
                                        ntt_fr._ntt_plain(x, inverse)))
        _require(torch.equal(ntt_fr.ntt(ntt_fr.ntt(x), inverse=True), x)
                 and torch.equal(x, x0), f"fr_ntt round trip at 2^{bits}, "
                 "its input untouched")
        ntt_fr._plain_twiddles.cache_clear()
    for v in (0, 1, r - 1, r - 2, None):
        x = (words([0, 1, r - 1, r - 2]).repeat(1 << 10, 1) if v is None
             else words([v]).expand(1 << 12, 4).contiguous())
        for inverse in (False, True):
            err = max(err, _max_abs_err(ntt_fr.ntt(x, inverse),
                                        ntt_fr._ntt_plain(x, inverse)))
    for bits, inverse in ((20, True), (21, False), (21, True)):
        ntt_fr._kernel_twiddles.cache_clear()
        ntt_fr._host_twiddle_parts.cache_clear()
        t0 = time.perf_counter()
        table = ntt_fr._kernel_twiddles(bits, inverse, cuda)
        torch.cuda.synchronize()
        table_s[f"2^{bits}{' inverse' if inverse else ''}"] = \
            time.perf_counter() - t0
        if (bits, inverse) == (21, False):
            want = words(v * bn254_mont.MONT % r
                         for v in ntt_fr._powers(bits, inverse))
            _require(torch.equal(table, want), f"the 2^{bits} twiddle table "
                     "built on the card equals the host-built one")
            del want
            lo, hi = (words(p) for p in ntt_fr._host_twiddle_parts(
                bits, inverse))
            ref, plain_ms = _timed(torch, lambda: ntt_fr
                                   ._expand_twiddles_plain(lo, hi))
            tw_err = _max_abs_err(ntt_fr.expand_twiddles(lo, hi), ref)
            _require(tw_err == 0, "fr_ntt_twiddles equals its plain "
                     "version")
            ms = _cuda_ms(lambda: ntt_fr.expand_twiddles(lo, hi), 10)
            count = lo.shape[0] * hi.shape[0]
            tw_rows.append({
                "name": "fr_ntt_twiddles", "route": "cuda",
                "more_shapes": [],
                "source": "xlayer_prover_tpu_torch/csrc/fr_ntt.cu",
                "replaces": "xlayer_prover_tpu/snark/groth16.py:42",
                "max_abs_err": tw_err, "ms": ms, "plain_ms": plain_ms,
                "bytes": 32 * (count + lo.shape[0] + hi.shape[0]),
                "ops": count * FR_MUL, "shape": [count, 4],
                "plain_shape": [count, 4]})
            del lo, hi, ref
        del table
    print("fr_ntt: twiddle tables built cold (host parts and the card's "
          "expansion, host clock after a synchronise), s: "
          + json.dumps(table_s), flush=True)
    n = 1 << 21
    x = torch.randint(0, 1 << 62, (n, 4), dtype=torch.int64, device=cuda)
    x[:, 3] &= (1 << 60) - 1                   # below 2^252 < r
    half = x[:n // 2]
    shapes = []
    for vals, inverse in ((half, True), (x, False), (x, True)):
        ref, p_ms = _timed(torch, lambda: ntt_fr._ntt_plain(vals, inverse))
        err = max(err, _max_abs_err(ntt_fr.ntt(vals, inverse), ref))
        del ref
        before = ntt_fr.device_launches()
        ntt_fr.ntt(vals, inverse)
        device_launches = ntt_fr.device_launches() - before
        m = vals.shape[0]
        _require(device_launches == len(ntt_fr._passes(m.bit_length() - 1))
                 <= 3, f"fr_ntt at {m} makes one device launch a pass")
        k_ms = _cuda_ms(lambda: ntt_fr.ntt(vals, inverse), 5)
        bound, by = _bound_ms(ntt_work(m, inverse), int_rate)
        shapes.append({"shape": [m, 4], "inverse": inverse, "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                       "device_launches": device_launches})
        print(f"kernel fr_ntt {'inverse' if inverse else 'forward'} at "
              f"[{m}, 4]: {k_ms:.4f} ms (bound {bound:.4f} ms by {by}), "
              f"{device_launches} device launches a call", flush=True)
    _require(err == 0, "fr_ntt equals its plain version")
    main = shapes.pop(1)
    rows.append({
        "name": "fr_ntt", "route": "cuda",
        "more_shapes": shapes,
        "source": "xlayer_prover_tpu_torch/csrc/fr_ntt.cu",
        "replaces": "xlayer_prover_tpu/snark/groth16.py:42",
        "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        **ntt_work(n), "shape": [n, 4], "plain_shape": [n, 4]})
    rows += tw_rows
    y = torch.flip(x, [0]).contiguous()
    z = torch.roll(x, 1, 0).contiguous()
    err = _max_abs_err(ntt_fr.mul_sub(x, y, z),
                       ntt_fr._mul_sub_plain(x, y, z))
    edge = words([0, 1, r - 1, r - 2] * 4)
    err = max(err, _max_abs_err(ntt_fr.mul_sub(edge, edge.flip(0), edge),
                                ntt_fr._mul_sub_plain(edge, edge.flip(0),
                                                      edge)))
    _require(err == 0, "fr_mul_sub equals its plain version")
    ms = _cuda_ms(lambda: ntt_fr.mul_sub(x, y, z), 10)
    plain_ms = _cuda_ms(lambda: ntt_fr._mul_sub_plain(x, y, z), 1)
    rows.append({
        "name": "fr_mul_sub", "route": "cuda",
        "more_shapes": [],
        "source": "xlayer_prover_tpu_torch/csrc/fr_ntt.cu",
        "replaces": "xlayer_prover_tpu/snark/groth16.py:231",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **mul_sub_work(n), "shape": [n, 4], "plain_shape": [n, 4]})
    del x, y, z, half
    # the plain NTT's tables at 2^21 and 2^20 (~0.23 GB) would otherwise
    # stay on the card and count in the later phases' peak memory
    ntt_fr._plain_twiddles.cache_clear()
    ntt_fr._bitrev.cache_clear()
    ntt_fr._powers.cache_clear()
    torch.cuda.empty_cache()
    for row in rows:
        _bound(row, int_rate)
    return rows


def _bound_ms(work: dict, int_rate: float) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations") of a kernel's work: its bytes
    over the memory rate or its 32-bit multiplies over the multiply rate,
    whichever takes longer."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = work["ops"] / int_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _bound(r: dict, int_rate: float):
    """bound_ms and bound_by of a kernel row from its bytes and 32-bit
    multiplies, printed with its times."""
    r["bound_ms"], r["bound_by"] = _bound_ms(
        {"bytes": r.pop("bytes"), "ops": r.pop("ops")}, int_rate)
    r["library_ms"] = None
    print(f"kernel {r['name']} at {r['shape']}: {r['ms']:.4f} ms "
          f"(plain {r['plain_ms']:.3f} ms at {r['plain_shape']}, "
          f"bound {r['bound_ms']:.4f} ms "
          f"by {r['bound_by']}; int-mul rate {int_rate:.4g}/s)",
          flush=True)


def phase_fib(torch):
    from xlayer_prover_tpu_torch.models.toy import fib
    from xlayer_prover_tpu_torch.stark import prover, verifier

    air = fib.build_air(n_bits=5, n_queries=8)
    const_np, cm1_np, publics = fib.gen_trace(air)
    cpu = prover.gen_proof(prover.Setup.build(air, const_np, device="cpu"),
                           cm1_np, publics)
    setup = prover.Setup.build(air, const_np)
    gpu = prover.gen_proof(setup, cm1_np, publics)
    _require(setup.const_ext.is_cuda, "fib setup lives on the card")
    _require(gpu.to_json() == cpu.to_json(),
             "fib proof on the card is byte-equal to the CPU proof")
    _require(verifier.verify(air, setup.verkey, gpu), "fib proof verifies")
    print("fib: card proof byte-equal to CPU proof, verifies", flush=True)


def _refused(prover, verifier, setup, cm1, publics, what: str) -> str:
    """Prove a bad trace or claim; it must be refused by the prover or the
    verifier."""
    try:
        proof = prover.gen_proof(setup, cm1, publics)
    except prover.LookupMissingError:
        return "prover raised LookupMissingError"
    try:
        verifier.verify(setup.air, setup.verkey, proof)
    except verifier.VerifyError as e:
        return f"verifier raised VerifyError ({e})"
    raise RuntimeError(f"{what} was accepted")


def phase_binary(torch, case, trace_s: float):
    import numpy as np

    from xlayer_prover_tpu_torch import kernels
    from xlayer_prover_tpu_torch.stark import prover, verifier

    air, layout, const_np, cm1, actions, results = case
    _, a, b = actions[0]
    _require(results[0][0] == (a + b) & ((1 << 256) - 1),
             "binary trace: ADD result")
    print(f"binary: n_bits={air.n_bits} cm1={air.cm1_width} const="
          f"{air.const_width} cm2={air.cm2_width} cm3={air.cm3_width} "
          f"q_deg={air.q_deg} n_bits_ext={air.n_bits_ext} "
          f"ev_map={len(air.ev_map)} fri_steps={air.fri_steps} "
          f"actions={len(actions)} trace_s={trace_s:.3f}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    setup = prover.Setup.build(air, const_np)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timings = {}
    t0 = time.perf_counter()
    proof = prover.gen_proof(setup, cm1, [], timings=timings)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    _require(verifier.verify(air, setup.verkey, proof),
             "binary proof verifies")
    verify_s = time.perf_counter() - t0
    _require(len(proof.evals) == len(air.ev_map)
             and len(proof.fri_steps) == len(air.fri_steps)
             and len(proof.final_pol) == 1 << air.fri_steps[-1],
             "binary proof has the AIR's shape")

    bad = cm1.copy()
    row = 5 * layout.rows_per_op + 3
    bad[row, layout.witness["c_chunk"].index] ^= np.uint64(1)
    print("binary: tampered trace refused: "
          + _refused(prover, verifier, setup, bad, [],
                     "a tampered binary trace"), flush=True)
    report = {"n_bits": air.n_bits, "rows": air.n, "actions": len(actions),
              "trace_s": trace_s, "setup_s": setup_s, "prove_s": prove_s,
              "rounds_s": timings, "verify_s": verify_s,
              "rows_per_s": air.n / prove_s,
              "peak_bytes": peak, "launches": launches}
    print("phase4 " + json.dumps(report), flush=True)
    return launches


def check_shapes(torch, air, path: str) -> dict:
    """poseidon_linear_hash on the cm1 leaves of `air` and gl_mul on one
    stage of its cm1 LDE, each bit for bit against its plain version and
    timed; the leaves' digests against the plain version on their first
    SHAPE_PLAIN_ROWS rows (each row is hashed apart, and phase 2 holds
    the kernel on every row of 2^21).  -> {kernel: {"shape", "ms",
    "bound_ms"}}"""
    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.ops import poseidon_gl

    cuda = torch.device("cuda")
    width = air.cm1_width
    leaves = torch.randint(-(1 << 63), (1 << 63) - 1, (air.n_ext, width),
                           dtype=torch.int64, device=cuda)
    rows = min(air.n_ext, SHAPE_PLAIN_ROWS)
    err = _max_abs_err(poseidon_gl.linear_hash(leaves, width)[:rows],
                       poseidon_gl._linear_hash_plain(leaves[:rows], width))
    _require(err == 0, "poseidon_linear_hash equals its plain version at "
             f"the {path} cm1 leaves")
    ms = _cuda_ms(lambda: poseidon_gl.linear_hash(leaves, width), 5)
    del leaves
    m = (air.n_ext // 2) * width
    ta = torch.randint(-(1 << 63), (1 << 63) - 1, (m,), dtype=torch.int64,
                       device=cuda)
    tb = torch.randint(-(1 << 63), (1 << 63) - 1, (m,), dtype=torch.int64,
                       device=cuda)
    err = _max_abs_err(gl.gl_mul(ta, tb), gl._mul_plain(ta, tb))
    _require(err == 0, f"gl_mul equals its plain version at the {path} LDE "
             "stage")
    mul_ms = _cuda_ms(lambda: gl.gl_mul(ta, tb), 20)
    del ta, tb
    torch.cuda.empty_cache()
    # the least times, as in phase_kernels: the larger of the bytes over
    # the memory rate and the 32-bit multiplies over the integer rate
    perms = -(-width // 8) * air.n_ext
    hash_bound = max(poseidon_mul32() * perms / int_mul_rate(torch),
                     (width + 4) * 8 * air.n_ext / HBM_BYTES_PER_S) * 1e3
    mul_bound = max(24 * m / HBM_BYTES_PER_S,
                    GL_MUL_MULS * m / int_mul_rate(torch)) * 1e3
    print(f"kernel poseidon_linear_hash at [{air.n_ext}, {width}] ({path} "
          f"cm1 leaves): {ms:.4f} ms (bound {hash_bound:.4f} ms), bit-equal;"
          f" gl_mul at [{m}] ({path} LDE stage): {mul_ms:.4f} ms (bound "
          f"{mul_bound:.4f} ms), bit-equal", flush=True)
    return {"poseidon_linear_hash": {"shape": [air.n_ext, width], "ms": ms,
                                     "bound_ms": hash_bound},
            "gl_mul": {"shape": [m], "ms": mul_ms, "bound_ms": mul_bound}}


def phase_zkevm(torch):
    """The mini-ROM's composite at n_bits 13 against the JAX package's
    proof; launches counted from 0."""
    from xlayer_prover_tpu_torch import kernels
    from xlayer_prover_tpu_torch.models.zkevm import mini_rom
    from xlayer_prover_tpu_torch.stark import prover, verifier

    t0 = time.perf_counter()
    ex, res = mini_rom.execute(13)
    trace_s = time.perf_counter() - t0
    air, ctx = ex.air, res.ctx
    _require(ctx.done and ctx.counters.steps == 24
             and (ctx.counters.binary, ctx.counters.arith) == (3, 1),
             "mini-ROM execution: 24 steps, 3 binary ops, 1 arith")
    print(f"zkevm: n_bits={air.n_bits} cm1={air.cm1_width} const="
          f"{air.const_width} cm2={air.cm2_width} cm3={air.cm3_width} "
          f"q_deg={air.q_deg} plookups={len(air.plookups)} permutations="
          f"{len(air.permutations)} constraints={len(air.constraints)} "
          f"ev_map={len(air.ev_map)} fri_steps={air.fri_steps}", flush=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    setup = prover.Setup.build(air, res.const_np)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timings = {}
    t0 = time.perf_counter()
    proof = prover.gen_proof(setup, res.cm1_np, res.publics, timings=timings)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    with open(ZKEVM_FIXTURE) as f:
        _require(proof.to_json() == f.read(),
                 "the n_bits 13 zkEVM proof on the card is byte-equal to "
                 "the JAX package's")
    _require(verifier.verify(air, setup.verkey, proof),
             "the n_bits 13 zkEVM proof verifies")
    print(f"zkevm n_bits=13: byte-equal to "
          f"{os.path.relpath(ZKEVM_FIXTURE, REPO)}, verifies", flush=True)
    report = {"n_bits": air.n_bits, "rows": air.n, "trace_s": trace_s,
              "setup_s": setup_s, "prove_s": prove_s, "rounds_s": timings,
              "launches": launches}
    print("zkevm " + json.dumps(report), flush=True)
    return launches


def _byte_equal_to_a7(cas, name: str):
    """The cascade's stage file `name` is byte-equal to its
    a7_state_devnet/ file."""
    import filecmp
    _require(filecmp.cmp(cas.path(name), os.path.join(A7, f"{name}_nb16_q4"
                                                       ".json"),
                         shallow=False),
             f"the {name} proof on the card is byte-equal to "
             f"a7_state_devnet/{name}_nb16_q4.json")


def _stage_launches(record: dict, stages) -> dict:
    """The launches by kernel of `stages`, summed from the record."""
    out: dict = {}
    for stage in stages:
        for k, v in record["launches"].get(stage, {}).items():
            out[k] = out.get(k, 0) + v
    return out


def phase_cascade(torch):
    """The devnet cascade, the main path of this slice
    (``cascade.DevnetCascade`` in a fresh state directory under build/),
    launches counted from 0 over the whole run; the shape of every
    Poseidon-BN254 launch recorded around the wrappers; the stages of
    ``CASCADE_READ_BACK`` copied from a7_state_devnet/ first, so the
    cascade reads them back.  Every other stage must have been proven
    here (none resumed) and each batch, recursion and final stage must
    have launched its kernels.  -> (launches, cascade, Poseidon-BN254 calls by
    shape, report)"""
    import collections
    import shutil

    from xlayer_prover_tpu_torch import cascade, device, kernels
    from xlayer_prover_tpu_torch.ops import ntt_fr
    from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn

    shutil.rmtree(CASCADE_DIR, ignore_errors=True)
    os.makedirs(CASCADE_DIR)
    for name in CASCADE_READ_BACK:
        shutil.copyfile(os.path.join(A7, f"{name}_nb16_q4.json"),
                        os.path.join(CASCADE_DIR, f"{name}_nb16_q4.json"))
    read_back = set(CASCADE_READ_BACK)
    calls = collections.Counter()
    wrapped = {name: getattr(pbn, name) for name in ("permute", "leaf_hash")}

    def recorder(name):
        def call(x, *args):
            if x.device.type == "cuda" and x.shape[0] > 0:
                calls[(name, tuple(x.shape))] += 1
            return wrapped[name](x, *args)
        return call

    # the final stage builds its own Fr NTT twiddle tables, as an
    # operator's first proof does (fr_ntt_twiddles, inside g16_h_ntt_s)
    ntt_fr._kernel_twiddles.cache_clear()
    ntt_fr._host_twiddle_parts.cache_clear()
    cas = cascade.DevnetCascade(state_dir=CASCADE_DIR, out=CASCADE_OUT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    for name in wrapped:
        setattr(pbn, name, recorder(name))
    try:
        t0 = time.perf_counter()
        record = cas.run()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    finally:
        for name, fn in wrapped.items():
            setattr(pbn, name, fn)
    launches = dict(kernels.LAUNCHES)
    _require(cas.stack.final_circuit is not None,
             "the final stage kept its R1CS and witness")
    _require(record["status"] == "complete" and record["verified"],
             "the cascade completed and its Groth16 proof verified")
    _require(all(isinstance(v, float) == (k not in read_back)
                 for k, v in record["stages"].items()),
             "every cascade stage but the batch proofs read back was proven "
             "in this run")
    for name in wrapped:
        _require(sum(v for (k, _), v in calls.items() if k == name)
                 == launches[f"poseidon_bn254_{name}"],
                 f"every poseidon_bn254_{name} launch of the cascade has its "
                 "shape recorded")
    for group, stages in cascade_groups().items():
        for stage in stages:
            for name in STAGE_KERNELS[group]:
                _require(record["launches"][stage].get(name, 0) > 0,
                         f"{name} launched in the cascade's {stage} stage")
    batches = cascade_groups().get("cascade_batches", [])
    if batches:
        air = cas.engine.air
        _require(max(record["peak_bytes"][s] for s in batches)
                 > air.n_ext * air.cm1_width * 8,
                 "the peak device memory read after a request covers the "
                 "worker's allocations (above the cm1 LDE's bytes)")
    report = {"card": device.smi("name,power.limit"), "total_s": total_s,
              "inputs_s": record.get("inputs_s"), "stages_s": record["stages"],
              "batches": {s: record["timings"][s] for s in batches},
              "pair_s": record["pair_s"],
              "peak_bytes": record["peak_bytes"],
              "peak_bytes_max": max(record["peak_bytes"].values()),
              "launches": record["launches"]}
    print(f"cascade: {len(record['stages'])} stages in {total_s:.3f} s, "
          f"record {os.path.relpath(CASCADE_OUT, REPO)}", flush=True)
    return launches, cas, calls, report


def cascade_groups() -> dict:
    """The cascade's stages proven in this run, by the part of the path
    they drive (the stages read back are in none; a part with no stage
    is left out)."""
    from xlayer_prover_tpu_torch import cascade
    groups = {"cascade_batches": [cascade.batch_stage(k)
                                  for k in range(cascade.N_BATCHES)],
              "cascade_recursion": RECURSION_STAGES,
              "cascade_final": ["finalize_groth16"]}
    return {k: [s for s in v if s not in CASCADE_READ_BACK]
            for k, v in groups.items()
            if any(s not in CASCADE_READ_BACK for s in v)}


def phase_batches(torch, cas):
    """Phase 6: the cascade's four batch proofs byte-equal to
    a7_state_devnet/ and verified, the state roots chained, the batch
    publics head equal to the JAX record's; batch 0's trace executed again
    for two refusals (a forged sRD value, a wrong new-state-root public);
    the kernels held at the devnet shapes."""
    import numpy as np

    from xlayer_prover_tpu_torch import cascade, device
    from xlayer_prover_tpu_torch.stark import prover, verifier

    engine = cas.engine
    air, layout = engine.air, engine.executor.layout
    setup = engine.setup()
    _require(setup.const_ext.is_cuda, "the devnet setup lives on the card")
    verify_s, proofs = {}, []
    for k in range(cascade.N_BATCHES):
        name = cascade.batch_stage(k)
        _byte_equal_to_a7(cas, name)
        proof = cas.outputs[name]
        t0 = time.perf_counter()
        _require(verifier.verify(air, setup.verkey, proof),
                 f"the {name} proof verifies")
        verify_s[name] = time.perf_counter() - t0
        proofs.append(proof)
    for k in range(cascade.N_BATCHES - 1):
        _require(proofs[k].publics[NEW_STATE_ROOT:NEW_STATE_ROOT + 8]
                 == proofs[k + 1].publics[:8],
                 f"batch {k}'s newStateRoot is batch {k + 1}'s "
                 "oldStateRoot")
    with open(CASCADE_RECORD) as f:
        want_head = json.load(f)["batch_publics_head"]
    _require(cas.record["batch_publics_head"] == want_head,
             "the batch publics head equals PROOF_a7_cascade_devnet.json's")
    print("devnet: batch proofs 0-3 byte-equal to a7_state_devnet/, "
          "verified, state roots chained", flush=True)

    t0 = time.perf_counter()
    res = engine.execute_only(cas.inputs()[0])
    trace_s = time.perf_counter() - t0
    ctx = res.ctx
    _require(ctx.done and ctx.counters.steps == 6589
             and len(ctx.required.storage) > 0 and ctx.ec_memo_hits > 0,
             "devnet batch 0: 6,589 steps, storage actions, the ECRecover "
             "precalc served")
    _require([int(p) % prover.P for p in res.publics] == proofs[0].publics,
             "batch 0 executed again gives the served proof's publics")
    print(f"devnet: n_bits={air.n_bits} cm1={air.cm1_width} const="
          f"{air.const_width} cm2={air.cm2_width} cm3={air.cm3_width} "
          f"q_deg={air.q_deg} plookups={len(air.plookups)} permutations="
          f"{len(air.permutations)} constraints={len(air.constraints)} "
          f"ev_map={len(air.ev_map)} fri_steps={air.fri_steps} steps="
          f"{ctx.counters.steps} storage_actions={len(ctx.required.storage)}"
          f" trace_s={trace_s:.3f}", flush=True)
    # an sRD returning a forged value (FREE and op moved together, so the
    # op accumulator still holds): only the Storage latchGet lookup sees it
    mw = layout.main.witness
    bad = res.cm1_np.copy()
    row = int(np.nonzero(bad[:, mw["sRD"].index])[0][0])
    for name in ("op0", "FREE0"):
        col = mw[name].index
        bad[row, col] = (int(bad[row, col]) + 1) % prover.P
    print(f"devnet: forged sRD value at row {row} refused: "
          + _refused(prover, verifier, setup, bad, res.publics,
                     "a forged sRD value"), flush=True)
    wrong = list(res.publics)
    wrong[NEW_STATE_ROOT] = (wrong[NEW_STATE_ROOT] + 1) % prover.P
    print("devnet: wrong new-state-root public refused: "
          + _refused(prover, verifier, setup, res.cm1_np, wrong,
                     "a wrong new state root"), flush=True)
    check_shapes(torch, air, "devnet")
    print(device.smi("name,power.limit"), flush=True)
    report = {"n_bits": air.n_bits, "rows": air.n, "trace_s": trace_s,
              "verify_s": verify_s}
    print("devnet " + json.dumps(report), flush=True)


def phase_recursion(torch, cas):
    """Phase 7: the cascade's lifts and aggregations proven in this run
    byte-equal to a7_state_devnet/, and all seven verified (those read
    back too); three refusals; the kernels held at the recursive1
    shapes.  -> the shapes' rows"""
    from xlayer_prover_tpu_torch import device
    from xlayer_prover_tpu_torch.recursion import gate_air
    from xlayer_prover_tpu_torch.recursion.stack import RecursiveProof
    from xlayer_prover_tpu_torch.stark import verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof

    stack = cas.stack
    rec1, rec2 = stack.rec1(), stack.rec2()
    for name, eng in (("rec1", rec1), ("rec2", rec2)):
        g = eng.air
        print(f"recursion {name}: n_bits={g.n_bits} cm1={g.cm1_width} "
              f"cm3={g.cm3_width} const={g.const_width} publics="
              f"{g.n_publics} constraints={len(g.constraints)} ev_map="
              f"{len(g.ev_map)} fri_steps={g.fri_steps} rows_used="
              f"{eng.layout.n_rows_used} {eng.tracer.stats()}", flush=True)
    proven = cascade_groups()["cascade_recursion"]
    verify_s = {}
    for name in RECURSION_STAGES:
        if name in proven:
            _byte_equal_to_a7(cas, name)
        t0 = time.perf_counter()
        _require(stack.verify(cas.outputs[name]), f"the {name} proof "
                 "verifies")
        verify_s[name] = time.perf_counter() - t0
    print(f"recursion: {', '.join(proven)} proven from the port's own "
          "proofs byte-equal to a7_state_devnet/; all seven verified "
          f"({', '.join(s for s in RECURSION_STAGES if s not in proven)} "
          "read back)", flush=True)
    root = cas.outputs["aggregate_root"]
    _require(stack.finalize(root, wrap="stark") is root,
             "finalize(wrap='stark') accepts the root")
    _require(root.proof.publics[:4] == rec2.verkey,
             "the root carries the recursive2 verkey")

    def refused_at_witness(fn, what: str) -> str:
        try:
            fn()
        except ValueError as e:
            return f"ValueError ({e})"
        raise RuntimeError(f"{what} was accepted")

    bad = StarkProof.from_json(cas.outputs["batch_proof_0vdev0"].to_json())
    bad.roots[0][0] = (bad.roots[0][0] + 1) % gate_air.P
    print("recursion: batch proof with a root limb moved refused: "
          + refused_at_witness(lambda: stack.lift(bad),
                               "a batch proof with a moved root limb"),
          flush=True)
    print("recursion: recursive1_1 + recursive1_0 (link broken) refused: "
          + refused_at_witness(lambda: stack.aggregate(
              cas.outputs["recursive1_1"], cas.outputs["recursive1_0"]),
              "an aggregation in the wrong order"), flush=True)
    forged = RecursiveProof.from_json(root.to_json())
    forged.proof.publics[4 + NEW_STATE_ROOT] = \
        (forged.proof.publics[4 + NEW_STATE_ROOT] + 1) % gate_air.P
    try:
        accepted = stack.verify(forged)
    except verifier.VerifyError as e:
        print(f"recursion: root with a payload public changed refused: "
              f"VerifyError ({e})", flush=True)
    else:
        _require(not accepted, "a root with a changed payload public is "
                 "refused")
        print("recursion: root with a payload public changed refused",
              flush=True)

    shapes = check_shapes(torch, rec1.air, "recursive1")
    print(device.smi("name,power.limit"), flush=True)
    report = {"n_bits": rec1.air.n_bits, "pair_s": stack.timings,
              "proofs_s": {s: cas.record["stages"][s] for s in proven},
              "rounds_s": {s: cas.record["timings"].get(s) for s in proven},
              "verify_s": verify_s,
              "tracer_stats": {"rec1": rec1.tracer.stats(),
                               "rec2": rec2.tracer.stats()}}
    print("recursion " + json.dumps(report), flush=True)
    return shapes


def check_bn254_shapes(torch, air, calls: dict) -> dict:
    """poseidon_bn254_leaf_hash on the leaves of `air`'s cm1, cm3, const
    and cm4 columns and poseidon_bn254_permute on its first tree level,
    each bit for bit against its plain version and timed; then every
    shape the final stage launched them at (`calls`: (kernel, shape) ->
    launches) timed, and the two kernels' time in the stage summed from
    them.  -> {kernel: {"shape", "ms", "bound_ms"}, "by_shape": [...]}"""
    from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn

    cuda = torch.device("cuda")
    rate = int_mul_rate(torch)
    n, width = air.n_ext, air.cm1_width

    def rand(shape):
        return torch.randint(-(1 << 63), (1 << 63) - 1, shape,
                             dtype=torch.int64, device=cuda)

    leaf_ms = {}
    for w in dict.fromkeys((width, air.cm3_width, air.const_width,
                            air.cm4_width)):
        leaves = rand((n, w))
        _require(_max_abs_err(pbn.leaf_hash(leaves, w),
                              pbn._leaf_hash_plain(leaves, w)) == 0,
                 f"poseidon_bn254_leaf_hash equals its plain version at "
                 f"the RecursiveF leaves of width {w}")
        leaf_ms[w] = _cuda_ms(lambda: pbn.leaf_hash(leaves, w), 3)
        bound, _ = _bound_ms(bn254_leaf_work(n, w), rate)
        print(f"kernel poseidon_bn254_leaf_hash at [{n}, {w}]: "
              f"{leaf_ms[w]:.4f} ms (bound {bound:.4f} ms), bit-equal",
              flush=True)
        del leaves
    leaf_bound, _ = _bound_ms(bn254_leaf_work(n, width), rate)
    groups = n // 16
    level = torch.randint(-(1 << 63), (1 << 63) - 1, (groups, 17, 4),
                          dtype=torch.int64, device=cuda)
    _require(_max_abs_err(pbn.permute(level, 17),
                          pbn._permute_plain(level, 17)) == 0,
             "poseidon_bn254_permute equals its plain version at the "
             "RecursiveF first tree level")
    perm_ms = _cuda_ms(lambda: pbn.permute(level, 17), 5)
    perm_bound, _ = _bound_ms(bn254_permute_work(groups), rate)
    del level
    print(f"kernel poseidon_bn254_leaf_hash at [{n}, {width}] (RecursiveF "
          f"cm1 leaves): {leaf_ms[width]:.4f} ms (bound {leaf_bound:.4f} "
          f"ms), bit-equal; poseidon_bn254_permute at [{groups}, 17, 4] "
          f"(its first tree level): {perm_ms:.4f} ms (bound "
          f"{perm_bound:.4f} ms), bit-equal", flush=True)
    by_shape, total = [], 0.0
    for (kernel, shape), launches in sorted(calls.items()):
        x = rand(shape)
        if kernel == "permute":
            ms = _cuda_ms(lambda: pbn.permute(x, shape[1]), 5)
            work = {"bytes": 2 * 32 * shape[1] * shape[0],
                    "ops": bn254_mul32(shape[1]) * shape[0]}
        else:
            ms = _cuda_ms(lambda: pbn.leaf_hash(x, shape[1]), 3)
            work = bn254_leaf_work(*shape)
        del x
        by_shape.append({"kernel": f"poseidon_bn254_{kernel}",
                         "shape": list(shape), "launches": launches,
                         "ms": ms, "bound_ms": _bound_ms(work, rate)[0]})
        total += launches * ms
    torch.cuda.empty_cache()
    print("final: Poseidon-BN254 launches by shape (ms a launch, timed "
          "again after the stage): " + json.dumps(by_shape), flush=True)
    print(f"final: Poseidon-BN254 kernel time in the stage, summed by "
          f"shape: {total:.3f} ms", flush=True)
    return {"poseidon_bn254_leaf_hash": {"shape": [n, width],
                                         "ms": leaf_ms[width],
                                         "bound_ms": leaf_bound},
            "poseidon_bn254_permute": {"shape": [groups, 17, 4],
                                       "ms": perm_ms,
                                       "bound_ms": perm_bound},
            "by_shape": by_shape, "by_shape_total_ms": total}


def phase_final(torch, cas, calls):
    """Phase 8: the cascade's finalize(root, wrap="groth16", snark=True,
    rng=random.Random(11)): RecursiveF byte-equal to the JAX package's and
    verified, two refusals; the Groth16 proof's snarkjs files byte-equal to
    the JAX package's, accepted from the files alone, a changed public
    refused; the Poseidon-BN254 kernels held at the stage's shapes and
    each recorded shape timed again.  -> the shapes' rows"""
    import filecmp

    from xlayer_prover_tpu_torch import device
    from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn
    from xlayer_prover_tpu_torch.snark import snarkjs_io
    from xlayer_prover_tpu_torch.stark import verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof

    with open(RECF_FIXTURE) as f:
        fixture = f.read()
    with open(CASCADE_RECORD) as f:
        want = [int(v) for v in json.load(f)["groth16_publics"]]
    stack, root = cas.stack, cas.outputs["aggregate_root"]
    out = cas.outputs["finalize_groth16"]
    timings = cas.record["timings"]["finalize_groth16"]
    launches = cas.record["launches"]["finalize_groth16"]
    recf = stack._aux[("recF", root.level)]
    pk, _vk = stack._aux[("g16", root.level)]
    key_bytes = sum(getattr(pk, q).numel() * 8 for q in (
        "a_query", "b1_query", "b2_query", "c_query", "h_query"))
    g = recf.air
    print(f"final RecursiveF: scheme={g.scheme} n_bits={g.n_bits} "
          f"n_bits_ext={g.n_bits_ext} cm1={g.cm1_width} cm2={g.cm2_width} "
          f"cm3={g.cm3_width} cm4={g.cm4_width} const={g.const_width} "
          f"publics={g.n_publics} constraints={len(g.constraints)} ev_map="
          f"{len(g.ev_map)} fri_steps={g.fri_steps} rows_used="
          f"{recf.layout.n_rows_used} {recf.tracer.stats()}", flush=True)
    proof = out["recf_proof"]
    _require(proof.to_json() == fixture,
             "the RecursiveF proof on the card is byte-equal to the JAX "
             "package's (tests/data/recF_devnet_root_q4.proof.json)")
    t0 = time.perf_counter()
    _require(recf.verify(proof), "the RecursiveF proof verifies")
    verify_s = time.perf_counter() - t0
    print("final: RecursiveF proof byte-equal to "
          f"{os.path.relpath(RECF_FIXTURE, REPO)}, verifies "
          f"({verify_s:.3f} s)", flush=True)

    def refused(bad, what: str) -> str:
        try:
            accepted = recf.verify(bad)
        except verifier.VerifyError as e:
            return f"VerifyError ({e})"
        _require(not accepted, f"{what} is refused")
        return "refused"

    bad = StarkProof.from_json(proof.to_json())
    bad.roots[0][0] = (bad.roots[0][0] + 1) % pbn.P
    print("final: RecursiveF proof with its cm1 root moved refused: "
          + refused(bad, "a moved Fr root"), flush=True)
    bad = StarkProof.from_json(proof.to_json())
    bad.publics[4 + NEW_STATE_ROOT] = \
        (bad.publics[4 + NEW_STATE_ROOT] + 1) % (2 ** 64 - 2 ** 32 + 1)
    print("final: RecursiveF proof with a payload public changed refused: "
          + refused(bad, "a changed public"), flush=True)

    _require(out["final"] == "groth16" and out["publics"] == want,
             "the Groth16 publics equal the 52 groth16_publics of "
             "PROOF_a7_cascade_devnet.json")
    _require(cas.record["groth16_publics"] == [str(p) for p in want],
             "the cascade record's groth16_publics equal the JAX record's")
    os.makedirs(G16_OUT, exist_ok=True)
    vk_path, proof_path, pub_path = (os.path.join(G16_OUT, f)
                                     for f in SNARKJS_FILES)
    snarkjs_io.export_vk(out["vk"], vk_path)
    snarkjs_io.export_proof(out["proof"], proof_path)
    snarkjs_io.export_publics(out["publics"], pub_path)
    for name in SNARKJS_FILES:
        _require(filecmp.cmp(os.path.join(G16_OUT, name),
                             os.path.join(G16_FIXTURE, name), shallow=False),
                 f"the Groth16 {name} on the card is byte-equal to the JAX "
                 f"package's ({os.path.relpath(G16_FIXTURE, REPO)})")
    t0 = time.perf_counter()
    _require(snarkjs_io.verify_files(vk_path, pub_path, proof_path),
             "the Groth16 proof verifies from its snarkjs files")
    files_verify_s = time.perf_counter() - t0
    bad_pub = os.path.join(G16_OUT, "public_changed.json")
    changed = list(out["publics"])
    changed[4 + NEW_STATE_ROOT] += 1
    snarkjs_io.export_publics(changed, bad_pub)
    _require(not snarkjs_io.verify_files(vk_path, bad_pub, proof_path),
             "the Groth16 proof with a changed public is refused")
    print(f"final: Groth16 over the R1CS (n_public={len(want)}): "
          f"verification_key.json, proof.json and public.json byte-equal to "
          f"{os.path.relpath(G16_FIXTURE, REPO)}, accepted from the files "
          f"({files_verify_s:.3f} s), a changed public refused", flush=True)
    print(f"final: Groth16's five MSMs {timings['g16_msm_s']:.4f} s "
          f"(g16_msm_s: four over G1, one over G2, host clock after a "
          f"synchronise)", flush=True)
    print(f"final: Groth16's h {timings['g16_h_s']:.4f} s = the host's "
          f"per-constraint evaluations {timings['g16_h_eval_s']:.4f} s "
          f"(g16_h_eval_s) + tables, {launches['fr_ntt']} fr_ntt and "
          f"{launches['fr_mul_sub']} fr_mul_sub {timings['g16_h_ntt_s']:.4f}"
          f" s (g16_h_ntt_s, after a synchronise)", flush=True)
    shapes = check_bn254_shapes(torch, g, calls)
    print(device.smi("name,power.limit"), flush=True)
    report = {"n_bits": g.n_bits,
              "total_s": cas.record["stages"]["finalize_groth16"],
              "timings_s": timings, "verify_s": verify_s,
              "files_verify_s": files_verify_s, "g16_key_bytes": key_bytes,
              "peak_bytes": cas.record["peak_bytes"]["finalize_groth16"],
              "launches": launches,
              "poseidon_bn254_ms_by_shape": shapes.pop("by_shape"),
              "poseidon_bn254_ms": shapes.pop("by_shape_total_ms")}
    print("final " + json.dumps(report), flush=True)
    with open(BN254_SHAPES, "w") as f:
        json.dump(report["poseidon_bn254_ms_by_shape"], f)
    return shapes


def phase_service(torch):
    """Phase 9: the request path on the fib toy (n_bits 4, 2 queries):
    ``ProverService({"batch": (air, setup)}, recursion_queries=4)`` serves
    two GEN_BATCH_PROOFs, a GEN_AGGREGATED_PROOF over them byte-equal to
    the JAX service's (tests/data/svc_agg_fib_q4.proof.json), a
    GEN_FINAL_PROOF (the default wrap, "stark") returning the verified
    root, and a GEN_BATCH_PROOF cancelled while running, after which the
    next request completes.  Launches counted from 0 over the phase."""
    from xlayer_prover_tpu_torch import kernels
    from xlayer_prover_tpu_torch.models.toy import fib
    from xlayer_prover_tpu_torch.prover_service import (ProverRequest,
                                                         ProverService,
                                                         RequestState,
                                                         RequestType)
    from xlayer_prover_tpu_torch.stark import prover

    air = fib.build_air(n_bits=4, n_queries=2)
    traces = [fib.gen_trace(air, a0=a0, b0=b0, seed=seed)
              for a0, b0, seed in FIB_SVC_TRACES]
    with open(SVC_AGG_FIXTURE) as f:
        fixture = f.read()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_all = time.perf_counter()
    setup = prover.Setup.build(air, traces[0][0])
    svc = ProverService({"batch": (air, setup)}, recursion_queries=4)
    times = {}

    def serve(name, req_type, payload):
        req = ProverRequest(req_type, payload)
        t0 = time.perf_counter()
        svc.submit(req)
        svc.wait(req.uuid, timeout=600)
        times[name] = time.perf_counter() - t0
        if req.state != RequestState.COMPLETED:
            raise RuntimeError(f"service: {name} ended {req.state.value}: "
                               f"{req.error}")
        return req

    try:
        proofs = [serve(f"batch_{i}", RequestType.GEN_BATCH_PROOF,
                        {"cm1": cm1, "publics": publics}).proof
                  for i, (_c, cm1, publics) in enumerate(traces)]
        agg = serve("aggregate", RequestType.GEN_AGGREGATED_PROOF,
                    {"proof1": proofs[0], "proof2": proofs[1]})
        _require(json.dumps(agg.proof.to_json()) == fixture,
                 "the GEN_AGGREGATED_PROOF on the card is byte-equal to the "
                 "JAX service's (tests/data/svc_agg_fib_q4.proof.json)")
        final = serve("final", RequestType.GEN_FINAL_PROOF,
                      {"proof": agg.proof})
        _require(final.proof == {"final": agg.proof},
                 "GEN_FINAL_PROOF (wrap 'stark') returns the verified root")
        print("service: fib GEN_BATCH_PROOF x2, GEN_AGGREGATED_PROOF "
              "byte-equal to tests/data/svc_agg_fib_q4.proof.json, "
              "GEN_FINAL_PROOF verified", flush=True)

        # a request cancelled while it runs: the card is kept busy ahead
        # of the proof, so the worker waits at its first pull to the host,
        # inside round 1, while the client cancels; the proof stops at the
        # next round boundary
        torch.cuda._sleep(int(4e9))
        req = ProverRequest(RequestType.GEN_BATCH_PROOF,
                            {"cm1": traces[0][1], "publics": traces[0][2]})
        svc.submit(req)
        deadline = time.monotonic() + 60
        while req.state == RequestState.PENDING \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        _require(req.state == RequestState.RUNNING and svc.cancel(req.uuid),
                 "a running GEN_BATCH_PROOF is cancelled")
        svc.wait(req.uuid, timeout=600)
        _require(req.state == RequestState.CANCELLED
                 and req.result.name == "CANCELLED" and req.proof is None,
                 f"the cancelled request ends CANCELLED ({req.state.value}: "
                 f"{req.error})")
        serve("after_cancel", RequestType.GEN_BATCH_PROOF,
              {"cm1": traces[1][1], "publics": traces[1][2]})
        print("service: a running GEN_BATCH_PROOF cancelled at a round "
              "boundary, the next request completed", flush=True)
    finally:
        svc.shutdown()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    rec = svc._rstack["batch"]
    report = {"total_s": time.perf_counter() - t_all, "requests_s": times,
              "n_bits": rec.rec1().air.n_bits, "pair_s": rec.timings,
              "launches": launches}
    print("service " + json.dumps(report), flush=True)
    return launches


def _tampered(verifier, air, verkey, proof, what: str) -> str:
    """`proof` changed by the caller must be refused by the verifier."""
    try:
        ok = verifier.verify(air, verkey, proof)
    except verifier.VerifyError as e:
        return f"verifier raised VerifyError ({e})"
    _require(not ok, f"{what} is refused")
    return "verifier returned False"


def phase_chains(torch):
    """Phase 10: devnet batch 0 at 2^18 rows with the Keccak-F and
    SHA-256-F chains bound (``utils/devnet.DEVNET_CHAINS_GEOMETRY``), one
    GEN_BATCH_PROOF request to ``ProverService(batch_prover=...)``;
    launches counted from 0 and the peak device memory reset before the
    setup.  Held against the JAX fixture: the AIR's widths and plookups,
    each cm1 and const column's digest, the publics, the verkey and,
    where it was made, the proof byte for byte; the proof verifies, and
    with one evaluation or one public changed it is refused.  The port's
    gates.execute on the card over the Keccak slot's 48 states equals
    execute_all_wires_np.  -> (launches, what phase 12 (b) proves
    again)"""
    import numpy as np

    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.models.zkevm import (gates,
                                                      keccak_chain_sm,
                                                      keccak_gates)
    from xlayer_prover_tpu_torch.prover_service import (ProverRequest,
                                                         ProverService,
                                                         RequestState,
                                                         RequestType)
    from xlayer_prover_tpu_torch.stark import verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof
    from xlayer_prover_tpu_torch.utils import devnet

    with open(CHAINS_FIXTURE) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    engine = devnet.devnet_prover(geometry=devnet.DEVNET_CHAINS_GEOMETRY)
    build_s = time.perf_counter() - t0
    air, layout = engine.air, engine.executor.layout
    _require([air.cm1_width, air.cm2_width, air.cm3_width,
              air.const_width] == want["widths"] == [669, 600, 999, 361]
             and len(air.plookups) == want["n_plookups"] == 100,
             "the 2^18 AIR's widths and plookups equal the JAX fixture's")
    for name in ("keccak", "sha"):
        chain = getattr(layout, name)
        _require((chain.n_slots, chain.n_instances) == (1, 48),
                 f"the {name} chain has 1 gate slot of 48 instances")
    inp = devnet.build_devnet_inputs(engine, 1)[0]
    # the request's execution, kept for the trace checks
    executed = []
    execute_only = engine.execute_only

    def recorded(*args, **kw):
        executed.append(execute_only(*args, **kw))
        return executed[-1]

    engine.execute_only = recorded
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    setup = engine.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    svc = ProverService(batch_prover=engine)
    try:
        req = ProverRequest(RequestType.GEN_BATCH_PROOF, {"input": inp})
        t0 = time.perf_counter()
        svc.submit(req)
        svc.wait(req.uuid, timeout=1200)
        request_s = time.perf_counter() - t0
    finally:
        svc.shutdown()
        engine.execute_only = execute_only
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if req.state != RequestState.COMPLETED:
        raise RuntimeError(f"chains: GEN_BATCH_PROOF ended "
                           f"{req.state.value}: {req.error}")
    proof, res = req.proof, executed[0]
    print(f"chains: n_bits={air.n_bits} cm1={air.cm1_width} const="
          f"{air.const_width} cm2={air.cm2_width} cm3={air.cm3_width} "
          f"q_deg={air.q_deg} plookups={len(air.plookups)} permutations="
          f"{len(air.permutations)} connections={len(air.connections)} "
          f"constraints={len(air.constraints)} ev_map={len(air.ev_map)} "
          f"fri_steps={air.fri_steps} steps={res.ctx.counters.steps} "
          f"hashK={len(res.ctx.required.padding_kk)} "
          f"hashS={len(res.ctx.required.padding_sha)}", flush=True)

    t0 = time.perf_counter()
    _require(res.ctx.counters.steps == want["executor_steps"],
             "the executor's steps equal the JAX fixture's")
    _require(column_digests(res.cm1_np) == want["cm1"],
             "every cm1 column's digest equals the JAX execution's")
    _require(column_digests(res.const_np) == want["const"],
             "every const column's digest equals the JAX fill_fixed's")
    _require([int(p) for p in res.publics] == want["publics"]
             and proof.publics == [p % gl.P for p in want["publics"]],
             "the publics equal the JAX fixture's")
    _require([int(v) for v in setup.verkey] == want["verkey"],
             "the verkey (const tree root) equals the JAX Setup's")
    digest_s = time.perf_counter() - t0
    if os.path.exists(CHAINS_PROOF):
        with open(CHAINS_PROOF) as f:
            _require(proof.to_json() == f.read(),
                     "the 2^18 chains proof on the card is byte-equal to the "
                     "JAX package's")
        held = f"byte-equal to {os.path.relpath(CHAINS_PROOF, REPO)}"
    else:
        held = "no JAX proof fixture: held by digests, publics and verkey"
    # the service verified the proof before it completed the request
    # (verifier.verify raises VerifyError on a proof that fails)
    bad = StarkProof.from_json(proof.to_json())
    bad.evals[0][0] = (int(bad.evals[0][0]) + 1) % gl.P
    print("chains: a tampered evaluation refused: "
          + _tampered(verifier, air, setup.verkey, bad, "a tampered "
                      "evaluation"), flush=True)
    bad = StarkProof.from_json(proof.to_json())
    bad.publics[NEW_STATE_ROOT] = (int(bad.publics[NEW_STATE_ROOT]) + 1) \
        % gl.P
    print("chains: a tampered public refused: "
          + _tampered(verifier, air, setup.verkey, bad, "a tampered public"),
          flush=True)

    # gates.execute on the card over the Keccak slot's 48 input states,
    # 32 instances a word (word 1's bits 16..31: all-zero states)
    script = keccak_gates.build_script()
    states = keccak_chain_sm.slot_states(list(res.ctx.required.padding_kk),
                                         layout.keccak.n_instances)
    packed = torch.as_tensor(keccak_gates.pack_states(states)
                             .astype(np.int64), device="cuda")
    out = gates.execute(script, packed)
    _require(out.is_cuda, "gates.execute ran on the card")
    out = out.cpu().numpy().astype(np.uint64)
    gates_ms = _cuda_ms(lambda: gates.execute(script, packed), 3)
    wires = gates.execute_all_wires_np(
        script, keccak_chain_sm.slot_input(states, 0),
        keccak_chain_sm.PACK)[script.outputs]
    _require(np.array_equal(out[:, 0], wires & np.uint64(0xFFFFFFFF))
             and np.array_equal(out[:, 1] & np.uint64(0xFFFF),
                                wires >> np.uint64(32)),
             "gates.execute on the card equals execute_all_wires_np at the "
             "Keccak script's outputs")
    print(f"chains: devnet batch 0 at 2^18 {held}, verifies; cm1, const, "
          f"publics and verkey equal the JAX fixture's; gates.execute on "
          f"the card ({gates_ms:.3f} ms) equals execute_all_wires_np",
          flush=True)
    shapes = check_shapes(torch, air, "chains")
    t = req.timings
    report = {"card": device.smi("name,power.limit"), "n_bits": air.n_bits,
              "rows": air.n, "build_s": build_s, "setup_s": setup_s,
              "request_s": request_s, "execute_s": t["execute_s"],
              "stark_s": t["stark_s"], "rounds_s": t["rounds_s"],
              "verify_s": t["verify_s"], "rows_per_s": air.n / t["stark_s"],
              "digest_s": digest_s,
              "gates_execute_ms": gates_ms, "peak_bytes": peak,
              "plan": _stream_stats(t["stark_stats"]),
              "launches": launches, "kernel_shapes": shapes}
    print("chains_2e18 " + json.dumps(report), flush=True)
    # what phase 12 (b) proves again under a 16 GiB budget, on the host
    kept = {"air": air, "const_np": gl.to_u64_np(setup.const_n),
            "cm1_np": res.cm1_np, "publics": list(res.publics),
            "proof_json": proof.to_json()}
    return launches, kept


def _free_port() -> int:
    """A loopback port free when asked (bound, read and released)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _main_cmd(*args) -> list:
    return [sys.executable, "-m", "xlayer_prover_tpu_torch.main", *args]


def entry_file_mode(device: str = "cuda") -> dict:
    """Phase 11 (a): ``main.py --prove-toy`` as a process on `device`; its
    JSON line must say verified.  -> its seconds and its line"""
    import subprocess
    t0 = time.perf_counter()
    out = subprocess.run(_main_cmd("--prove-toy", "--device", device),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=ENTRY_START_S)
    total_s = time.perf_counter() - t0
    _require(out.returncode == 0, f"main.py --prove-toy exited with 0 "
             f"(rc {out.returncode}: {out.stderr[-2000:]})")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    _require(line["verified"] is True, "main.py --prove-toy verified")
    return {"total_s": total_s, "line": line,
            "start_s": total_s - line["prove_s"] - line["verify_s"]}


def _hashdb_round_trip(port: int) -> dict:
    """Set / Get / GetFlushStatus against the HashDB server on `port`."""
    from google.protobuf import empty_pb2

    from xlayer_prover_tpu_torch.services import hashdb_service as hs
    from xlayer_prover_tpu_torch.services.gen import hashdb_pb2 as hpb

    key, value = (7, 11, 13, 17), (1 << 200) + 5
    remote = hs.HashDBRemote("127.0.0.1", port)
    try:
        res = remote.set("entry", (0, 0, 0, 0), key, value)
        got = remote.get("entry", res.new_root, key).value
        remote.consolidate("entry")
        status = remote._channel.unary_unary(
            f"/{hs.SERVICE}/GetFlushStatus",
            request_serializer=empty_pb2.Empty.SerializeToString,
            response_deserializer=hpb.GetFlushStatusResponse.FromString)(
                empty_pb2.Empty(), timeout=ENTRY_START_S)
    finally:
        remote._channel.close()
    _require(got == value and any(res.new_root)
             and status.last_flush_id == status.stored_flush_id == 1,
             "the HashDB service sets, gets and flushes over the wire")
    return {"new_root": list(res.new_root), "flush_id": status.last_flush_id}


def _executor_round_trip(port: int) -> dict:
    """Devnet batch 0 through ProcessStatelessBatchV2 and then
    ProcessBatchV2 against the executor server on `port`: both responses
    byte-equal to the JAX package's, the new state root the committed
    batch proof's."""
    from xlayer_prover_tpu_torch.services import executor_service as es
    from xlayer_prover_tpu_torch.utils import devnet

    with open(EXECUTOR_FIXTURE) as f:
        want = {k: bytes.fromhex(v) for k, v in json.load(f).items()}
    with open(A7_BATCH0) as f:
        publics = json.loads(json.load(f)["proof"])["publics"]
    limbs = [int(v) for v in publics[NEW_STATE_ROOT:NEW_STATE_ROOT + 8]]
    root = sum(v << (32 * i) for i, v in enumerate(limbs)).to_bytes(32,
                                                                    "big")
    stateless, batch = devnet.devnet0_executor_requests()
    process, flush, process_stateless = es.make_client(port)
    t0 = time.perf_counter()
    got = {"process_stateless_batch_v2": process_stateless(
               stateless, timeout=ENTRY_START_S),
           "process_batch_v2": process(batch, timeout=ENTRY_START_S)}
    seconds = time.perf_counter() - t0
    for name, resp in got.items():
        _require(resp.SerializeToString(deterministic=True) == want[name],
                 f"{name} of devnet batch 0 over the wire equals the JAX "
                 "package's (tests/data/executor_devnet0.json)")
        _require(resp.new_state_root == root, f"{name}'s new state root is "
                 "newStateRoot of a7_state_devnet/'s batch proof 0")
    return {"executor_s": seconds, "new_state_root": "0x" + root.hex(),
            "steps": got["process_batch_v2"].cnt_steps}


def _stateless_batch0_request():
    """Devnet batch 0 as the aggregator sends it: a
    GenStatelessBatchProofRequest (the genesis witness, the datastream)."""
    from xlayer_prover_tpu_torch.services.gen import aggregator_pb2 as pb
    from xlayer_prover_tpu_torch.utils import devnet

    sb = devnet.devnet_stateless_batch0()
    req = pb.GenStatelessBatchProofRequest()
    pi = req.input.public_inputs
    pi.witness, pi.data_stream = sb["witness"], sb["data_stream"]
    pi.sequencer_addr = sb["sequencer_addr"]
    pi.timestamp_limit = sb["timestamp_limit"]
    return req


def entry_services(out_dir: str = ENTRY_DIR) -> dict:
    """Phase 11 (b): ``main.py --run-services`` as a process, with the
    HashDB and executor servers and the aggregator client (connected to a
    MockAggregatorServer made here) on loopback ports; the HashDB,
    executor and status calls answered, a GenStatelessBatchProof failed
    as the JAX package's ``ProverService({})`` fails it; then SIGINT, and
    the process must exit with 0.  Its config and log go to `out_dir`.
    -> its seconds"""
    import signal
    import subprocess

    import grpc

    from xlayer_prover_tpu_torch.services.aggregator import \
        MockAggregatorServer
    from xlayer_prover_tpu_torch.services.gen import aggregator_pb2 as pb

    os.makedirs(out_dir, exist_ok=True)
    server = MockAggregatorServer().start()
    hashdb_port, executor_port = _free_port(), _free_port()
    config = {"runHashDBServer": True, "hashDBServerPort": hashdb_port,
              "runExecutorServer": True, "executorServerPort": executor_port,
              "runAggregatorClient": True,
              "aggregatorClientHost": "127.0.0.1",
              "aggregatorClientPort": server.port,
              "proverName": ENTRY_PROVER_NAME}
    cfg_path = os.path.join(out_dir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f, indent=1)
    log = open(os.path.join(out_dir, "run_services.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(_main_cmd("-c", cfg_path, "--run-services"),
                            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    channels = []
    try:
        for port in (hashdb_port, executor_port):
            channels.append(grpc.insecure_channel(f"127.0.0.1:{port}"))
            grpc.channel_ready_future(channels[-1]).result(
                timeout=ENTRY_START_S)
        _require(server.wait_connected(ENTRY_START_S),
                 "the aggregator client of --run-services connected")
        start_s = time.perf_counter() - t0
        report = {"start_s": start_s, **_hashdb_round_trip(hashdb_port),
                  **_executor_round_trip(executor_port)}
        st = server.ask("entry-status", timeout=ENTRY_START_S,
                        get_status_request=pb.GetStatusRequest())
        _require(st.get_status_response.prover_name == ENTRY_PROVER_NAME,
                 "GetStatus names the configured prover")
        gen = server.ask("entry-gen", timeout=ENTRY_START_S,
                         gen_stateless_batch_proof_request=(
                             _stateless_batch0_request()))
        _require(gen.gen_batch_proof_response.result == pb.RESULT_OK,
                 "--run-services accepted GenStatelessBatchProof")
        got = server.ask("entry-get", timeout=ENTRY_START_S,
                         get_proof_request=pb.GetProofRequest(
                             id=gen.gen_batch_proof_response.id,
                             timeout=int(ENTRY_START_S))).get_proof_response
        _require(got.result == pb.GetProofResponse.RESULT_INTERNAL_ERROR
                 and "no batch prover engine configured" in got.result_string,
                 "--run-services fails GenStatelessBatchProof as the JAX "
                 "main.py does (ProverService({}) has no batch prover)")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=ENTRY_START_S)
        report["stop_s"] = time.perf_counter() - t1
        _require(rc == 0, f"--run-services exited with 0 on SIGINT (rc {rc})")
        report["total_s"] = time.perf_counter() - t0
    finally:
        for channel in channels:
            channel.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()
        log.close()
    return report


def entry_served_proof(torch) -> tuple[dict, dict]:
    """Phase 11 (c): devnet batch 0 served over loopback gRPC by
    ``AggregatorClient(ProverService(batch_prover=devnet.devnet_prover()))``
    as GenStatelessBatchProof; its GetProof must give RESULT_COMPLETED_OK
    and the proof text of a7_state_devnet/'s batch proof 0, which
    verifies; a second request, cancelled while pending, RESULT_CANCEL;
    an unknown id RESULT_ERROR.  Launches counted from 0 (the setup's
    included), each from the service's worker thread.  -> (launches,
    report)"""
    import threading

    from xlayer_prover_tpu_torch import kernels
    from xlayer_prover_tpu_torch.prover_service import (ProverService,
                                                         RequestState)
    from xlayer_prover_tpu_torch.services.aggregator import (
        AggregatorClient, MockAggregatorServer)
    from xlayer_prover_tpu_torch.services.gen import aggregator_pb2 as pb
    from xlayer_prover_tpu_torch.stark import verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof
    from xlayer_prover_tpu_torch.utils import devnet

    req = _stateless_batch0_request()
    with open(A7_BATCH0) as f:
        want = f.read()
    writers = set()

    class Writers(dict):
        """The launch counts, with the thread of every count kept."""

        def __setitem__(self, key, value):
            writers.add(threading.get_ident())
            super().__setitem__(key, value)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts = kernels.LAUNCHES
    kernels.reset_launches()
    kernels.LAUNCHES = Writers(counts)
    server = MockAggregatorServer().start()
    svc = client = None
    try:
        t0 = time.perf_counter()
        engine = devnet.devnet_prover()
        setup = engine.setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        svc = ProverService(batch_prover=engine)
        client = AggregatorClient(svc, "127.0.0.1", server.port,
                                  watchdog_timeout_s=2 * ENTRY_PROOF_S)
        client.start()
        _require(server.wait_connected(ENTRY_START_S),
                 "the aggregator client connected")
        t0 = time.perf_counter()
        ids = []
        for k in range(2):
            gen = server.ask(f"entry-gen-{k}", timeout=ENTRY_START_S,
                             gen_stateless_batch_proof_request=req)
            _require(gen.gen_batch_proof_response.result == pb.RESULT_OK,
                     "GenStatelessBatchProof accepted")
            ids.append(gen.gen_batch_proof_response.id)
        _require(svc.get(ids[1]).state == RequestState.PENDING,
                 "the second request waits behind the first")
        cancel = server.ask("entry-cancel", timeout=ENTRY_START_S,
                            cancel_request=pb.CancelRequest(id=ids[1]))
        _require(cancel.cancel_response.result == pb.RESULT_OK,
                 "the pending request is cancelled")
        replies = {}
        for name, uid in (("cancelled", ids[1]), ("unknown", "no-such-id")):
            replies[name] = server.ask(
                f"entry-get-{name}", timeout=ENTRY_START_S,
                get_proof_request=pb.GetProofRequest(id=uid, timeout=1)
            ).get_proof_response.result
        _require(replies == {"cancelled": pb.GetProofResponse.RESULT_CANCEL,
                             "unknown": pb.GetProofResponse.RESULT_ERROR},
                 "GetProof: RESULT_CANCEL for the cancelled request, "
                 f"RESULT_ERROR for an unknown id ({replies})")
        got = server.ask("entry-get", timeout=ENTRY_PROOF_S + ENTRY_START_S,
                         get_proof_request=pb.GetProofRequest(
                             id=ids[0], timeout=int(ENTRY_PROOF_S))
                         ).get_proof_response
        request_s = time.perf_counter() - t0
        preq = svc.get(ids[0])
        _require(got.result == pb.GetProofResponse.RESULT_COMPLETED_OK,
                 f"the served proof completed ({got.result}: "
                 f"{got.result_string})")
        text = got.recursive_proof
        _require(json.dumps({"level": 0, "proof": text}) == want,
                 "the proof served over gRPC is byte-equal to "
                 "a7_state_devnet/batch_proof_0vdev0_nb16_q4.json")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        _require(verifier.verify(engine.air, setup.verkey,
                                 StarkProof.from_json(text)),
                 "the served proof verifies")
        verify_again_s = time.perf_counter() - t1
        _require(setup.const_ext.device == torch.device("cuda", 0),
                 "the served proof's setup lives on device 0")
        worker = svc._worker.ident
    finally:
        launches = dict(kernels.LAUNCHES)
        kernels.LAUNCHES = counts
        counts.update(launches)
        if client is not None:
            client.stop()
        server.stop()
        if svc is not None:
            svc.shutdown()
    main_thread = threading.get_ident()
    _require(writers <= {worker, main_thread} and worker in writers,
             "every launch of the served proof came from the service's "
             "worker thread (the setup's from this one)")
    t = preq.timings
    work_s = t["execute_s"] + t["stark_s"] + t["verify_s"]
    report = {"setup_s": setup_s, "request_s": request_s,
              "execute_s": t["execute_s"], "stark_s": t["stark_s"],
              "rounds_s": t["rounds_s"], "verify_s": t["verify_s"],
              "wire_s": request_s - work_s, "verify_again_s": verify_again_s,
              "peak_bytes": peak, "launches": launches}
    print("entry: devnet batch 0 served as GenStatelessBatchProof over "
          "loopback gRPC, byte-equal to a7_state_devnet/, verified; a "
          "pending request cancelled, an unknown id refused", flush=True)
    return launches, report


def phase_entry(torch) -> dict:
    """Phase 11: the entry point, (a) the file mode and (b) the services
    as processes on the card, side by side, then (c) the served proof in
    this process.  -> the launches of (c)"""
    import threading

    from xlayer_prover_tpu_torch import device

    t0 = time.perf_counter()
    # (a) and (b) run side by side: two processes of their own
    file_mode = {}

    def run_file_mode():
        try:
            file_mode.update(entry_file_mode())
        except BaseException as e:  # noqa: BLE001 - raised below
            file_mode["error"] = e

    worker = threading.Thread(target=run_file_mode)
    worker.start()
    try:
        services = entry_services()
    finally:
        worker.join()
    if "error" in file_mode:
        raise file_mode["error"]
    print(f"entry: main.py --prove-toy verified in {file_mode['total_s']:.3f}"
          " s; main.py --run-services answered HashDB, executor and status "
          "calls, exited with 0 on SIGINT", flush=True)
    launches, served = entry_served_proof(torch)
    report = {"card": device.smi("name,power.limit"),
              "total_s": time.perf_counter() - t0,
              "prove_toy": file_mode, "run_services": services,
              "served": served, "launches": launches}
    print("entry " + json.dumps(report), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the StarkInfo memory plan and the streamed sections
# ---------------------------------------------------------------------------

STREAM_BUDGET = 16 << 30           # (b): the JAX memory_plan's default
STREAM_N_BITS = 20                 # (c): devnet batch 0 at 2^20 rows
STREAM_REQUEST_S = 2400.0          # (c): the request's wait


def _capacity_hash(linear_hash, rows, width: int, block: int):
    """linear_hash of (n, width) rows absorbed `block` columns at a time,
    each block read in place and its digest carried into the next."""
    dig = None
    for c0 in range(0, width, block):
        w = min(block, width - c0)
        dig = linear_hash(rows[:, c0:c0 + w], w, dig)
    return dig


def phase_stream_kernels(torch, rng) -> list:
    """Phase 12 (a): poseidon_linear_hash with a carried capacity over
    RATE-aligned column blocks read in place, at 2^20 x 39 (blocks of 16)
    and 2^19 x 669 (blocks of 64), bit for bit equal to the one-shot
    digest of the whole width and, on the first 4,096 rows, to the plain
    version block by block; then timed at the streamed LDE's shape, a
    64-column block with a carried capacity, at the 2^18 and 2^20
    extended domains.  -> K2's shapes for its more_shapes"""
    import numpy as np

    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.ops import poseidon_gl

    P = gl.P
    cuda = torch.device("cuda")
    small = 4096
    for n, width, block in ((1 << 20, 39, 16), (1 << 19, 669, 64)):
        host = rng.integers(0, P, size=(n, width), dtype=np.uint64)
        host[:8] = np.array([0, 1, P - 1, P, P + 1, (1 << 63),
                             (1 << 64) - 1, (1 << 32) - 1],
                            dtype=np.uint64)[:, None]
        rows = gl.from_u64_np(host, cuda)
        del host
        one = poseidon_gl.linear_hash(rows, width)
        blocks = _capacity_hash(poseidon_gl.linear_hash, rows, width, block)
        plain = _capacity_hash(poseidon_gl._linear_hash_plain, rows[:small],
                               width, block)
        torch.cuda.synchronize()
        _require(torch.equal(blocks, one),
                 f"poseidon_linear_hash over {block}-column blocks with a "
                 f"carried capacity equals the one-shot digest at "
                 f"[{n}, {width}]")
        _require(torch.equal(blocks[:small], plain),
                 f"poseidon_linear_hash with a carried capacity equals its "
                 f"plain version at [{small}, {width}] in {block}-column "
                 "blocks")
        print(f"stream: poseidon_linear_hash over {block}-column blocks of "
              f"[{n}, {width}] with a carried capacity, read in place, "
              "equals the one-shot digest and the plain version", flush=True)
        del rows, one, blocks, plain
        torch.cuda.empty_cache()
    int_rate = int_mul_rate(torch)
    shapes = []
    for n in (1 << 19, 1 << 21):
        block = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 64),
                              dtype=torch.int64, device=cuda)
        cap = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 4),
                            dtype=torch.int64, device=cuda)
        ms = _cuda_ms(lambda: poseidon_gl.linear_hash(block, 64, cap), 5)
        bound, by = _bound_ms({"bytes": (64 + 4 + 4) * 8 * n,
                               "ops": poseidon_mul32() * 8 * n}, int_rate)
        shapes.append({"shape": [n, 64], "capacity": True, "ms": ms,
                       "bound_ms": bound, "bound_by": by})
        print(f"kernel poseidon_linear_hash at [{n}, 64] with a carried "
              f"capacity (a streamed LDE block): {ms:.4f} ms (bound "
              f"{bound:.4f} ms by {by})", flush=True)
        del block, cap
        torch.cuda.empty_cache()
    return shapes


def _stream_stats(stats: dict) -> dict:
    """The plan, windows, copies and peaks of a proof's stats, with each
    copy direction's GB/s."""
    out = {k: stats.get(k) for k in (
        "stream", "budget", "total_bytes", "hbm_resident",
        "stream_block_cols", "block_cols", "window_rows", "windows",
        "round5_window_rows", "round5_windows", "quotient_bytes",
        "peak_bytes", "allocated_bytes")}
    out["copies"] = {k: dict(v, gb_per_s=(v["bytes"] / v["s"] / 1e9
                                          if v["s"] and k != "pin_wait"
                                          else None))
                     for k, v in stats.get("copies", {}).items()}
    return out


def phase_stream_2e18(torch, chains: dict) -> dict:
    """Phase 12 (b): phase 10's devnet batch 0 at 2^18 proven again under
    a budget of 16 GiB (the JAX memory_plan's default), where the plan
    streams: the Setup and the proof (launches counted from 0, the peak
    reset, phase 10's device data freed), byte-equal to phase 10's
    resident proof, the allocator's peak at or under the budget.
    -> launches"""
    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.stark import prover, verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof

    air = chains["air"]
    sp = prover.section_plan(air, "cuda", STREAM_BUDGET)
    _require(sp.stream, "the plan streams the 2^18 chains AIR under 16 GiB")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    setup = prover.Setup.build(air, chains["const_np"],
                               hbm_bytes=STREAM_BUDGET)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _require(not setup.const_ext.is_cuda, "the streamed Setup keeps its "
             "extended constants in host memory")
    timings, stats = {}, {}
    t0 = time.perf_counter()
    proof = prover.gen_proof(setup, chains["cm1_np"], chains["publics"],
                             timings=timings, stats=stats)
    torch.cuda.synchronize()
    stark_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _require(proof.to_json() == chains["proof_json"],
             "the 2^18 proof streamed under 16 GiB is byte-equal to phase "
             "10's resident proof")
    _require(peak <= STREAM_BUDGET, f"the streamed 2^18 proof's peak device "
             f"memory {peak} B is at or under 16 GiB")
    t0 = time.perf_counter()
    _require(verifier.verify(air, setup.verkey,
                             StarkProof.from_json(proof.to_json())),
             "the streamed 2^18 proof verifies")
    verify_s = time.perf_counter() - t0
    report = {"card": device.smi("name,power.limit"), "n_bits": air.n_bits,
              "setup_s": setup_s, "stark_s": stark_s, "rounds_s": timings,
              "verify_s": verify_s, "rows_per_s": air.n / stark_s,
              "peak_bytes": peak, "plan": _stream_stats(stats),
              "launches": launches}
    print(f"stream: devnet batch 0 at 2^18 under 16 GiB: plan total_bytes="
          f"{stats['total_bytes']} hbm_resident={stats['hbm_resident']} "
          f"stream_block_cols={stats['stream_block_cols']} (LDE blocks of "
          f"{stats['block_cols']}), {stats['windows']} row windows of "
          f"{stats['window_rows']}; byte-equal to phase 10's proof, "
          f"verified, peak {peak} B", flush=True)
    print("stream_2e18 " + json.dumps(report), flush=True)
    return launches


def _host_peak_rss() -> int:
    """This process's peak resident set so far, in bytes."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def prepare_2e20(out: dict):
    """Phase 12 (c)'s host work, run beside the kernels' build: the 2^20
    devnet BatchProver (its AIR) and its constant columns (the
    executor's, shared by the Setup and the request's execution).  Any
    error is kept in out["error"] for phase 12 (c) to raise."""
    try:
        from xlayer_prover_tpu_torch.utils import devnet
        t0 = time.perf_counter()
        out["engine"] = devnet.devnet_prover(
            geometry=devnet.devnet_geometry(STREAM_N_BITS))
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["engine"].executor.fixed()
        out["fixed_s"] = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - raised in phase 12 (c)
        out["error"] = e


def phase_stream_2e20(torch, prep: dict) -> dict:
    """Phase 12 (c): devnet batch 0 at 2^20 rows with the chains
    (``devnet.devnet_geometry(20)``, built by ``prepare_2e20``) as one
    GEN_BATCH_PROOF request to ``ProverService(batch_prover=...)`` with
    the card's own memory as the budget, under which the plan streams;
    launches counted from 0 and the peak reset before the setup.  The
    proof verifies (the service verifies it before the request
    completes), with one evaluation or one public changed it is refused,
    and its publics equal the 2^18 JAX fixture's (the same batch executes
    to the same roots at any geometry).  -> launches"""
    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.prover_service import (ProverRequest,
                                                         ProverService,
                                                         RequestState,
                                                         RequestType)
    from xlayer_prover_tpu_torch.stark import prover, verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof
    from xlayer_prover_tpu_torch.utils import devnet

    if "error" in prep:
        raise prep["error"]
    with open(CHAINS_FIXTURE) as f:
        want = json.load(f)
    engine, build_s = prep["engine"], prep["build_s"]
    air = engine.air
    sp = prover.section_plan(air, "cuda")
    _require(sp.stream, f"the plan streams devnet batch 0 at 2^{air.n_bits} "
             "under the card's memory")
    print(f"stream: devnet batch 0 at 2^{air.n_bits}: cm1={air.cm1_width} "
          f"cm2={air.cm2_width} cm3={air.cm3_width} const="
          f"{air.const_width} q_deg={air.q_deg} plookups="
          f"{len(air.plookups)}; plan total_bytes="
          f"{sp.plan['total_bytes']} hbm_resident="
          f"{sp.plan['hbm_resident']} stream_block_cols="
          f"{sp.plan['stream_block_cols']} (LDE blocks of {sp.block_cols}) "
          f"under {sp.budget} B; AIR build {build_s:.3f} s and constants "
          f"{prep['fixed_s']:.3f} s beside the kernels' build", flush=True)
    inp = devnet.build_devnet_inputs(engine, 1)[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    setup = engine.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _require(not setup.const_ext.is_cuda, "the 2^20 Setup keeps its "
             "extended constants in host memory")
    svc = ProverService(batch_prover=engine)
    try:
        req = ProverRequest(RequestType.GEN_BATCH_PROOF, {"input": inp})
        t0 = time.perf_counter()
        svc.submit(req)
        svc.wait(req.uuid, timeout=STREAM_REQUEST_S)
        request_s = time.perf_counter() - t0
    finally:
        svc.shutdown()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    host_peak = _host_peak_rss()
    if req.state != RequestState.COMPLETED:
        raise RuntimeError(f"stream: the 2^{air.n_bits} GEN_BATCH_PROOF "
                           f"ended {req.state.value}: {req.error}")
    # the service verified the proof before it completed the request
    # (verifier.verify raises VerifyError on a proof that fails)
    proof = req.proof
    _require(proof.publics == [p % gl.P for p in want["publics"]],
             f"the 2^{air.n_bits} publics equal the 2^18 JAX fixture's")
    bad = StarkProof.from_json(proof.to_json())
    bad.evals[0][0] = (int(bad.evals[0][0]) + 1) % gl.P
    print("stream: a tampered evaluation refused: "
          + _tampered(verifier, air, setup.verkey, bad, "a tampered "
                      "evaluation"), flush=True)
    bad = StarkProof.from_json(proof.to_json())
    bad.publics[NEW_STATE_ROOT] = (int(bad.publics[NEW_STATE_ROOT]) + 1) \
        % gl.P
    print("stream: a tampered public refused: "
          + _tampered(verifier, air, setup.verkey, bad, "a tampered public"),
          flush=True)
    t = req.timings
    report = {"card": device.smi("name,power.limit"), "n_bits": air.n_bits,
              "rows": air.n, "build_s": build_s, "fixed_s": prep["fixed_s"],
              "setup_s": setup_s, "request_s": request_s,
              "execute_s": t["execute_s"], "stark_s": t["stark_s"],
              "rounds_s": t["rounds_s"], "verify_s": t["verify_s"],
              "rows_per_s": air.n / t["stark_s"], "peak_bytes": peak,
              "host_peak_rss_bytes": host_peak,
              "plan": _stream_stats(t["stark_stats"]),
              "launches": launches}
    print(f"stream: devnet batch 0 at 2^{air.n_bits} proven as a "
          "GEN_BATCH_PROOF, verified, tampered proofs refused, publics "
          "equal to the 2^18 fixture's", flush=True)
    print(f"chains_2e{air.n_bits} " + json.dumps(report), flush=True)
    return launches


# -- phase 13: the PLONK conversion and the fflonk wrap ---------------------

FFLONK_SOURCE = "xlayer_prover_tpu_torch/csrc/fr_poly.cu"
# phase 13 (b): the JAX package's fflonk keys and proof of a seeded R1CS
# (tools/torch_proof_fixtures.py fflonk_seeded_n12)
FFLONK_FIXTURE = os.path.join(REPO, "tests", "data",
                              "fflonk_seeded_n12.json")
FFLONK_RNG = 11                    # (c): the cascade's seed
PLAIN_SAMPLE = 1 << 20             # (a): the rows held against plain
LOOKBACK_DEEP_TILES = 100_003      # (a): tiles of the deep look-back


def fr_poly_work(name: str, **kw) -> dict:
    """Bytes and 32-bit multiplies of one call of a fr_poly kernel's
    function, whatever computes it: each input read and each output
    written once, a Montgomery product (FR_MUL) for each product the
    function needs.  fr_eval: n coefficients, m points (a full product,
    FR_PROD32, a coefficient a point, and one reduction a point: the
    powers of x can weigh the coefficients unreduced, as fr_eval's
    512-bit sums do); fr_div_binomial: n coefficients by X^k - c (a
    product a quotient and a remainder value by the recurrence
    q_j = p_{j+k} + c q_{j+k}, none where c = 1); fr_scan_mul: n outputs
    of n inputs (or one repeated), a product each; fr_pointwise: `inputs` vectors of n
    values, `outputs` of n, `products` a value, the fewest the identity
    needs: the gate a (qM b + qL) + qR b + qO c + qC + PI 4; perm_z 9,
    the domain point x = w^i 1, beta x 1 (K1 beta x and K2 beta x are
    additions: K1 = 2, K2 = 3), beta S1..S3 3 and each side's three
    factors 2 and 2; perm_t2 those 9 and z num - z(w x) den 2, 11; a
    linear combination one a term, over `lens`, its inputs' lengths,
    where they differ.  With `domain`, the identity reads
    x: the work is then either design, x computed (its product counted)
    or x read from a table of n values (32 bytes more a value, a
    product fewer), and `timed` takes the lesser bound of the two."""
    if name == "fr_eval":
        n, m = kw["n"], kw["m"]
        return {"bytes": 32 * (n + m),
                "ops": n * m * FR_PROD32 + m * FR_REDC32}
    if name == "fr_div_binomial":
        n, k = kw["n"], kw["k"]
        products = 0 if kw["c"] == 1 else max(0, n - k) + k
        return {"bytes": 32 * (n + max(0, n - k) + k),
                "ops": products * FR_MUL}
    if name == "fr_scan_mul":
        n = kw["n"]
        return {"bytes": 32 * ((1 if kw.get("repeated") else n) + n),
                "ops": n * FR_MUL}
    n = kw["n"]
    if kw.get("lens"):
        # a linear combination of inputs of these lengths (n the longest)
        return {"bytes": 32 * (sum(kw["lens"]) + n),
                "ops": sum(kw["lens"]) * FR_MUL}
    work = {"bytes": 32 * n * (kw["inputs"] + kw["outputs"]),
            "ops": n * kw["products"] * FR_MUL}
    if not kw.get("domain"):
        return work
    return [work, {"bytes": work["bytes"] + 32 * n,
                   "ops": work["ops"] - n * FR_MUL}]


FR_POLY_WRAPPERS = {"fr_eval": "evaluate", "fr_div_binomial": "div_binomial",
                    "fr_scan_mul": "scan_mul", "fr_pointwise": "pointwise"}


def _fr_poly_call(name: str, fn, args, kw) -> tuple:
    """What sets the work of one call of fr_poly's wrapper `fn` of kernel
    `name`: fr_eval (length, points); fr_div_binomial (length, k, c ==
    1); fr_scan_mul (length, repeated, exclusive, reverse); fr_pointwise
    (the identity, each input's length)."""
    import inspect

    from xlayer_prover_tpu_torch.fields.bn254 import R as r
    b = inspect.signature(fn).bind(*args, **kw)
    b.apply_defaults()
    a = b.arguments
    if name == "fr_eval":
        return (name, a["p"].shape[0], len(a["points"]))
    if name == "fr_div_binomial":
        return (name, a["p"].shape[0], a["k"], int(a["c"]) % r == 1)
    if name == "fr_scan_mul":
        rep = a["n"] is not None
        return (name, a["n"] if rep else a["x"].shape[0], rep,
                bool(a["exclusive"]), bool(a.get("reverse", False)))
    return (name, a["op"], tuple(x.shape[0] for x in a["inputs"]))


@contextlib.contextmanager
def fr_poly_calls():
    """Yields a list that gets _fr_poly_call of each call of fr_poly's
    four wrappers, wherever it was made from (snark/fflonk.py reads them
    off the module)."""
    from xlayer_prover_tpu_torch.ops import fr_poly
    calls, saved = [], {}
    for name, attr in FR_POLY_WRAPPERS.items():
        fn = saved[attr] = getattr(fr_poly, attr)

        @functools.wraps(fn)
        def rec(*args, _name=name, _fn=fn, **kw):
            calls.append(_fr_poly_call(_name, _fn, args, kw))
            return _fn(*args, **kw)
        setattr(fr_poly, attr, rec)
    try:
        yield calls
    finally:
        for attr, fn in saved.items():
            setattr(fr_poly, attr, fn)


def fflonk_wrap_calls(fr_poly, ntt_fr, n: int, sl, y: int, ks) -> list:
    """Every fr_eval, fr_div_binomial, fr_scan_mul and fr_pointwise call
    of the fflonk wrap at domain n, as (kernel, what, length, call, work,
    launches a wrap); the inputs are sl(j, m), slices of one random
    buffer, y a random point, ks four random constants.  The lengths are
    snark/fflonk.py's: C0 = sum_i p_i(X^8) X^i over the eight keys of n
    values has 8n, C1 over a, b, c (n + 2) and t0 (2n + 2) 8n + 8, C2
    over z (n + 3), t1 (n + 2) and t2 (3n + 6) 9n + 18, and each root
    set's quotient the length less the set's size.  Phase 13 (a) holds
    the rows, with their launches a wrap, to the calls that (c)'s setup
    and proof made (fr_poly_calls).  fr_eval's first two rows (at 9n +
    21, the shapes its row was first timed at) are no call of the
    wrap."""
    import inspect

    import torch
    c0, c1, c2 = 8 * n, 8 * n + 8, 9 * n + 18
    w8 = ntt_fr.root_of_unity((8 * n).bit_length() - 1)
    w1 = ntt_fr.root_of_unity(n.bit_length() - 1)
    calls = []

    def pw(what, m, nin, outs, products, call, domain=False, lens=None):
        calls.append(("fr_pointwise", what, m, call, fr_poly_work(
            "fr_pointwise", n=m, inputs=nin, outputs=outs,
            products=products, domain=domain, lens=lens), 1))
    # fr_eval: a, b, c and t1 at n + 2 and the eight keys at n (one
    # point), z at two, t2 at 3n + 6, the root sets' 8, 4 and 6 points
    # over C0, C1, C2
    for m, pts, what, per in ((9 * n + 21, 2, "z at xi and xi w", 0),
                              (9 * n + 21, 1, "one point", 0),
                              (n + 2, 1, "a, b, c or t1 at xi", 4),
                              (n, 1, "a key at xi", 8),
                              (n + 3, 2, "z at xi and xi w", 1),
                              (3 * n + 6, 1, "t2 at xi w", 1),
                              (c0, 8, "C0 at S0's 8 points", 1),
                              (c1, 4, "C1 at S1's 4 points", 1),
                              (c2, 6, "C2 at S2's 6 points", 1)):
        xs = [y + j for j in range(pts)]
        calls.append(("fr_eval", what, m,
                      lambda m=m, xs=xs: fr_poly.evaluate(sl(0, m), xs),
                      fr_poly_work("fr_eval", n=m, m=pts), per))
    for m, k, c, what, per in ((c2, 1, y, "W' = L / (X - y)", 1),
                               (8 * n, n, 1, "T2 by X^n - 1", 1),
                               (4 * n, n, 1, "T0 by X^n - 1", 1),
                               (n + 3, 1, 1, "T1 by X - 1", 1),
                               (c0, 8, y, "C0 by X^8 - c", 1),
                               (c1, 4, y, "C1 by X^4 - c", 1),
                               (c2, 3, y, "C2 by X^3 - c", 1),
                               (c2 - 3, 3, y, "C2's quotient by X^3 - c",
                                1)):
        calls.append(("fr_div_binomial", what, m,
                      lambda m=m, k=k, c=c: fr_poly.div_binomial(
                          sl(0, m), k, c),
                      fr_poly_work("fr_div_binomial", n=m, k=k, c=c), per))
    def scan(m, rep, ex, rev):
        if rep:
            return fr_poly.scan_mul(sl(0, 1), ex, y, n=m)
        if not rev:
            return fr_poly.scan_mul(sl(0, m), ex)
        if "reverse" in inspect.signature(fr_poly.scan_mul).parameters:
            return fr_poly.scan_mul(sl(0, m), ex, reverse=True)
        # a tree before the reverse scan: the scan of the reversed copy
        return torch.flip(fr_poly.scan_mul(torch.flip(sl(0, m), [0])
                                           .contiguous(), ex), [0])
    for m, repeated, exclusive, rev, what, per in (
            (10 * n + 41, True, True, False, "tau^i", 1),
            (n - 1, False, False, False, "z's running product", 1),
            (n - 1, False, True, True, "the denominators' suffix products",
             1),
            (n, True, True, False, "the tags k w^i", 3)):
        calls.append(("fr_scan_mul", what, m,
                      lambda m=m, rep=repeated, ex=exclusive, rev=rev:
                      scan(m, rep, ex, rev),
                      fr_poly_work("fr_scan_mul", n=m, repeated=repeated),
                      per))
    pw("T2's identity", 8 * n, 7, 1, 11, lambda: fr_poly.pointwise(
        "perm_t2", [sl(j, 8 * n) for j in range(7)], [y, y + 2], w8, 8),
       True)
    pw("the gate", 4 * n, 9, 1, 4, lambda: fr_poly.pointwise(
        "gate", [sl(j, 4 * n) for j in range(9)]))
    pw("z's numerator, denominator", n, 6, 2, 9, lambda: fr_poly.pointwise(
        "perm_z", [sl(j, n) for j in range(6)], [y, y + 2], w1), True)
    # L = C0, C1, C2 and W; W = the root sets' quotients
    for what, lens in (("L", (c0, c1, c2, c2 - 6)),
                       ("W", (c0 - 8, c1 - 4, c2 - 6))):
        pw(what, max(lens), len(lens), 1, len(lens),
           lambda lens=lens: fr_poly.pointwise(
               "lincomb", [sl(j, m) for j, m in enumerate(lens)],
               ks[:len(lens)]), lens=lens)
    pw("z's product", n - 1, 2, 1, 2, lambda: fr_poly.pointwise(
        "mul", [sl(0, n - 1), sl(1, n - 1)], [y]))
    pw("T1's scale", n + 2, 1, 1, 1, lambda: fr_poly.pointwise(
        "lincomb", [sl(0, n + 2)], [y]))
    return calls


def _division_holds(p, q, rem, k: int, c: int, xs) -> bool:
    """p(x) = q(x) (x^k - c) + rem(x) at each x of xs (random points of
    Fr: a wrong q or rem passes with probability under deg / r),
    evaluated by fr_eval (held bit for bit against its plain version)."""
    from xlayer_prover_tpu_torch.fields.bn254 import R as r
    from xlayer_prover_tpu_torch.ops import fr_poly
    from xlayer_prover_tpu_torch.ops.bn254_mont import from_words
    rs = from_words(rem)
    for x, pv, qv in zip(xs, fr_poly.evaluate(p, xs),
                         fr_poly.evaluate(q, xs)):
        rv = sum(v * pow(x, j, r) for j, v in enumerate(rs)) % r
        if pv != (qv * (pow(x, k, r) - c) + rv) % r:
            return False
    return True


def _rand_fr(torch, n: int, dev, gen=None):
    """(n, 4) words below 2^252 (< r), the first rows 0, 1, r - 1 and
    r - 2."""
    from xlayer_prover_tpu_torch.fields.bn254 import R as r
    from xlayer_prover_tpu_torch.ops.bn254_mont import to_words
    x = torch.randint(0, 1 << 62, (n, 4), dtype=torch.int64, device=dev,
                      generator=gen)
    x[:, 3] &= (1 << 60) - 1
    head = torch.from_numpy(to_words([0, 1, r - 1, r - 2])).to(dev)
    x[:min(4, n)] = head[:min(4, n)]
    return x


def phase_fflonk_kernels(torch, n: int, wrap_calls: list) -> list:
    """Phase 13 (a): fr_eval, fr_div_binomial, fr_scan_mul and
    fr_pointwise each held bit for bit against its plain version on the
    card at small shapes (small inputs and a chain's edges: 1, 33 and
    4,101 values, k = 1, 3, 8, 9, 2^10, broadcast scans, inputs of their
    own lengths, domains of 1, 2^5 and 2^15; fr_div_binomial's look-back
    at k = 1, 3, 4, 8 with c = 1 and not over m < k, one tile, a ragged
    last tile and three, and over LOOKBACK_DEEP_TILES tiles by the
    division's identity at random points; fr_eval at 5, 8 and 9 points
    about one tile, at 2 points where a block takes two tiles, and over
    coefficients all r - 1; fr_scan_mul's product look-back over 1 to
    514 tiles, prefix and suffix, inclusive and exclusive, its
    repeated form across 2^L of its tables, and tau^i's length at 10
    positions against the host) and at PLAIN_SAMPLE rows of
    each devnet use (every division's binomial; fr_pointwise's T2
    identity, perm_z, the gate, L, W, T1's scale and z's product), then
    timed at the devnet root's
    shapes of (c) (n = its domain), each with its launches a wrap: every
    call of the wrap's 17 fr_eval, 8 fr_div_binomial, 6 fr_scan_mul and 7
    fr_pointwise launches (and fr_eval's two rows at 9n + 21), the rows
    and their launches a wrap held to `wrap_calls`, the calls of (c)'s
    setup and proof (fr_poly_calls), with launches x (ms - bound) a wrap
    for each kernel.  fr_ntt at 2^26 (the
    devnet root's 8n domain) and 2^27 (a circuit twice its size; Fr's
    domains stop at 2^28): the round trip, and the forward
    transform at 8 positions equal to the polynomial's values there
    (fr_eval) and, for a 3-term input, to the host's.  -> the rows"""
    import random

    from xlayer_prover_tpu_torch.fields.bn254 import R as r
    from xlayer_prover_tpu_torch.ops import fr_poly, ntt_fr
    from xlayer_prover_tpu_torch.ops.bn254_mont import from_words, to_words

    cuda = torch.device("cuda")
    int_rate = int_mul_rate(torch)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SEED)
    pyrng = random.Random(SEED)

    def words(vals):
        return torch.from_numpy(to_words(vals)).to(cuda)

    def rand(m):
        return _rand_fr(torch, m, cuda, gen)

    err = {k: 0 for k in FFLONK_KERNELS}
    marks = [time.perf_counter()]

    def same(name, got, ref, what):
        if isinstance(got, list):
            e = 0 if got == ref else 1
        else:
            e = _max_abs_err(got, ref)
        err[name] = max(err[name], e)
        _require(e == 0, f"{name} equals its plain version ({what})")

    plain_ms = {}
    # -- small shapes, every edge ------------------------------------------
    for m in (1, 33, 4096 + 5):
        p = rand(m)
        xs = [0, 1, r - 1, pyrng.randrange(r), pyrng.randrange(r)]
        same("fr_eval", fr_poly.evaluate(p, xs),
             fr_poly._eval_plain(p, xs), f"{m} values")
        for k in (1, 3, 8, 9, 1 << 10):
            c = pyrng.choice([0, 1, r - 1, pyrng.randrange(r)])
            q, rem = fr_poly.div_binomial(p, k, c)
            pq, pr = fr_poly._div_binomial_plain(p, k, c)
            same("fr_div_binomial", q, pq, f"{m} values, k = {k}")
            same("fr_div_binomial", rem, pr, f"{m} values, k = {k}")
        for ex in (False, True):
            init = pyrng.randrange(r)
            same("fr_scan_mul", fr_poly.scan_mul(p, ex, init),
                 fr_poly._scan_mul_plain(p, ex, init, None), f"{m} values")
            one = words([pyrng.randrange(r)])
            same("fr_scan_mul", fr_poly.scan_mul(one, ex, init, n=m),
                 fr_poly._scan_mul_plain(one, ex, init, m), f"{m} repeated")
        ins = [rand(m) for _ in range(9)]
        ks = [pyrng.randrange(r) for _ in range(4)]
        lens = [ins[0], ins[1][:max(1, m // 2)], ins[2][:1], ins[3]]
        same("fr_pointwise", fr_poly.pointwise("lincomb", lens, ks),
             fr_poly._pointwise_plain("lincomb", lens, ks, 1, 0), "lincomb")
        same("fr_pointwise", fr_poly.pointwise("mul", ins[:2], ks[:1]),
             fr_poly._pointwise_plain("mul", ins[:2], ks[:1], 1, 0), "mul")
        same("fr_pointwise", fr_poly.pointwise("gate", ins),
             fr_poly._pointwise_plain("gate", ins, [], 1, 0), "gate")
    for bits in (0, 5, 15):
        m = 1 << bits
        w = ntt_fr.root_of_unity(bits)
        ins = [rand(m) for _ in range(7)]
        bg = [pyrng.randrange(r), pyrng.randrange(r)]
        got = fr_poly.pointwise("perm_z", ins[:6], bg, w)
        ref = fr_poly._pointwise_plain("perm_z", ins[:6], bg, w, 0)
        for g, f in zip(got, ref):
            same("fr_pointwise", g, f, f"perm_z at 2^{bits}")
        same("fr_pointwise",
             fr_poly.pointwise("perm_t2", ins, bg, w, 8 % m),
             fr_poly._pointwise_plain("perm_t2", ins, bg, w, 8 % m),
             f"perm_t2 at 2^{bits}")
    # -- fr_eval's and fr_scan_mul's designs at their edges: 5 to 8 points
    # in one pass and 9 in two about one tile; a block's Horner over two
    # tiles (one more than the grid's); every coefficient r - 1 (the
    # 512-bit sums at their largest terms); the product look-back over
    # one, a ragged and 513 tiles, prefix and suffix, inclusive and
    # exclusive; the repeated scan's two tables across 2^L, and tau^i's
    # length against the host ---------------------------------------------
    tile = fr_poly.EVAL_TILE
    for m in (tile - 1, tile, tile + 1):
        p = rand(m)
        for pts in (5, 8, 9):
            xs = [r - 1, 0, 1] + [pyrng.randrange(r) for _ in range(pts - 3)]
            same("fr_eval", fr_poly.evaluate(p, xs),
                 fr_poly._eval_plain(p, xs), f"{m} values, {pts} points")
    m = (fr_poly._eval_blocks(1 << 40, cuda) + 1) * tile + 5
    p = rand(m)
    xs = [r - 1, pyrng.randrange(r)]
    same("fr_eval", fr_poly.evaluate(p, xs), fr_poly._eval_plain(p, xs),
         f"{m} values (a block's two tiles), 2 points")
    p = words([r - 1]).repeat(3 * tile + 1, 1)
    xs = [r - 1, r - 2] + [pyrng.randrange(r) for _ in range(6)]
    same("fr_eval", fr_poly.evaluate(p, xs), fr_poly._eval_plain(p, xs),
         "every coefficient r - 1, 8 points")
    lb = fr_poly._lb_tile(1)
    for m in (1, lb - 1, lb, lb + 1, 3 * lb - 7, 513 * lb + 3):
        p = rand(m)
        init = pyrng.randrange(r)
        for ex in (False, True):
            for rev in (False, True):
                same("fr_scan_mul", fr_poly.scan_mul(p, ex, init,
                                                     reverse=rev),
                     fr_poly._scan_mul_plain(p, ex, init, None, rev),
                     f"look-back, {m} values, exclusive {ex}, reverse {rev}")
    for m in (1, 2, 3, 255, 256, 257, 4097, (1 << 20) + 3):
        one = words([pyrng.randrange(r)])
        init = pyrng.randrange(r)
        for ex in (False, True):
            same("fr_scan_mul", fr_poly.scan_mul(one, ex, init, n=m),
                 fr_poly._scan_mul_plain(one, ex, init, m),
                 f"{m} repeated (2^{fr_poly._pow_split(m)[0]} low powers), "
                 f"exclusive {ex}")
    m = 10 * n + 41
    xv, init = pyrng.randrange(r), pyrng.randrange(r)
    lo_bits = fr_poly._pow_split(m)[0]
    at = [0, 1, (1 << lo_bits) - 1, 1 << lo_bits, m // 2, m - 1] + [
        pyrng.randrange(m) for _ in range(4)]
    got = fr_poly.scan_mul(words([xv]), True, init, n=m)
    same("fr_scan_mul", from_words(got[at]),
         [init * pow(xv, i, r) % r for i in at],
         f"{m} repeated (tau^i's length), 10 positions against the host")
    del p, got
    torch.cuda.empty_cache()
    # -- the look-back kernel (k <= LIN_MAX_K) at its edges: m < k, one
    # tile, a ragged last tile, a few tiles; c = 1 (additions) and not ---
    for k in (1, 3, 4, 8):
        tile = fr_poly._lb_tile(k)
        for m in sorted({max(1, k - 1), tile, tile + 5, 3 * tile - 7}):
            p = rand(m + k)
            for c in (1, pyrng.randrange(2, r)):
                q, rem = fr_poly.div_binomial(p, k, c)
                pq, pr = fr_poly._div_binomial_plain(p, k, c)
                same("fr_div_binomial", q, pq, f"look-back, {m} values, "
                     f"k = {k}, c = 1: {c == 1}")
                same("fr_div_binomial", rem, pr, f"look-back remainder, "
                     f"{m} values, k = {k}")
    # ~10^5 tiles, so the look-back runs deep: p = q (X^k - c) + r at
    # random points (a carry wrong anywhere changes q(x))
    for k, c, tiles in ((1, pyrng.randrange(2, r), LOOKBACK_DEEP_TILES),
                        (4, 1, LOOKBACK_DEEP_TILES // 5)):
        m = tiles * fr_poly._lb_tile(k) - 5
        p = rand(m + k)
        q, rem = fr_poly.div_binomial(p, k, c)
        xs = [pyrng.randrange(r) for _ in range(2)]
        same("fr_div_binomial", [_division_holds(p, q, rem, k, c, xs)],
             [True], f"the look-back over {tiles} tiles, k = {k}")
        print(f"fflonk kernels: the look-back over {tiles} tiles (k = {k}, "
              f"c = 1: {c == 1}): p = q (X^k - c) + r at 2 random points",
              flush=True)
        del p, q
        torch.cuda.empty_cache()

    # -- PLAIN_SAMPLE rows at each devnet use, the plain version timed ----
    m = PLAIN_SAMPLE
    p = rand(m)
    y = pyrng.randrange(r)
    got, ms = _timed(torch, lambda: fr_poly._eval_plain(p, [y, y * 7 % r]))
    same("fr_eval", fr_poly.evaluate(p, [y, y * 7 % r]), got,
         f"{m} values, 2 points")
    plain_ms["fr_eval"] = ms
    (pq, pr), ms = _timed(torch, lambda: fr_poly._div_binomial_plain(p, 1, y))
    q, rem = fr_poly.div_binomial(p, 1, y)
    same("fr_div_binomial", q, pq, f"{m} values by X - y")
    same("fr_div_binomial", rem, pr, f"{m} values by X - y")
    plain_ms["fr_div_binomial"] = ms
    # T2 and T0 by X^n - 1 (8n, 4n at a 2^17 and 2^18 domain), T1 by
    # X - 1, the root sets by X^8 - c, X^4 - c, X^3 - c
    for k, c, what in ((1 << 17, 1, "X^n - 1 (T2)"),
                       (1 << 18, 1, "X^n - 1 (T0)"), (1, 1, "X - 1 (T1)"),
                       (8, y, "X^8 - c (C0)"), (4, y, "X^4 - c (C1)"),
                       (3, y, "X^3 - c (C2)")):
        pq, pr = fr_poly._div_binomial_plain(p, k, c)
        q, rem = fr_poly.div_binomial(p, k, c)
        same("fr_div_binomial", q, pq, f"{m} values by {what}")
        same("fr_div_binomial", rem, pr, f"{m} values by {what}")
    ref, ms = _timed(torch, lambda: fr_poly._scan_mul_plain(p, False, 1,
                                                            None))
    same("fr_scan_mul", fr_poly.scan_mul(p), ref, f"{m} values")
    plain_ms["fr_scan_mul"] = ms
    same("fr_scan_mul", fr_poly.scan_mul(p[5:6], True, n=m),
         fr_poly._scan_mul_plain(p[5:6], True, 1, m), f"{m} powers")
    w = ntt_fr.root_of_unity(20)
    ins = [rand(m) for _ in range(7)]
    bg = [pyrng.randrange(r), pyrng.randrange(r)]
    ref, ms = _timed(torch, lambda: fr_poly._pointwise_plain(
        "perm_t2", ins, bg, w, 8))
    same("fr_pointwise", fr_poly.pointwise("perm_t2", ins, bg, w, 8), ref,
         f"perm_t2 at {m}")
    plain_ms["fr_pointwise"] = ms
    for g, f in zip(fr_poly.pointwise("perm_z", ins[:6], bg, w),
                    fr_poly._pointwise_plain("perm_z", ins[:6], bg, w, 0)):
        same("fr_pointwise", g, f, f"perm_z at {m}")
    ins += [rand(m) for _ in range(2)]
    same("fr_pointwise", fr_poly.pointwise("gate", ins),
         fr_poly._pointwise_plain("gate", ins, [], 1, 0), f"the gate at {m}")
    lens = [ins[j][:m - 8 * j] for j in range(4)]
    ks = [pyrng.randrange(r) for _ in range(4)]
    same("fr_pointwise", fr_poly.pointwise("lincomb", lens, ks),
         fr_poly._pointwise_plain("lincomb", lens, ks, 1, 0),
         f"a 4-input lincomb (L) at {m} to {m - 24} values")
    same("fr_pointwise", fr_poly.pointwise("lincomb", lens[1:], ks[1:]),
         fr_poly._pointwise_plain("lincomb", lens[1:], ks[1:], 1, 0),
         f"a 3-input lincomb (W) at {m - 8} to {m - 24} values")
    same("fr_pointwise", fr_poly.pointwise("lincomb", ins[:1], ks[:1]),
         fr_poly._pointwise_plain("lincomb", ins[:1], ks[:1], 1, 0),
         f"T1's scale at {m}")
    same("fr_pointwise", fr_poly.pointwise("mul", ins[:2], ks[:1]),
         fr_poly._pointwise_plain("mul", ins[:2], ks[:1], 1, 0),
         f"z's product at {m}")
    del p, q, rem, pq, pr, ref, ins, lens
    fr_poly._domain_tables.cache_clear()
    torch.cuda.empty_cache()

    marks.append(time.perf_counter())
    # -- fr_ntt at 2^26 and 2^27 ------------------------------------------
    for bits in (26, 27):
        x = rand(1 << bits)
        f, ms = _timed(torch, lambda: ntt_fr.ntt(x))
        back = ntt_fr.ntt(f, inverse=True)
        _require(torch.equal(back, x), f"fr_ntt round trip at 2^{bits}")
        del back
        wb = ntt_fr.root_of_unity(bits)
        at = [0, 1, 2, 3, (1 << bits) - 1, (1 << (bits - 1)) + 7,
              pyrng.randrange(1 << bits), pyrng.randrange(1 << bits)]
        vals = fr_poly.evaluate(x, [pow(wb, j, r) for j in at])
        _require(from_words(f[at]) == vals, f"fr_ntt at 2^{bits} equals "
                 "the polynomial's values (fr_eval) at 8 positions")
        sparse = torch.zeros_like(x)
        terms = {0: 5, 3: r - 1, (1 << bits) - 2: pyrng.randrange(r)}
        for i, v in terms.items():
            sparse[i] = words([v])[0]
        fs = ntt_fr.ntt(sparse)
        host = [sum(v * pow(wb, i * j, r) for i, v in terms.items()) % r
                for j in at]
        _require(from_words(fs[at]) == host, f"fr_ntt at 2^{bits} equals "
                 "the host's sums of a 3-term input at 8 positions")
        print(f"fflonk kernels: fr_ntt at 2^{bits}: round trip, 8 positions "
              f"vs fr_eval and vs the host; forward {ms:.3f} ms "
              f"({len(ntt_fr._passes(bits))} passes)", flush=True)
        del x, f, sparse, fs
        ntt_fr._kernel_twiddles.cache_clear()
        torch.cuda.empty_cache()

    marks.append(time.perf_counter())
    # -- timed at the devnet root's shapes (inputs are slices of one
    # random buffer, 2^22 rows apart, so no two share a cache line) ------
    gap = 1 << 22
    big = rand(max(10 * n + 41, 6 * gap + 8 * n, 8 * gap + 4 * n,
                   3 * gap + 9 * n + 21))

    def sl(j, m):
        return big[j * gap:j * gap + m]

    shapes = {k: [] for k in FFLONK_KERNELS}
    rows_calls = collections.Counter()

    def timed(name, fn, work, shape, what, per_wrap):
        with fr_poly_calls() as made:
            fn()
        _require(len(made) == 1, f"{name} ({what}) is one call")
        rows_calls.update({made[0]: per_wrap})
        ms = _cuda_ms(fn, 2)
        bound, by = min(_bound_ms(w, int_rate) for w in
                        (work if isinstance(work, list) else [work]))
        shapes[name].append({"shape": shape, "what": what, "ms": ms,
                             "bound_ms": bound, "bound_by": by,
                             "per_wrap": per_wrap})
        print(f"kernel {name} ({what}) at {shape}: {ms:.4f} ms (bound "
              f"{bound:.4f} ms by {by}; {per_wrap} a wrap)", flush=True)

    y = pyrng.randrange(r)
    ks = [pyrng.randrange(r) for _ in range(4)]
    for name, what, m, fn, work, per in fflonk_wrap_calls(
            fr_poly, ntt_fr, n, sl, y, ks):
        timed(name, fn, work, [m, 4], what, per)
    made = collections.Counter(wrap_calls)
    _require(+rows_calls == made, "the timed rows, with their launches a "
             "wrap, are the calls of (c)'s setup and proof (only in the "
             f"rows: {sorted((+rows_calls - made).items())}; only in (c): "
             f"{sorted((made - rows_calls).items())})")
    marks.append(time.perf_counter())
    print("fflonk kernels: seconds of the checks, fr_ntt, the timing: "
          + ", ".join(f"{b - a:.2f}" for a, b in zip(marks, marks[1:])),
          flush=True)
    loss = {name: sum(e["per_wrap"] * (e["ms"] - e["bound_ms"])
                      for e in shapes[name]) for name in FFLONK_KERNELS}
    print("fflonk kernels: launches x (ms - bound) a wrap, ms: "
          + json.dumps(loss), flush=True)
    del big
    fr_poly._domain_tables.cache_clear()
    torch.cuda.empty_cache()
    rows = []
    replaces = {"fr_eval": "xlayer_prover_tpu/snark/fflonk.py:88",
                "fr_div_binomial": "xlayer_prover_tpu/snark/fflonk.py:95",
                "fr_scan_mul": "xlayer_prover_tpu/snark/fflonk.py:210",
                "fr_pointwise": "xlayer_prover_tpu/snark/fflonk.py:307"}
    for name in FFLONK_KERNELS:
        main, *more = shapes[name]
        rows.append({"name": name, "route": "cuda", "source": FFLONK_SOURCE,
                     "replaces": replaces[name], "max_abs_err": err[name],
                     "ms": main["ms"], "plain_ms": plain_ms[name],
                     "bound_ms": main["bound_ms"],
                     "bound_by": main["bound_by"], "library_ms": None,
                     "shape": main["shape"],
                     "plain_shape": [PLAIN_SAMPLE, 4],
                     "more_shapes": more, "launches_path": "fflonk"})
    return rows


def _fflonk_case(path: str):
    with open(path) as f:
        return json.load(f)


def phase_fflonk_fixture(torch) -> dict:
    """Phase 13 (b): the seeded R1CS of FFLONK_FIXTURE (its seed, its
    constraint count) through r1cs_to_arrays, setup and prove with
    random.Random(its rng seed) on the card: the keys (vk points, the
    proving key's parts by digest) and the proof (c1, c2, w, w2, the 15
    evaluations) equal to the JAX package's file; the proof verifies."""
    import random

    from xlayer_prover_tpu_torch.snark import fflonk, plonk

    case = _fflonk_case(FFLONK_FIXTURE)
    r1cs, witness = plonk.seeded_r1cs(case["seed"], case["constraints"])
    arr = plonk.r1cs_to_arrays(r1cs, witness)
    _require(arr.n == case["n"], "the seeded circuit's domain is the file's")
    publics = witness[1:1 + r1cs.n_public]
    rng = random.Random(case["rng_seed"])
    t0 = time.perf_counter()
    pk, vk = fflonk.setup(arr, rng=rng)
    proof = fflonk.prove(pk, arr, publics, rng=rng)
    prove_s = time.perf_counter() - t0
    got = fflonk.to_json(vk, proof, publics)
    got["pk_sha256"] = fflonk.key_digests(fflonk.key_to_host(pk))
    for key in ("vk", "proof", "publics", "pk_sha256"):
        _require(got[key] == case[key], f"the fixture's fflonk {key} on the "
                 "card equals the JAX package's "
                 f"({os.path.relpath(FFLONK_FIXTURE, REPO)})")
    _require(fflonk.verify(vk, proof, publics), "the fixture proof verifies")
    print(f"fflonk fixture: n = {arr.n}, {arr.n_gates} gates, keys and proof "
          f"equal to {os.path.relpath(FFLONK_FIXTURE, REPO)} "
          f"({prove_s:.3f} s setup + prove), verified", flush=True)
    return {"n": arr.n, "gates": arr.n_gates, "setup_prove_s": prove_s}


def phase_fflonk(torch, r1cs, witness) -> tuple[dict, dict, int, list]:
    """Phase 13 (c): the devnet root's final circuit (phase 8's R1CS and
    witness, kept from the cascade's finalize) under fflonk, launches
    counted from 0 and the peak reset first: r1cs_to_arrays (one pass,
    with the witness), setup and prove with random.Random(FFLONK_RNG),
    verify; a proof with its z evaluation changed and the proof with a
    changed public refused.  -> (launches, the "fflonk" line's report, n,
    fr_poly_calls of setup and prove)"""
    import dataclasses
    import random

    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.fields.bn254 import R as r
    from xlayer_prover_tpu_torch.snark import fflonk, plonk

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    arr = plonk.r1cs_to_arrays(r1cs, witness)
    plonk_s = time.perf_counter() - t0
    publics = witness[1:1 + r1cs.n_public]
    print(f"fflonk: {len(r1cs.constraints)} constraints -> {arr.n_gates} "
          f"gates, n = {arr.n}, {arr.n_wires} wires, SRS {10 * arr.n + 41} "
          f"points ({plonk_s:.3f} s)", flush=True)
    rng = random.Random(FFLONK_RNG)
    setup_t, prove_t = {}, {}
    with fr_poly_calls() as wrap_calls:
        t0 = time.perf_counter()
        pk, vk = fflonk.setup(arr, rng=rng, timings=setup_t)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated()
        print(f"fflonk: setup {setup_s:.3f} s {json.dumps(setup_t)}, peak "
              f"{setup_peak} B", flush=True)
        t0 = time.perf_counter()
        proof = fflonk.prove(pk, arr, publics, rng=rng,
                             timings=prove_t)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    made = collections.Counter(c[0] for c in wrap_calls)
    _require(all(made[k] == launches[k] for k in FFLONK_KERNELS),
             "each fr_poly call of the wrap launched its kernel once "
             f"({dict(made)})")
    peak = torch.cuda.max_memory_allocated()
    gates = arr.n_gates
    del pk, arr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _require(fflonk.verify(vk, proof, publics), "the devnet root's fflonk "
             "proof verifies")
    verify_s = time.perf_counter() - t0
    bad = dict(proof.evals)
    bad["z"] = (bad["z"] + 1) % r
    _require(not fflonk.verify(vk, dataclasses.replace(proof, evals=bad),
                               publics),
             "the fflonk proof with its z evaluation changed is refused")
    changed = list(publics)
    changed[4 + NEW_STATE_ROOT] = (changed[4 + NEW_STATE_ROOT] + 1) % r
    _require(not fflonk.verify(vk, proof, changed),
             "the fflonk proof with a changed public is refused")
    report = {"card": device.smi("name,power.limit"),
              "constraints": len(r1cs.constraints), "gates": gates,
              "n": vk.n, "srs_points": 10 * vk.n + 41, "plonk_s": plonk_s,
              "setup_s": setup_s, "setup_timings_s": setup_t,
              "prove_s": prove_s, "prove_timings_s": prove_t,
              "verify_s": verify_s, "setup_peak_bytes": setup_peak,
              "peak_bytes": peak, "host_peak_rss_bytes": _host_peak_rss(),
              "launches": {k: v for k, v in launches.items() if v},
              "proof": fflonk.to_json(vk, proof, publics)["proof"]}
    print("fflonk: the devnet root's proof verifies; a changed z evaluation "
          "and a changed public refused", flush=True)
    return launches, report, vk.n, wrap_calls


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "xlayer_prover_tpu_torch")):
        print("chip_smoke: the xlayer_prover_tpu_torch package is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.models.zkevm import binary_sm

    t_all = time.perf_counter()
    print(device.smi("name,power.limit"), flush=True)
    # phase 12 (c)'s host work (the 2^20 AIR and its constants) runs
    # while nvcc builds the kernels, and is joined before phase 2 times
    # anything
    prep: dict = {}
    shadow = threading.Thread(target=prepare_2e20, args=(prep,))
    shadow.start()
    t0 = time.perf_counter()
    try:
        print_ptxas(kernels.build_all())
    finally:
        shadow.join()
    print(f"build_s {time.perf_counter() - t0:.2f} (with phase 12 (c)'s "
          f"AIR {prep.get('build_s', 0):.2f} s and constants "
          f"{prep.get('fixed_s', 0):.2f} s beside it)", flush=True)

    phase_s = {}
    marks = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - marks[0]
        marks[0] = now
        print(f"phase_s {name} {phase_s[name]:.2f}", flush=True)

    t0 = time.perf_counter()
    case = binary_sm.seeded_case()
    trace_s = time.perf_counter() - t0
    air = case[0]
    rng = np.random.default_rng(SEED)
    # gl_mul is timed at one butterfly stage of the cm1 LDE
    parts = [time.perf_counter()]
    rows = phase_kernels(torch, rng,
                         (1 << (air.n_bits_ext - 1)) * air.cm1_width)
    parts.append(time.perf_counter())
    rows += phase_bn254_kernels(torch, rng)
    parts.append(time.perf_counter())
    rows += phase_g16_kernels(torch, rng)
    parts.append(time.perf_counter())
    print("phase 2 by part, s: " + json.dumps(dict(zip(
        ("goldilocks", "poseidon_bn254", "groth16"),
        (b - a for a, b in zip(parts, parts[1:]))))), flush=True)
    mark("2_kernels")
    phase_fib(torch)
    by_path = {"binary_sm_2e20": phase_binary(torch, case, trace_s)}
    del case
    mark("3_4_fib_binary")
    by_path["zkevm_2e13"] = phase_zkevm(torch)
    mark("5_zkevm")
    by_path["cascade"], cas, calls, cascade_report = phase_cascade(torch)
    for group, stages in cascade_groups().items():
        by_path[group] = _stage_launches(cas.record, stages)
    mark("6_cascade")
    phase_batches(torch, cas)
    at_rec1 = phase_recursion(torch, cas)
    at_final = phase_final(torch, cas, calls)
    final_r1cs = cas.stack.final_circuit
    del cas
    mark("7_8_checks")
    fixture = phase_fflonk_fixture(torch)
    by_path["fflonk"], fflonk_report, fflonk_n, wrap_calls = phase_fflonk(
        torch, *final_r1cs)
    del final_r1cs
    fflonk_report["fixture"] = fixture
    rows += phase_fflonk_kernels(torch, fflonk_n, wrap_calls)
    mark("13_fflonk")
    by_path["service_fib"] = phase_service(torch)
    mark("9_service")
    by_path["chains_2e18"], chains = phase_chains(torch)
    mark("10_chains")
    by_path["entry_2e16"] = phase_entry(torch)
    mark("11_entry")
    capacity_shapes = phase_stream_kernels(torch, rng)
    by_path["stream_2e18"] = phase_stream_2e18(torch, chains)
    del chains
    mark("12ab_stream_2e18")
    by_path["chains_2e20"] = phase_stream_2e20(torch, prep)
    del prep
    mark("12c_chains_2e20")
    for path, launches in by_path.items():
        for name in PATH_KERNELS.get(path, STAGE_KERNELS.get(path)):
            _require(launches.get(name, 0) > 0, f"{name} launched on the "
                     f"{path} path")
    for r in rows:
        r["launches"] = by_path[r.pop("launches_path", "cascade")][r["name"]]
        r["launches_by_path"] = {p: v.get(r["name"], 0)
                                 for p, v in by_path.items()}
        r["at_recursion_shape"] = at_rec1.get(r["name"])
        r["at_final_shape"] = at_final.get(r["name"])
        if r["name"] == "poseidon_linear_hash":
            r["more_shapes"] += capacity_shapes
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "plain_shape", "more_shapes", "launches_by_path",
            "at_recursion_shape", "at_final_shape"]
    print("cascade " + json.dumps(cascade_report), flush=True)
    print("fflonk " + json.dumps(fflonk_report), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(f"total_s {time.perf_counter() - t_all:.2f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
