#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xlayer_prover_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full run: builds the kernels, proves
                                     # the 2^20-row Binary SM AIR, the
                                     # mini-ROM's zkEVM composite AIR at
                                     # 2^13 rows, devnet batch 0 through
                                     # the fork_9 ROM at 2^16 rows, and
                                     # lifts and aggregates devnet batch
                                     # proofs through the recursion stack
                                     # at 2^18 rows, and wraps the root in
                                     # RecursiveF and Groth16

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
  6. devnet, the main path of a real batch: devnet batch 0 (a signed
     EIP-155 transfer, ``utils/devnet.build_devnet_inputs``) through
     ``BatchProver`` over the fork_9 ROM with the Storage and ClimbKey SMs
     (519 committed columns) at 2^16 rows (chunk_bits 4, limb_bits 16, 4
     queries): execute_only, setup(), prove (launches counted from 0).
     The proof must be byte-equal to the JAX package's,
     a7_state_devnet/batch_proof_0vdev0_nb16_q4.json, and verify; a forged
     sRD value in the trace and a wrong new-state-root public must both be
     refused.  Before it, phase 2's kernels are held bit for bit at its
     shapes (the cm1 leaves, 2^17 x 519; an LDE stage, 2^16 x 519);
  7. recursion, the main path of this slice: ``RecursionStack`` over
     phase 6's devnet AIR and verkey (4 queries, the zkEVM chain link)
     builds the recursive1/recursive2 pair of gate AIRs at 2^18 rows
     (launches counted from 0), then (a) lifts the committed batch proof 0
     to recursive1, (b) aggregates the committed recursive1_0 and
     recursive1_1 (the chain link binds), (c) aggregates the committed
     aggregate_01 and aggregate_23 (the non-leaf branch).  Each proof must
     be byte-equal to its file in a7_state_devnet/ and verify (the root
     through ``finalize(wrap="stark")``).  (d) A batch proof with a root
     limb moved by one and a pair in the wrong order must raise ValueError
     at witness time, and the root with a payload public changed must be
     refused by the verifier.  Then the kernels are held bit for bit at
     its shapes (the recursive1 cm1 leaves, 2^19 x 60; an LDE stage,
     2^18 x 60);
  8. the final stage, the main path of this slice:
     ``stack.finalize(root, wrap="groth16", snark=True,
     rng=random.Random(11))`` over phase 7's aggregate root, the JAX
     cascade's own call, builds RecursiveF (recursive1 over the BN128
     commitment scheme: Poseidon-BN254 arity-16 trees, TranscriptBN128)
     over recursive2, proves it, builds the BN254 final circuit's R1CS and
     proves that with Groth16 (setup with the fixed-base kernels, h with
     the Fr NTT, the G1 and G2 MSMs; launches counted from 0).  The
     RecursiveF proof must be byte-equal to the JAX package's, committed
     as tests/data/recF_devnet_root_q4.proof.json, and verify; the proof
     with one Fr root moved and with a payload public changed must be
     refused.  The Groth16 proof's verification_key.json, proof.json and
     public.json (written by the port's snarkjs_io into build/) must be
     byte-equal to tests/data/g16_devnet_root_r11/, be accepted from the
     files alone, and be refused with a changed public; its publics are
     the 52 ``groth16_publics`` of PROOF_a7_cascade_devnet.json.  Then the
     Poseidon-BN254 kernels are held bit for bit at its shapes (the cm1,
     cm3, const and cm4 leaves and the first tree level), and each shape
     the stage launched them at (recorded around the wrappers, written to
     build/poseidon_bn254_final_shapes.json) is timed again: their time in
     the stage, summed by shape.
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
points across 64 chunks; 10-bit windows) against the plain version and
the step-by-step model ``_msm_model``, and on the 2^20 points they are
timed on (16-bit windows, as on the main path) with all but 8,212
scalars set to 0, each MSM's stages timed at 2^20 with CUDA events,
fr_ntt either side of each pass boundary (2^0 .. 2^3, 2^7, 2^10 .. 2^12,
2^22, 2^23: one, two and three passes), on edge values, the round trip,
and at phase 8's three shapes (a 2^20 inverse, the 2^21 forward and
inverse), each timed, with its device launches a call (counted by the
library at each launch);
its twiddle tables built on the card (fr_ntt_twiddles, timed) equal to
the host-built ones, their cold build timed on the host; fr_mul_sub at
2^21 with edge values; each timed at the devnet root's shapes (2^20
scalars and points, 2^21 values).  Phase 8 builds its twiddle tables
anew and prints h's split (g16_h_eval_s, g16_h_ntt_s).
It prints a ``{"kernels": [...]}`` line (``launches``: the count on the
final path, this slice's main path, 0 included; ``launches_by_path`` has
every path's) and ends with
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
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
# the kernels that every Setup.build + gen_proof of a path launches
GL_PATH_KERNELS = ("poseidon_linear_hash", "gl_mul")
G16_KERNELS = ("bn254_msm_g1", "bn254_msm_g2", "bn254_fixed_base_g1",
               "bn254_fixed_base_g2", "fr_ntt", "fr_ntt_twiddles",
               "fr_mul_sub")
PATH_KERNELS = {"binary_sm_2e20": GL_PATH_KERNELS,
                "zkevm_2e13": GL_PATH_KERNELS,
                "devnet_2e16": GL_PATH_KERNELS,
                "recursion_2e18": GL_PATH_KERNELS,
                "final_2e16": ("poseidon_bn254_leaf_hash",
                               "poseidon_bn254_permute", "gl_mul",
                               *G16_KERNELS)}
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
DEVNET_FIXTURE = os.path.join(REPO, "a7_state_devnet",
                              "batch_proof_0vdev0_nb16_q4.json")
NEW_STATE_ROOT = 19                # publics[19:27]: newStateRoot limbs
A7 = os.path.join(REPO, "a7_state_devnet")


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
    ref = poseidon_gl._permute_plain(t)
    torch.cuda.synchronize()
    err = _max_abs_err(got, ref)
    _require(err == 0, "poseidon_permute equals its plain version")
    del got, ref
    ms = _cuda_ms(lambda: poseidon_gl.permute(t), 20)
    plain_ms = _cuda_ms(lambda: poseidon_gl._permute_plain(t), 2)
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
    level_ms = _cuda_ms(lambda: poseidon_gl.linear_hash(level, 8), 20)
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
    ms = _cuda_ms(lambda: gl.gl_mul(ta, tb), 50)
    plain_ms = _cuda_ms(lambda: gl._mul_plain(ta, tb), 3)
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
    err = max(err, _max_abs_err(pbn.permute(head, 17),
                                pbn._permute_plain(head, 17)))
    level = x[:8192]
    err = max(err, _max_abs_err(pbn.permute(level, 17),
                                pbn._permute_plain(level, 17)))
    _require(err == 0, "poseidon_bn254_permute equals its plain version")
    ms = _cuda_ms(lambda: pbn.permute(x, 17), 3)
    level_ms = _cuda_ms(lambda: pbn.permute(level, 17), 5)
    level_bound, _ = _bound_ms(bn254_permute_work(8192), int_rate)
    print(f"kernel poseidon_bn254_permute at [8192, 17, 4] (a 2^17-leaf "
          f"tree's first level): {level_ms:.4f} ms (bound "
          f"{level_bound:.4f} ms)", flush=True)
    plain_ms = _cuda_ms(lambda: pbn._permute_plain(head, 17), 1)
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
    ms = _cuda_ms(lambda: pbn.leaf_hash(leaves, width), 3)
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
    sc = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
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
        big_sc = words([int.from_bytes(rng.bytes(32), "little") % r
                        for _ in range(big)])
        ms = _cuda_ms(lambda: fn(gen, big_sc), 2)
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
    # version and the step-by-step model; then the timed 2^20 inputs
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
                model = bn254_msm._msm_model(ops, pts, sc)
                _require(_flat(affine(model)) == a, f"bn254_msm_{group} at "
                         f"{n} points equals the step-by-step model")
                print(f"bn254_msm_{group} at {n}: equal to _msm_plain and "
                      f"_msm_model in affine; Jacobian bit-equal to the "
                      f"model: {torch.equal(got, model)}", flush=True)
        _require(affine(fn(pts, torch.zeros_like(sc))) is None,
                 f"bn254_msm_{group} of zero scalars is infinity")
        ms = _cuda_ms(lambda: fn(pts, sc), 3)
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

    # -- the Fr NTT: the twiddle tables expanded on the card against the
    # host-built ones (the 2^21 forward's timed); the kernel bit-equal to
    # its plain version either side of each pass boundary (2^11 values a
    # block: one pass to 2^11, two to 2^22, three beyond), on edge values,
    # the round trip, and at phase 8's three shapes, each timed; the
    # device launches of one call counted by the library ---------------
    err = 0
    tw_rows, table_s = [], {}
    for bits in (0, 1, 2, 3, 7, 10, 11, 12, 22, 23):
        if bits <= 12:                         # uniform below r
            x = words([int.from_bytes(rng.bytes(32), "little") % r
                       for _ in range(1 << bits)])
        else:
            # in bulk: words 0-2 take every 64-bit value, word 3 is
            # below 2^60, so the value is below 2^252 < r
            x = rng.integers(-(1 << 63), 1 << 63, size=(1 << bits, 4),
                             dtype="int64")
            x[:, 3] &= (1 << 60) - 1
            x = torch.from_numpy(x).to(cuda)
        x0 = x.clone()
        for inverse in (False, True):
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
        want = words(v * bn254_mont.MONT % r
                     for v in ntt_fr._powers(bits, inverse))
        _require(torch.equal(table, want), f"the 2^{bits} twiddle table "
                 "built on the card equals the host-built one")
        if (bits, inverse) == (21, False):
            lo, hi = (words(p) for p in ntt_fr._host_twiddle_parts(
                bits, inverse))
            ref, plain_ms = _timed(torch, lambda: ntt_fr
                                   ._expand_twiddles_plain(lo, hi))
            tw_err = _max_abs_err(ntt_fr.expand_twiddles(lo, hi), ref)
            _require(tw_err == 0, "fr_ntt_twiddles equals its plain "
                     "version")
            ms = _cuda_ms(lambda: ntt_fr.expand_twiddles(lo, hi), 20)
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
        del table, want
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
        k_ms = _cuda_ms(lambda: ntt_fr.ntt(vals, inverse), 10)
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
    ms = _cuda_ms(lambda: ntt_fr.mul_sub(x, y, z), 20)
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
    timed.  -> {kernel: {"shape", "ms", "bound_ms"}}"""
    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.ops import poseidon_gl

    cuda = torch.device("cuda")
    width = air.cm1_width
    leaves = torch.randint(-(1 << 63), (1 << 63) - 1, (air.n_ext, width),
                           dtype=torch.int64, device=cuda)
    err = _max_abs_err(poseidon_gl.linear_hash(leaves, width),
                       poseidon_gl._linear_hash_plain(leaves, width))
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


def phase_devnet(torch):
    import numpy as np

    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.stark import prover, verifier
    from xlayer_prover_tpu_torch.utils import devnet

    t0 = time.perf_counter()
    engine = devnet.devnet_prover()
    inp = devnet.build_devnet_inputs(engine, 1)[0]
    res = engine.execute_only(inp)
    trace_s = time.perf_counter() - t0
    air, layout, ctx = engine.air, engine.executor.layout, res.ctx
    _require(ctx.done and ctx.counters.steps == 6589
             and len(ctx.required.storage) > 0 and ctx.ec_memo_hits > 0,
             "devnet batch 0: 6,589 steps, storage actions, the ECRecover "
             "precalc served")
    print(f"devnet: n_bits={air.n_bits} cm1={air.cm1_width} const="
          f"{air.const_width} cm2={air.cm2_width} cm3={air.cm3_width} "
          f"q_deg={air.q_deg} plookups={len(air.plookups)} permutations="
          f"{len(air.permutations)} constraints={len(air.constraints)} "
          f"ev_map={len(air.ev_map)} fri_steps={air.fri_steps} steps="
          f"{ctx.counters.steps} storage_actions={len(ctx.required.storage)}"
          f" trace_s={trace_s:.3f}", flush=True)
    check_shapes(torch, air, "devnet")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    setup = engine.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timings = {}
    t0 = time.perf_counter()
    proof = engine.prove_from_trace(res.cm1_np, res.publics, timings=timings)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _require(setup.const_ext.is_cuda, "the devnet setup lives on the card")

    with open(DEVNET_FIXTURE) as f:
        _require(proof.to_json() == json.load(f)["proof"],
                 "the devnet batch 0 proof on the card is byte-equal to "
                 "the JAX package's")
    t0 = time.perf_counter()
    _require(verifier.verify(air, setup.verkey, proof),
             "the devnet batch 0 proof verifies")
    verify_s = time.perf_counter() - t0
    print(f"devnet: proof byte-equal to "
          f"{os.path.relpath(DEVNET_FIXTURE, REPO)}, verifies", flush=True)

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
    print(device.smi("name,power.limit"), flush=True)
    report = {"n_bits": air.n_bits, "rows": air.n, "trace_s": trace_s,
              "setup_s": setup_s, "prove_s": prove_s,
              "rounds_s": timings, "verify_s": verify_s,
              "rows_per_s": air.n / prove_s, "peak_bytes": peak,
              "launches": launches}
    print("devnet " + json.dumps(report), flush=True)
    return launches, engine


def _read_a7(name: str) -> str:
    with open(os.path.join(A7, f"{name}_nb16_q4.json")) as f:
        return f.read()


def phase_recursion(torch, engine):
    """Recursion over devnet batch 0: the pair of gate AIRs, three proofs
    byte-equal to the committed cascade, three refusals; launches counted
    from 0 over the pair build and the three proofs."""
    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.recursion import gate_air
    from xlayer_prover_tpu_torch.recursion.stack import (RecursionStack,
                                                         RecursiveProof,
                                                         zkevm_chain_spec)
    from xlayer_prover_tpu_torch.stark import verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof

    air = engine.air
    link, out_map = zkevm_chain_spec(air.n_publics)
    with open(DEVNET_FIXTURE) as f:
        batch = StarkProof.from_json(json.load(f)["proof"])
    committed = {name: _read_a7(name) for name in (
        "recursive1_0", "recursive1_1", "aggregate_01", "aggregate_23",
        "aggregate_root")}
    loaded = {k: RecursiveProof.from_json(v) for k, v in committed.items()}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    stack = RecursionStack(air, engine.setup().verkey, n_queries=4,
                           link=link, out_map=out_map)
    t0 = time.perf_counter()
    rec1, rec2 = stack.rec1(), stack.rec2()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for name, eng in (("rec1", rec1), ("rec2", rec2)):
        g = eng.air
        print(f"recursion {name}: n_bits={g.n_bits} cm1={g.cm1_width} "
              f"cm3={g.cm3_width} const={g.const_width} publics="
              f"{g.n_publics} constraints={len(g.constraints)} ev_map="
              f"{len(g.ev_map)} fri_steps={g.fri_steps} rows_used="
              f"{eng.layout.n_rows_used} {eng.tracer.stats()}", flush=True)

    proofs, timings = {}, {}

    def stage(name, fn, fixture):
        t = {}
        t0 = time.perf_counter()
        rp = fn(t)
        torch.cuda.synchronize()
        t["total_s"] = time.perf_counter() - t0
        _require(json.dumps(rp.to_json()) == committed[fixture],
                 f"the {name} proof on the card is byte-equal to "
                 f"a7_state_devnet/{fixture}_nb16_q4.json")
        t0 = time.perf_counter()
        _require(stack.verify(rp), f"the {name} proof verifies")
        t["verify_s"] = time.perf_counter() - t0
        proofs[name], timings[name] = rp, t
        print(f"recursion {name}: byte-equal to a7_state_devnet/{fixture}"
              f"_nb16_q4.json, verifies ({t['total_s']:.3f} s)", flush=True)

    stage("lift", lambda t: stack.lift(batch, t), "recursive1_0")
    stage("leaf_leaf", lambda t: stack.aggregate(
        loaded["recursive1_0"], loaded["recursive1_1"], t), "aggregate_01")
    stage("agg_agg", lambda t: stack.aggregate(
        loaded["aggregate_01"], loaded["aggregate_23"], t), "aggregate_root")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    root = proofs["agg_agg"]
    _require(stack.finalize(root, wrap="stark") is root,
             "finalize(wrap='stark') accepts the root")
    _require(root.proof.publics[:4] == rec2.verkey,
             "the root carries the recursive2 verkey")

    # (d) refusals
    def refused_at_witness(fn, what: str) -> str:
        try:
            fn()
        except ValueError as e:
            return f"ValueError ({e})"
        raise RuntimeError(f"{what} was accepted")

    bad = StarkProof.from_json(batch.to_json())
    bad.roots[0][0] = (bad.roots[0][0] + 1) % gate_air.P
    print("recursion: batch proof with a root limb moved refused: "
          + refused_at_witness(lambda: stack.lift(bad),
                               "a batch proof with a moved root limb"),
          flush=True)
    print("recursion: recursive1_1 + recursive1_0 (link broken) refused: "
          + refused_at_witness(lambda: stack.aggregate(
              loaded["recursive1_1"], loaded["recursive1_0"]),
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
    report = {"n_bits": rec1.air.n_bits, "build_s": build_s,
              "pair_s": stack.timings, "proofs_s": timings,
              "peak_bytes": peak, "launches": launches,
              "tracer_stats": {"rec1": rec1.tracer.stats(),
                               "rec2": rec2.tracer.stats()}}
    print("recursion " + json.dumps(report), flush=True)
    return launches, shapes, stack, root


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


def phase_final(torch, stack, root):
    """finalize(wrap="groth16", snark=True, rng=random.Random(11)) over the
    aggregate root, the JAX cascade's own call: RecursiveF byte-equal to
    the JAX package's and verified, two refusals; the Groth16 proof's
    snarkjs files byte-equal to the JAX package's, accepted from the files
    alone, a changed public refused; launches counted from 0 over the
    RecursiveF build, its proof, the R1CS and Groth16's setup, proof and
    verification."""
    import collections
    import filecmp
    import random

    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.ops import ntt_fr
    from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn
    from xlayer_prover_tpu_torch.snark import snarkjs_io
    from xlayer_prover_tpu_torch.stark import verifier
    from xlayer_prover_tpu_torch.stark.proof import StarkProof

    with open(RECF_FIXTURE) as f:
        fixture = f.read()
    with open(CASCADE_RECORD) as f:
        want = [int(v) for v in json.load(f)["groth16_publics"]]
    # the shapes of the Poseidon-BN254 launches, recorded around the
    # wrappers (their launch counts are untouched)
    calls = collections.Counter()
    wrapped = {name: getattr(pbn, name) for name in ("permute", "leaf_hash")}

    def recorder(name):
        def call(x, *args):
            if x.device.type == "cuda" and x.shape[0] > 0:
                calls[(name, tuple(x.shape))] += 1
            return wrapped[name](x, *args)
        return call

    # the stage builds its own Fr NTT twiddle tables, as an operator's
    # first proof does (fr_ntt_twiddles, inside g16_h_ntt_s)
    ntt_fr._kernel_twiddles.cache_clear()
    ntt_fr._host_twiddle_parts.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    timings = {}
    for name in wrapped:
        setattr(pbn, name, recorder(name))
    try:
        t0 = time.perf_counter()
        out = stack.finalize(root, wrap="groth16", snark=True,
                             rng=random.Random(11), timings=timings)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    finally:
        for name, fn in wrapped.items():
            setattr(pbn, name, fn)
    launches = dict(kernels.LAUNCHES)
    for name in wrapped:
        _require(sum(v for (k, _), v in calls.items() if k == name)
                 == launches[f"poseidon_bn254_{name}"],
                 f"every poseidon_bn254_{name} launch of the stage has its "
                 "shape recorded")
    peak = torch.cuda.max_memory_allocated()
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

    bad = StarkProof.from_json(fixture)
    bad.roots[0][0] = (bad.roots[0][0] + 1) % pbn.P
    print("final: RecursiveF proof with its cm1 root moved refused: "
          + refused(bad, "a moved Fr root"), flush=True)
    bad = StarkProof.from_json(fixture)
    bad.publics[4 + NEW_STATE_ROOT] = \
        (bad.publics[4 + NEW_STATE_ROOT] + 1) % (2 ** 64 - 2 ** 32 + 1)
    print("final: RecursiveF proof with a payload public changed refused: "
          + refused(bad, "a changed public"), flush=True)

    _require(out["final"] == "groth16" and out["publics"] == want,
             "the Groth16 publics equal the 52 groth16_publics of "
             "PROOF_a7_cascade_devnet.json")
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
    report = {"n_bits": g.n_bits, "total_s": total_s, "timings_s": timings,
              "verify_s": verify_s, "files_verify_s": files_verify_s,
              "g16_key_bytes": key_bytes, "peak_bytes": peak,
              "launches": launches,
              "poseidon_bn254_ms_by_shape": shapes.pop("by_shape"),
              "poseidon_bn254_ms": shapes.pop("by_shape_total_ms")}
    print("final " + json.dumps(report), flush=True)
    with open(BN254_SHAPES, "w") as f:
        json.dump(report["poseidon_bn254_ms_by_shape"], f)
    return launches, shapes


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
    t0 = time.perf_counter()
    print_ptxas(kernels.build_all())
    print(f"build_s {time.perf_counter() - t0:.2f}", flush=True)

    t0 = time.perf_counter()
    case = binary_sm.seeded_case()
    trace_s = time.perf_counter() - t0
    air = case[0]
    rng = np.random.default_rng(SEED)
    # gl_mul is timed at one butterfly stage of the cm1 LDE
    rows = phase_kernels(torch, rng,
                         (1 << (air.n_bits_ext - 1)) * air.cm1_width)
    rows += phase_bn254_kernels(torch, rng)
    rows += phase_g16_kernels(torch, rng)
    phase_fib(torch)
    by_path = {"binary_sm_2e20": phase_binary(torch, case, trace_s)}
    del case
    by_path["zkevm_2e13"] = phase_zkevm(torch)
    by_path["devnet_2e16"], engine = phase_devnet(torch)
    by_path["recursion_2e18"], at_rec1, stack, root = phase_recursion(
        torch, engine)
    del engine
    by_path["final_2e16"], at_final = phase_final(torch, stack, root)
    for path, launches in by_path.items():
        for name in PATH_KERNELS[path]:
            _require(launches[name] > 0, f"{name} launched on the {path} "
                     f"path")
    for r in rows:
        r["launches"] = by_path["final_2e16"][r["name"]]
        r["launches_by_path"] = {p: v[r["name"]] for p, v in by_path.items()}
        r["at_recursion_shape"] = at_rec1.get(r["name"])
        r["at_final_shape"] = at_final.get(r["name"])
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "plain_shape", "more_shapes", "launches_by_path",
            "at_recursion_shape", "at_final_shape"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(f"total_s {time.perf_counter() - t_all:.2f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
