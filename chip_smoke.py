#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xlayer_prover_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full run: builds the kernels, proves
                                     # the 2^20-row Binary SM AIR

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
     poseidon_permute is off this path; its row reports its count, 0.
It prints a ``{"kernels": [...]}`` line and ends with
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
SEED = 20261016                    # kernel inputs of phase 2
# the kernels that every Setup.build + gen_proof launches
MAIN_PATH_KERNELS = ("poseidon_linear_hash", "gl_mul")


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


def phase_kernels(torch, rng, n_ext_half_cols: int):
    """Each kernel against its plain version, bit for bit, and timed."""
    import numpy as np

    from xlayer_prover_tpu_torch import device
    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.ops import poseidon_gl

    P = gl.P
    cuda = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(device.smi("clocks.max.sm").split()[0]) * 1e6
    int_rate = sms * INT_MUL_PER_CLK_SM * clock_hz
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
        "source": "xlayer_prover_tpu_torch/csrc/gl_mul.cu",
        "replaces": "xlayer_prover_tpu/fields/gl.py:154",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bytes": 24 * n_ext_half_cols, "ops": GL_MUL_MULS * n_ext_half_cols,
        "shape": [n_ext_half_cols], "plain_shape": [n_ext_half_cols]})
    del ta, tb
    torch.cuda.empty_cache()

    for r in rows:
        t_bytes = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = r.pop("ops") / int_rate * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["library_ms"] = None
        print(f"kernel {r['name']} at {r['shape']}: {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.3f} ms at {r['plain_shape']}, "
              f"bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; int-mul rate {int_rate:.4g}/s)",
              flush=True)
    return rows


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
    try:
        tampered = prover.gen_proof(setup, bad, [])
    except prover.LookupMissingError:
        refused = "prover raised LookupMissingError"
    else:
        try:
            verifier.verify(air, setup.verkey, tampered)
        except verifier.VerifyError as e:
            refused = f"verifier raised VerifyError ({e})"
        else:
            raise RuntimeError("tampered binary trace was accepted")
    print(f"binary: tampered trace refused: {refused}", flush=True)
    report = {"n_bits": air.n_bits, "rows": air.n, "actions": len(actions),
              "trace_s": trace_s, "setup_s": setup_s, "prove_s": prove_s,
              "rounds_s": timings, "verify_s": verify_s,
              "rows_per_s": air.n / prove_s,
              "peak_bytes": peak, "launches": launches}
    print("phase4 " + json.dumps(report), flush=True)
    return launches


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
    phase_fib(torch)
    launches = phase_binary(torch, case, trace_s)
    for r in rows:
        r["launches"] = launches[r["name"]]
    for name in MAIN_PATH_KERNELS:
        _require(launches[name] > 0, f"{name} launched on the main path")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "plain_shape"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(f"total_s {time.perf_counter() - t_all:.2f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
