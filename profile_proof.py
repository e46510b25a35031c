#!/usr/bin/env python3
"""Where the time of one port proof goes, on one GPU.

    python3 profile_proof.py [--case binary|zkevm|devnet|recursion]
                             [--out profile.json]

Builds the kernels, makes one of the cases that ``chip_smoke.py`` proves
(``binary``: the seeded 2^20-row Binary SM case, ``binary_sm.seeded_case``;
``zkevm``: the mini-ROM executed into the 2^16-row zkEVM composite AIR,
``mini_rom.execute(16)``; ``devnet``: devnet batch 0 through the fork_9
ROM with the Storage SM, ``utils/devnet``; ``recursion``: the recursive1
gate AIR over the devnet AIR at 2^18 rows, its witness the lift of the
committed batch proof 0), then:
  1. Setup.build and a first gen_proof (cold: twiddle tables, library
     loads), timed per round;
  2. a second gen_proof, timed per round, that must be byte-equal to the
     first;
  3. a third gen_proof under ``torch.profiler`` (CPU + CUDA activity): the
     device's busy time (sum of kernel and copy durations; one stream, so
     no overlap) against the wall time gives the idle share, the kernels
     are ranked by total device time, and ``split`` sums the device time
     and launches of the Merkle commitments' kernels and of their
     scaffolding: the two Poseidon kernels, ``torch.cat`` and the copy
     kernels that make tensors contiguous (names in SPLIT); ``by_op``
     counts the profiler's CPU-side ATen ops (``aten::...``) by name.
Prints one JSON line (and writes it to --out if given).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# split group -> substring of the device kernel's name
SPLIT = {"poseidon_permute": "poseidon_permute_kernel",
         "poseidon_linear_hash": "poseidon_linear_hash_kernel",
         "cat": "CatArrayBatchedCopy",
         "copies": "direct_copy_kernel"}


def recursion_case(devnet):
    """The recursive1 gate AIR over the devnet AIR and verkey (4 queries,
    2^18 rows), with its constant columns and the witness of lifting the
    committed batch proof 0.  -> (air, const, cm1, publics)"""
    import numpy as np

    from xlayer_prover_tpu_torch.recursion import gate_air
    from xlayer_prover_tpu_torch.recursion.engine import Recursive1
    from xlayer_prover_tpu_torch.recursion.verifier_circuit import \
        flatten_proof
    from xlayer_prover_tpu_torch.stark.proof import StarkProof

    engine = devnet.devnet_prover()
    rec1 = Recursive1(engine.air, engine.setup().verkey, n_queries=4)
    with open(os.path.join(REPO, "a7_state_devnet",
                           "batch_proof_0vdev0_nb16_q4.json")) as f:
        batch = StarkProof.from_json(json.load(f)["proof"])
    air, layout = rec1.air, rec1.layout
    const_np = np.zeros((air.n, air.const_width), dtype=np.uint64)
    gate_air.fill_fixed(layout, const_np)
    cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
    vals = gate_air.fill_witness(layout, flatten_proof(engine.air, batch),
                                 cm1)
    return air, const_np, cm1, gate_air.publics_of(layout, vals)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=("binary", "zkevm", "devnet",
                                       "recursion"), default="binary")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_proof: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.models.zkevm import binary_sm, mini_rom
    from xlayer_prover_tpu_torch.stark import prover
    from xlayer_prover_tpu_torch.utils import devnet

    card = device.smi("name,power.limit")
    print(card, flush=True)
    kernels.build_all()
    t0 = time.perf_counter()
    if args.case == "binary":
        air, _layout, const_np, cm1, _actions, _results = \
            binary_sm.seeded_case()
        publics = []
    elif args.case == "zkevm":
        ex, res = mini_rom.execute(16)
        air, const_np, cm1, publics = ex.air, res.const_np, res.cm1_np, \
            res.publics
    elif args.case == "devnet":
        engine = devnet.devnet_prover()
        res = engine.execute_only(devnet.build_devnet_inputs(engine, 1)[0])
        air, const_np, cm1, publics = engine.air, res.const_np, res.cm1_np, \
            res.publics
    else:
        air, const_np, cm1, publics = recursion_case(devnet)
    trace_s = time.perf_counter() - t0

    def timed_proof(setup):
        rounds = {}
        t0 = time.perf_counter()
        proof = prover.gen_proof(setup, cm1, publics, timings=rounds)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0, rounds

    t0 = time.perf_counter()
    setup = prover.Setup.build(air, const_np)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    first, first_s, first_rounds = timed_proof(setup)
    second, second_s, second_rounds = timed_proof(setup)
    if first.to_json() != second.to_json():
        raise RuntimeError("two proofs of one trace are not byte-equal")

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.gen_proof(setup, cm1, publics)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    split = {g: [0, 0.0] for g in SPLIT}
    busy_us = 0.0
    by_op = collections.Counter()
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            if ev.name.startswith("aten::"):
                by_op[ev.name] += 1
            continue
        us = ev.time_range.elapsed_us()
        busy_us += us
        entry = by_name[ev.name[:90]]
        entry[0] += 1
        entry[1] += us
        for g, sub in SPLIT.items():
            if sub in ev.name:
                split[g][0] += 1
                split[g][1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    report = {
        "card": card, "case": args.case, "n_bits": air.n_bits,
        "trace_s": trace_s,
        "setup_s": setup_s,
        "first_proof_s": first_s, "first_rounds_s": first_rounds,
        "second_proof_s": second_s, "second_rounds_s": second_rounds,
        "profiled_wall_s": prof_wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": (1.0 - busy_us / 1e6 / prof_wall_s
                              if busy_us else None),
        "device_events": sum(v[0] for v in by_name.values()),
        "launches": launches,
        "top_device": [{"name": k, "count": v[0], "ms": v[1] / 1e3}
                       for k, v in top],
        "split": {g: {"count": v[0], "ms": v[1] / 1e3}
                  for g, v in split.items()},
        "by_op": dict(by_op.most_common(15)),
    }
    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
