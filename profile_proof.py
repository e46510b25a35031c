#!/usr/bin/env python3
"""Where the time of one port proof goes, on one GPU.

    python3 profile_proof.py [--out profile.json]

Builds the kernels, makes the seeded Binary SM case that ``chip_smoke.py``
proves (``binary_sm.seeded_case``: the zkEVM's settings), then:
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
     kernels that make tensors contiguous (names in SPLIT).
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    from xlayer_prover_tpu_torch.models.zkevm import binary_sm
    from xlayer_prover_tpu_torch.stark import prover

    card = device.smi("name,power.limit")
    print(card, flush=True)
    kernels.build_all()
    t0 = time.perf_counter()
    air, _layout, const_np, cm1, _actions, _results = binary_sm.seeded_case()
    trace_s = time.perf_counter() - t0

    def timed_proof(setup):
        rounds = {}
        t0 = time.perf_counter()
        proof = prover.gen_proof(setup, cm1, [], timings=rounds)
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
        prover.gen_proof(setup, cm1, [])
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    split = {g: [0, 0.0] for g in SPLIT}
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
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
        "card": card, "n_bits": air.n_bits, "trace_s": trace_s,
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
