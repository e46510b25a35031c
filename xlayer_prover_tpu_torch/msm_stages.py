#!/usr/bin/env python3
"""The BN254 MSM kernels on one GPU, stage by stage.

    python3 xlayer_prover_tpu_torch/msm_stages.py     # this checkout
    python3 xlayer_prover_tpu_torch/msm_stages.py --root DIR
                          # the port of another checkout (e.g. a parent
                          # commit from git archive), built there
    python3 xlayer_prover_tpu_torch/msm_stages.py --n 1048576 --reps 3

For G1 and G2 it makes chip_smoke.py phase 2's timed inputs (2^20 points
from the fixed-base kernel, uniform scalars below r with a quarter of
them 1, the edge rows), calls ``msm_g1`` / ``msm_g2`` once to warm up,
then `--reps` times under ``torch.profiler`` (CPU and CUDA activity).  It
prints, per call, each device kernel's and ATen glue op's milliseconds by
name (the profiler's CUPTI records), their sum, the call's time by CUDA
events around it, and its host wall time (which holds any host syncs of
the glue); then one more call launch by launch, in order.  The ptxas
lines of the two libraries' build come first.  It reads the design's
stages from the kernels' names, so it times any version of
``ops/bn254_msm.py`` alike, and imports nothing of JAX.  The last line is
one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout whose port is timed")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("msm_stages: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.ops import bn254_msm

    card = device.smi("name,power.limit")
    print(card, flush=True)
    print(f"root {root}", flush=True)
    chip_smoke.print_ptxas(kernels.build_all(
        [f"bn254_msm_{g}" for g in ("g1", "g2")]))
    report = {"card": card, "n": args.n, "reps": args.reps, "groups": {}}
    for group in ("g1", "g2"):
        rng = np.random.default_rng(chip_smoke.SEED)
        pts, sc = chip_smoke._curve_inputs(torch, rng, group, args.n)
        fn = getattr(bn254_msm, f"msm_{group}")
        fn(pts, sc)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            for _ in range(args.reps):
                fn(pts, sc)
            end.record()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        by_name = collections.defaultdict(float)
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name[:80]] += ev.time_range.elapsed_us() / 1e3
        stages = {k: v / args.reps for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])}
        with profile(activities=[ProfilerActivity.CUDA]) as one:
            fn(pts, sc)
            torch.cuda.synchronize()
        order = sorted((ev.time_range.start, ev.name.split("(")[0][:60],
                        ev.time_range.elapsed_us() / 1e3)
                       for ev in one.events()
                       if ev.device_type == DeviceType.CUDA)
        row = {"launches_ms": [[name, ms] for _, name, ms in order],
               "stages_ms": stages,
               "device_sum_ms": sum(stages.values()),
               "event_ms": start.elapsed_time(end) / args.reps,
               "wall_ms": wall_s * 1e3 / args.reps}
        report["groups"][group] = row
        print(f"{group} at n = {args.n}: events {row['event_ms']:.3f} ms a "
              f"call, wall {row['wall_ms']:.3f} ms, device sum "
              f"{row['device_sum_ms']:.3f} ms", flush=True)
        for name, ms in stages.items():
            print(f"  {ms:10.4f} ms  {name}", flush=True)
        print("  one call, launch by launch:", flush=True)
        for name, ms in row["launches_ms"]:
            print(f"  {ms:10.4f} ms  {name}", flush=True)
        del pts, sc
        torch.cuda.empty_cache()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
