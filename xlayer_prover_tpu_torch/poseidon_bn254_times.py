#!/usr/bin/env python3
"""The Poseidon-BN254 kernels on one GPU at fixed shapes.

    python3 xlayer_prover_tpu_torch/poseidon_bn254_times.py
    python3 xlayer_prover_tpu_torch/poseidon_bn254_times.py --root DIR
                      # the port of another checkout (e.g. a parent commit
                      # from git archive), built there
    python3 xlayer_prover_tpu_torch/poseidon_bn254_times.py \\
        --shapes build/poseidon_bn254_final_shapes.json

It times ``poseidon_bn254_permute`` (t = 17) at 2^20 states and at the
first three tree levels of a 2^17-leaf BN128 tree (8,192, 512 and 32
states), and ``poseidon_bn254_leaf_hash`` on 2^17 rows of widths 60, 39,
51 and 6 (the RecursiveF columns of ``chip_smoke.py`` phase 8: cm1, cm3,
const, cm4), on seeded inputs, with CUDA events over ``--reps`` calls
after one to warm up, each beside its bound (``chip_smoke.py``'s count).
With ``--shapes``, a JSON list of {"kernel", "shape", "launches"} as
``chip_smoke.py`` phase 8 writes it (every shape the final stage launched
the pair at, recorded around the wrappers), it also times each of those
shapes and sums them weighted by launches: the pair's time in that stage
on ``--root``'s kernels.  Run it on two checkouts in turns (parent,
change, change, parent) in one call to compare them.  The ptxas lines
and, where the library reports them, the resident warps an SM come first.
It imports nothing of JAX.  The last line is one JSON object with the
numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PERMUTE_STATES = (1 << 20, 8192, 512, 32)
LEAF_ROWS = 1 << 17
LEAF_WIDTHS = (60, 39, 51, 6)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout whose port is timed")
    ap.add_argument("--shapes", help="the final stage's launch shapes "
                    "(JSON, as chip_smoke.py phase 8 writes them)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("poseidon_bn254_times: no CUDA device", file=sys.stderr)
        return 2
    stage_shapes = None
    if args.shapes:
        with open(args.shapes) as f:
            stage_shapes = json.load(f)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np

    import chip_smoke
    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.ops import poseidon_bn254 as pbn

    card = device.smi("name,power.limit")
    print(card, flush=True)
    print(f"root {root}", flush=True)
    chip_smoke.print_ptxas(kernels.build_all(["poseidon_bn254"]))
    lib = kernels.load("poseidon_bn254")
    report = {"card": card, "root": root, "reps": args.reps,
              "resident_warps": None, "times": []}
    if hasattr(chip_smoke, "resident_warps") and \
            hasattr(lib, "poseidon_bn254_resident_warps"):
        report["resident_warps"] = chip_smoke.resident_warps(lib)
    print("resident warps an SM " + json.dumps(report["resident_warps"]),
          flush=True)
    cuda = torch.device("cuda")
    rate = chip_smoke.int_mul_rate(torch)
    rng = np.random.default_rng(chip_smoke.SEED)

    def rand(shape):
        return torch.from_numpy(rng.integers(
            0, (1 << 64) - 1, size=shape, dtype=np.uint64,
            endpoint=True).view(np.int64)).to(cuda)

    def row(kernel, shape, work, ms):
        bound, by = chip_smoke._bound_ms(work, rate)
        report["times"].append({"kernel": kernel, "shape": shape, "ms": ms,
                                "bound_ms": bound, "bound_by": by})
        print(f"{kernel} at {shape}: {ms:.4f} ms (bound {bound:.4f} ms by "
              f"{by})", flush=True)

    for n in PERMUTE_STATES:
        x = rand((n, 17, 4))
        row("poseidon_bn254_permute", [n, 17, 4],
            chip_smoke.bn254_permute_work(n),
            chip_smoke._cuda_ms(lambda: pbn.permute(x, 17), args.reps))
        del x
    for width in LEAF_WIDTHS:
        rows = rand((LEAF_ROWS, width))
        row("poseidon_bn254_leaf_hash", [LEAF_ROWS, width],
            chip_smoke.bn254_leaf_work(LEAF_ROWS, width),
            chip_smoke._cuda_ms(lambda: pbn.leaf_hash(rows, width),
                                args.reps))
        del rows

    if stage_shapes is not None:
        stage, stage_ms = [], 0.0
        for r in stage_shapes:
            fn = getattr(pbn, r["kernel"].removeprefix("poseidon_bn254_"))
            x = rand(tuple(r["shape"]))
            ms = chip_smoke._cuda_ms(lambda: fn(x, r["shape"][1]), args.reps)
            del x
            stage.append({"kernel": r["kernel"], "shape": r["shape"],
                          "launches": r["launches"], "ms": ms})
            stage_ms += r["launches"] * ms
        report["final_stage"] = stage
        report["final_stage_ms"] = stage_ms
        print("final stage launches by shape (ms a launch): " + ", ".join(
            f"{r['kernel'][15:]} {r['shape']} x{r['launches']} "
            f"{r['ms']:.4f}" for r in stage), flush=True)
        print(f"final stage: the pair's "
              f"{sum(r['launches'] for r in stage)} launches "
              f"{stage_ms:.3f} ms", flush=True)
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
