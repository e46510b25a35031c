#!/usr/bin/env python3
"""fflonk's four Fr polynomial kernels on one GPU at the devnet wrap's
shapes.

    python3 xlayer_prover_tpu_torch/fr_poly_times.py
    python3 xlayer_prover_tpu_torch/fr_poly_times.py --root DIR
                      # the port of another checkout (e.g. a parent commit
                      # from git archive), built there
    python3 xlayer_prover_tpu_torch/fr_poly_times.py --kernels fr_eval
                      # only these kernels (comma-separated)

It times, with CUDA events over ``--reps`` calls after one to warm up,
every call of the wrap of ``fr_eval``, ``fr_div_binomial``,
``fr_scan_mul`` and ``fr_pointwise`` (or of ``--kernels``) at n =
``--n`` (the devnet root's 2^23 by default; ``chip_smoke.fflonk_wrap_calls``,
the rows that phase 13 (a) times and holds to the wrap's own calls), on
seeded values below r, each beside its bound and with its launches a
wrap.  The public wrappers are all it calls, so it times any checkout
since the fflonk wrap was ported; run it on two in turns (parent,
change, change, parent) in one call to compare them.  It imports nothing
of JAX.  The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261019


def _chip_smoke():
    """This checkout's chip_smoke.py (the work counts and the timers),
    whatever --root names."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose port is timed")
    ap.add_argument("--n", type=int, default=1 << 23)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", default="fr_eval,fr_div_binomial,"
                    "fr_scan_mul,fr_pointwise")
    args = ap.parse_args()
    names = args.kernels.split(",")

    import torch
    if not torch.cuda.is_available():
        print("fr_poly_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.fields.bn254 import R as r
    from xlayer_prover_tpu_torch.ops import fr_poly, ntt_fr

    cs = _chip_smoke()
    card = device.smi("name,power.limit")
    print(card, flush=True)
    print(f"root {root}", flush=True)
    cs.print_ptxas(kernels.build_all(["fr_poly"]))
    rate = cs.int_mul_rate(torch)
    n, n9 = args.n, 9 * args.n + 21
    gap = 1 << 22                         # inputs 2^22 rows apart
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    big = cs._rand_fr(torch, 8 * gap + n9, torch.device("cuda"), gen)
    py = random.Random(SEED)
    y = py.randrange(r)
    ks = [py.randrange(r) for _ in range(4)]

    def sl(j, m):
        return big[j * gap:j * gap + m]
    calls = cs.fflonk_wrap_calls(fr_poly, ntt_fr, n, sl, y, ks)
    report = {"card": card, "root": root, "n": n, "reps": args.reps,
              **{name: [] for name in names}}

    def timed(fn, work):
        ms = cs._cuda_ms(fn, args.reps)
        bound, by = min(cs._bound_ms(w, rate) for w in
                        (work if isinstance(work, list) else [work]))
        return {"ms": ms, "bound_ms": bound, "bound_by": by}

    for name, what, m, fn, work, per in calls:
        if name not in names:
            continue
        row = {"what": what, "shape": [m, 4], "per_wrap": per,
               **timed(fn, work)}
        report[name].append(row)
        print(f"{name} ({what}) at {row['shape']}: {row['ms']:.4f} ms "
              f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
              f"{per} a wrap)", flush=True)
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
