#!/usr/bin/env python3
"""The Fr NTT kernel on one GPU at the shapes of Groth16's h.

    python3 xlayer_prover_tpu_torch/fr_ntt_times.py
    python3 xlayer_prover_tpu_torch/fr_ntt_times.py --root DIR
                      # the port of another checkout (e.g. a parent commit
                      # from git archive), built there

It times ``ntt_fr.ntt`` at the three shapes of the devnet root's h
(``chip_smoke.py`` phase 8): a 2^20 inverse, the 2^21 forward and the
2^21 inverse, on seeded values below r, with CUDA events over ``--reps``
calls after one to warm up (which builds the twiddle table), each beside
its bound (``chip_smoke.ntt_work``); then the host seconds of each cold
twiddle table (``ntt_fr._kernel_twiddles`` with every cache of the module
cleared, ended by a synchronise).  Both are entry points that every
checkout since the Fr NTT was ported has.  Run it on two checkouts in
turns (parent, change, change, parent) in one call to compare them.  It
imports nothing of JAX.  The last line is one JSON object with the
numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((20, True), (21, False), (21, True))
SEED = 20261018


def _chip_smoke():
    """This checkout's chip_smoke.py (the bound's count and the timers),
    whatever --root names."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clear_caches(module) -> None:
    """Empty every functools cache of the module (twiddle tables, their
    host parts, powers), so that the next table is built cold."""
    for value in vars(module).values():
        if callable(getattr(value, "cache_clear", None)):
            value.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose port is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("fr_ntt_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np

    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.ops import ntt_fr

    cs = _chip_smoke()
    card = device.smi("name,power.limit")
    print(card, flush=True)
    print(f"root {root}", flush=True)
    cs.print_ptxas(kernels.build_all(["fr_ntt"]))
    cuda = torch.device("cuda")
    rate = cs.int_mul_rate(torch)
    gen = np.random.default_rng(SEED)
    x = torch.from_numpy(gen.integers(-(1 << 63), 1 << 63,
                                      size=(1 << 21, 4),
                                      dtype=np.int64)).to(cuda)
    x[:, 3] &= (1 << 60) - 1                   # below 2^252 < r
    report = {"card": card, "root": root, "reps": args.reps, "times": [],
              "cold_table_s": {}}
    for bits, inverse in SHAPES:
        vals = x[:1 << bits]
        ms = cs._cuda_ms(lambda: ntt_fr.ntt(vals, inverse), args.reps)
        bound, by = cs._bound_ms(cs.ntt_work(1 << bits, inverse), rate)
        report["times"].append({"shape": [1 << bits, 4], "inverse": inverse,
                                "ms": ms, "bound_ms": bound, "bound_by": by})
        print(f"fr_ntt {'inverse' if inverse else 'forward'} at "
              f"[{1 << bits}, 4]: {ms:.4f} ms (bound {bound:.4f} ms by "
              f"{by})", flush=True)
    for bits, inverse in SHAPES:
        _clear_caches(ntt_fr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ntt_fr._kernel_twiddles(bits, inverse, cuda)
        torch.cuda.synchronize()
        key = f"2^{bits}{' inverse' if inverse else ''}"
        report["cold_table_s"][key] = time.perf_counter() - t0
        print(f"cold twiddle table {key}: "
              f"{report['cold_table_s'][key]:.4f} s (host clock)",
              flush=True)
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
