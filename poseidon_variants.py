#!/usr/bin/env python3
"""Launch variants and instruction counts of the Poseidon kernels, on one GPU.

    python3 poseidon_variants.py [--out chiprun_out/poseidon_variants.json]

Builds ``xlayer_prover_tpu_torch/csrc/poseidon_gl.cu`` once for each
(threads a block, states a thread, blocks an SM) variant, with the
``POSEIDON_THREADS``/``POSEIDON_STATES``/``POSEIDON_MIN_BLOCKS`` defines,
into ``build/variants/`` (the shipped library is the source's defaults),
all builds at once, and prints ``ptxas``'s registers and spills.  For each
variant:
  * ``poseidon_permute`` on 2^20 seeded states (edge and non-canonical rows
    included): bit-equal to ``_permute_plain``, timed with CUDA events;
  * ``poseidon_linear_hash`` at the main path's shapes, 2^21 x 39 (the cm1
    leaves of the Binary SM AIR) and 2^20 x 8 (its first tree level):
    bit-equal to ``_linear_hash_plain`` on the first 2^14 rows and to the
    shipped library on all rows, timed;
  * the SASS of its ``poseidon_permute`` kernel (``cuobjdump -sass``),
    counted per permutation by opcode: the permutation's three round loops
    run 3, 22 and 3 times.
Last, a micro-kernel measures the card's issue rate of IMAD.WIDE.U32,
IADD3, IMAD and IMAD.HI.U32 (8 independent chains a thread, the whole card
busy), per SM and clock at the card's maximum SM clock.  Prints one JSON
line (and writes it to --out).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
VARIANTS = [(128, 1, 4), (128, 1, 3), (256, 1, 2), (128, 2, 2),
            (256, 2, 1)]
LOOP_TRIPS = (3, 22, 3)     # poseidon_gl.cu permute: full, partial, full
SEED = 20261016

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")

_MICRO = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define CHAINS(T, INIT, STEP)                                  \
  T a[8];                                                      \
  for (int k = 0; k < 8; k++) a[k] = INIT;                     \
  for (int it = 0; it < iters; it++) {                         \
    _Pragma("unroll") for (int k = 0; k < 8; k++) a[k] = STEP; \
  }                                                            \
  T s = 0;                                                     \
  for (int k = 0; k < 8; k++) s ^= a[k];                       \
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
__global__ void imad_wide(uint64_t* out, uint32_t b, int iters) {
  CHAINS(uint64_t, threadIdx.x + k, (uint64_t)(uint32_t)a[k] * b + a[k])
}
__global__ void iadd3(uint64_t* out, uint32_t b, int iters) {
  CHAINS(uint32_t, threadIdx.x * (k + 1), a[k] + a[(k + 1) % 8] + b)
}
__global__ void imad32(uint64_t* out, uint32_t b, int iters) {
  CHAINS(uint32_t, threadIdx.x + k, a[k] * b + a[(k + 1) % 8])
}
__global__ void imad_hi(uint64_t* out, uint32_t b, int iters) {
  CHAINS(uint32_t, threadIdx.x + k, __umulhi(a[k], b) + a[(k + 1) % 8])
}
extern "C" int micro_launch(int which, void* out, int iters, int blocks,
                            void* stream) {
  void (*k[4])(uint64_t*, uint32_t, int) = {imad_wide, iadd3, imad32,
                                            imad_hi};
  k[which]<<<blocks, 256, 0, (cudaStream_t)stream>>>((uint64_t*)out,
                                                     2654435761u, iters);
  return (int)cudaGetLastError();
}
"""
_MICRO_OPS = ("IMAD.WIDE.U32", "IADD3", "IMAD", "IMAD.HI.U32")


def build(kernels, out_dir: str) -> dict:
    """Every variant library and the micro-kernel, one nvcc each, all at
    once; returns name -> (path, ptxas log)."""
    os.makedirs(out_dir, exist_ok=True)
    micro = os.path.join(out_dir, "micro_issue.cu")
    with open(micro, "w") as f:
        f.write(_MICRO)
    jobs = {"micro_issue": (micro, [])}
    for t, s, b in VARIANTS:
        jobs[f"poseidon_{t}_{s}_{b}"] = (
            os.path.join(kernels.CSRC, "poseidon_gl.cu"),
            [f"-DPOSEIDON_THREADS={t}", f"-DPOSEIDON_STATES={s}",
             f"-DPOSEIDON_MIN_BLOCKS={b}"])
    procs = {}
    for name, (src, defines) in jobs.items():
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (so, log)
    return out


def load_variant(kernels, poseidon_gl, so: str):
    """A variant library with the shipped library's entry points, its
    constant table uploaded."""
    import numpy as np
    lib = ctypes.CDLL(so)
    for fn, argtypes in kernels._LIBS["poseidon_gl"][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    table = np.ascontiguousarray(poseidon_gl.kernel_constants())
    kernels.check(lib.poseidon_set_constants(table.ctypes.data, table.size),
                  "poseidon_set_constants")
    return lib


def issue_rates(torch, kernels, device, so: str, cuda_ms) -> dict:
    """Instructions per SM and clock of each _MICRO_OPS chain."""
    lib = ctypes.CDLL(so)
    lib.micro_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(device.smi("clocks.max.sm").split()[0]) * 1e6
    blocks, iters = sms * 8, 4096
    out = torch.empty(blocks * 256, dtype=torch.int64, device="cuda")
    rates = {}
    for which, name in enumerate(_MICRO_OPS):
        def run():
            kernels.check(lib.micro_launch(which, out.data_ptr(), iters,
                                           blocks, kernels.stream_ptr(0)),
                          "micro_launch")
        ms = cuda_ms(run, 5)
        rates[name] = blocks * 256 * iters * 8 / (ms * 1e-3) / sms / clock_hz
    return rates


def sass_counts(so: str, states: int) -> dict:
    """Dynamic instruction counts per permutation, by opcode, of the
    library's poseidon_permute kernel (static counts times loop trips)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    insns, inside = [], False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = "poseidon_permute_kernel" in m.group(1)
            continue
        m = _INSN.search(line)
        if m and inside:
            insns.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = sorted(
        (int(t.group(1), 16), addr) for addr, op, args in insns
        if op == "BRA" and (t := re.search(r"0x([0-9a-f]+)", args))
        and int(t.group(1), 16) < addr)
    if len(loops) != len(LOOP_TRIPS):
        return {"error": f"{len(loops)} loops, expected {len(LOOP_TRIPS)}",
                "static": len(insns)}
    counts = collections.Counter()
    for addr, op, _ in insns:
        trips = [n for (lo, hi), n in zip(loops, LOOP_TRIPS) if lo <= addr <= hi]
        counts[op] += trips[-1] if trips else 1
    per = {op: c / states for op, c in counts.most_common()}
    return {"static": len(insns), "per_permutation": per,
            "total": sum(per.values()),
            "imad_all": sum(c for op, c in per.items()
                            if op.startswith("IMAD")),
            "imad_multiplies": sum(
                c for op, c in per.items() if op.startswith("IMAD")
                and not op.startswith(("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("poseidon_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from chip_smoke import _cuda_ms, print_ptxas
    from xlayer_prover_tpu_torch import device, kernels
    from xlayer_prover_tpu_torch.fields import gl
    from xlayer_prover_tpu_torch.ops import poseidon_gl

    card = device.smi("name,power.limit")
    print(card, flush=True)
    libs = build(kernels, os.path.join(os.path.dirname(kernels.BUILD_DIR),
                                       "variants"))
    print_ptxas({name: log for name, (_, log) in libs.items()})
    P = gl.P
    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n = 1 << 20
    states = rng.integers(0, P, size=(n, 12), dtype=np.uint64)
    states[:64] = rng.integers(P, (1 << 64) - 1, size=(64, 12),
                               dtype=np.uint64, endpoint=True)
    states[64] = [(1 << 64) - 1 - k for k in range(12)]
    states[65], states[66], states[67] = 0, 1, P - 1
    t = gl.from_u64_np(states, cuda)
    ref = poseidon_gl._permute_plain(t)
    leaves = torch.randint(-(1 << 63), (1 << 63) - 1, (1 << 21, 39),
                           dtype=torch.int64, device=cuda)
    level = torch.randint(-(1 << 63), (1 << 63) - 1, (1 << 20, 8),
                          dtype=torch.int64, device=cuda)
    k = 1 << 14
    shipped = (poseidon_gl.linear_hash(leaves, 39),
               poseidon_gl.linear_hash(level, 8))
    ok_plain = (torch.equal(shipped[0][:k], poseidon_gl._linear_hash_plain(
        leaves[:k], 39)) and torch.equal(shipped[1][:k],
                                         poseidon_gl._linear_hash_plain(
                                             level[:k], 8)))
    stream = kernels.stream_ptr(cuda)
    report = {"card": card, "variants": []}
    for threads, spt, min_blocks in VARIANTS:
        so = libs[f"poseidon_{threads}_{spt}_{min_blocks}"][0]
        lib = load_variant(kernels, poseidon_gl, so)
        out = torch.empty_like(t)
        digests = [torch.empty(x.shape[0], 4, dtype=torch.int64,
                               device=cuda) for x in (leaves, level)]

        def permute():
            kernels.check(lib.poseidon_permute_launch(
                t.data_ptr(), out.data_ptr(), n, stream), "permute")

        def hash_rows(rows, dst):
            kernels.check(lib.poseidon_linear_hash_launch(
                rows.data_ptr(), dst.data_ptr(), rows.shape[0],
                rows.shape[1], stream), "linear_hash")

        permute()
        hash_rows(leaves, digests[0])
        hash_rows(level, digests[1])
        torch.cuda.synchronize()
        row = {"threads": threads, "states_per_thread": spt,
               "blocks_per_sm": min_blocks,
               "bit_equal": bool(ok_plain and torch.equal(out, ref)
                                 and torch.equal(digests[0], shipped[0])
                                 and torch.equal(digests[1], shipped[1])),
               "permute_ms_2e20": _cuda_ms(permute, 20),
               "linear_hash_ms_2e21x39": _cuda_ms(
                   lambda: hash_rows(leaves, digests[0]), 5),
               "linear_hash_ms_2e20x8": _cuda_ms(
                   lambda: hash_rows(level, digests[1]), 20),
               "sass": sass_counts(so, spt)}
        print(json.dumps(row), flush=True)
        report["variants"].append(row)
    report["issue_per_sm_clock"] = issue_rates(
        torch, kernels, device, libs["micro_issue"][0], _cuda_ms)
    print("issue per SM and clock:", report["issue_per_sm_clock"],
          flush=True)
    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if all(r["bit_equal"] for r in report["variants"]) else 1


if __name__ == "__main__":
    sys.exit(main())
