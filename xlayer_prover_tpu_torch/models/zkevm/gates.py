"""Gate framework: boolean circuit builder + levelized executor.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/gates.py``.
Equivalent of the reference gate framework (src/sm/gate/) and the build-time
Keccak/SHA circuit script generators (tools/sm/keccak_f/keccak_gen.cpp): a
hash permutation is expressed as a DAG of XOR / ANDP (= ~a & b) gates; the
KeccakF SM executes the script over bit-packed instance lanes
(src/sm/keccak_f/keccak_f_executor.hpp:34-71).

The trace path evaluates every wire on the host (``execute_all_wires_np``,
numpy, one vectorized step a level).  ``execute`` runs the script on a
device over the capacity-packed rows of ``_pack_rows``: one gather of the
operand wires, one select of XOR or ANDP and one scatter of the results a
row, over 32-bit instance words held in int64 (32 instances a word).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from ... import device as dev

OP_XOR = 0
OP_ANDP = 1  # (~a) & b


class GateBuilder:
    """Builds a gate DAG; wire 0 is constant 0, wire 1 is constant 1."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.n_wires = 2 + n_inputs     # [zero, one, inputs...]
        self.gates: List[Tuple[int, int, int, int]] = []  # (op, a, b, r)
        self._xor_cache = {}

    def input_wire(self, i: int) -> int:
        return 2 + i

    @property
    def ZERO(self):
        return 0

    @property
    def ONE(self):
        return 1

    def _emit(self, op: int, a: int, b: int) -> int:
        key = (op, a, b) if op == OP_ANDP else (op, min(a, b), max(a, b))
        hit = self._xor_cache.get(key)
        if hit is not None:
            return hit
        r = self.n_wires
        self.n_wires += 1
        self.gates.append((op, a, b, r))
        self._xor_cache[key] = r
        return r

    def xor(self, a: int, b: int) -> int:
        if a == 0:
            return b
        if b == 0:
            return a
        return self._emit(OP_XOR, a, b)

    def andp(self, a: int, b: int) -> int:
        """(~a) & b."""
        if b == 0:
            return 0
        if a == 0:
            return b
        return self._emit(OP_ANDP, a, b)

    def xor_many(self, wires) -> int:
        acc = 0
        for w in wires:
            acc = self.xor(acc, w)
        return acc


@dataclasses.dataclass
class GateScript:
    """Levelized gate program + output wire map."""
    n_inputs: int
    n_wires: int
    levels: list            # per level: (ops[], a[], b[], r[]) int32 arrays
    outputs: np.ndarray     # wire index per output bit
    gates: list = None      # raw (op, a, b, r) emission order (for the AIR)

    @property
    def n_gates(self):
        return sum(len(l[0]) for l in self.levels)

    @property
    def depth(self):
        return len(self.levels)


def levelize(builder: GateBuilder, output_wires) -> GateScript:
    depth = np.zeros(builder.n_wires, dtype=np.int64)
    levels_acc = {}
    for (op, a, b, r) in builder.gates:
        d = max(depth[a], depth[b]) + 1
        depth[r] = d
        levels_acc.setdefault(d, []).append((op, a, b, r))
    levels = []
    for d in sorted(levels_acc):
        arr = np.array(levels_acc[d], dtype=np.int32)
        levels.append((arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]))
    return GateScript(n_inputs=builder.n_inputs, n_wires=builder.n_wires,
                      levels=levels,
                      outputs=np.asarray(output_wires, dtype=np.int32),
                      gates=list(builder.gates))


def execute_all_wires_np(script: GateScript, inputs: np.ndarray,
                         pack_bits: int) -> np.ndarray:
    """Host-numpy evaluation returning EVERY wire value (for AIR trace
    fill): inputs is (n_inputs,) uint64 of pack_bits-packed instance bits;
    returns (n_wires,) uint64."""
    mask = np.uint64((1 << pack_bits) - 1)
    wires = np.zeros(script.n_wires, dtype=np.uint64)
    wires[1] = mask
    wires[2:2 + script.n_inputs] = np.asarray(inputs, dtype=np.uint64)
    for (ops, a, b, r) in script.levels:
        va = wires[a]
        vb = wires[b]
        res = np.where(ops == OP_XOR, va ^ vb, (~va) & vb) & mask
        wires[r] = res
    return wires


def _pack_rows(script: GateScript):
    """Capacity-packed ASAP schedule: gates are laid out into uniform-width
    rows (a gate lands on the first row after both its operands that still
    has a free slot), so device execution is ONE lax.scan over a dense
    (n_rows, W) table instead of an unrolled per-level graph — compile
    time is a single small body, not O(n_gates)."""
    total = sum(len(l[0]) for l in script.levels)
    depth = max(1, len(script.levels))
    w = 64
    while w < max(64, total // depth):
        w *= 2
    row_of = np.zeros(script.n_wires, dtype=np.int64)   # row that wrote wire
    counts: list = [0]
    rows: list = [[]]
    for (ops, a_arr, b_arr, r_arr) in script.levels:
        for op, a, b, r in zip(ops, a_arr, b_arr, r_arr):
            e = int(max(row_of[a], row_of[b])) + 1
            while True:
                while e >= len(rows):
                    rows.append([])
                    counts.append(0)
                if counts[e] < w:
                    break
                e += 1
            rows[e].append((op, a, b, r))
            counts[e] += 1
            row_of[r] = e
    n_rows = len(rows)
    ops_t = np.zeros((n_rows, w), dtype=np.int32)   # pad: XOR(0,0) -> wire 0
    a_t = np.zeros((n_rows, w), dtype=np.int32)
    b_t = np.zeros((n_rows, w), dtype=np.int32)
    r_t = np.zeros((n_rows, w), dtype=np.int32)
    for i, row in enumerate(rows):
        for j, (op, a, b, r) in enumerate(row):
            ops_t[i, j] = op
            a_t[i, j] = a
            b_t[i, j] = b
            r_t[i, j] = r
    return ops_t, a_t, b_t, r_t


def _rows_on(script: GateScript, device: torch.device):
    """``_pack_rows`` of `script` as tensors on `device`, cached on the
    script: (is_xor bool, a, b, r int64), each (n_rows, W)."""
    cache = script.__dict__.setdefault("_rows_on", {})
    if device not in cache:
        ops_t, a_t, b_t, r_t = _pack_rows(script)
        cache[device] = tuple(torch.as_tensor(t, device=device)
                              for t in (ops_t == OP_XOR,
                                        a_t.astype(np.int64),
                                        b_t.astype(np.int64),
                                        r_t.astype(np.int64)))
    return cache[device]


def execute(script: GateScript, inputs, device=None):
    """inputs: (n_inputs, lanes) packed instance bits, 32 instances a
    word (uint32 values): a tensor, run on its own device, or an array,
    run on `device` (None: the GPU).  Returns (n_outputs, lanes) int64
    words in [0, 2^32) on that device.

    One gather, select and scatter a packed row; the pad slots of a row
    are XOR(0, 0) -> wire 0, which keeps wire 0 at zero."""
    if torch.is_tensor(inputs):
        inp = inputs.to(torch.int64)
    else:
        inp = torch.as_tensor(np.asarray(inputs, dtype=np.int64),
                              device=dev.resolve(device))
    device = inp.device
    is_xor, a_t, b_t, r_t = _rows_on(script, device)
    lanes = inp.shape[1]
    wires = torch.zeros((script.n_wires, lanes), dtype=torch.int64,
                        device=device)
    wires[1] = 0xFFFFFFFF
    wires[2:2 + script.n_inputs] = inp
    for i in range(a_t.shape[0]):
        va = wires[a_t[i]]
        vb = wires[b_t[i]]
        res = torch.where(is_xor[i][:, None], va ^ vb, (~va) & vb)
        wires.index_copy_(0, r_t[i], res)
    return wires[torch.as_tensor(script.outputs.astype(np.int64),
                                 device=device)]
