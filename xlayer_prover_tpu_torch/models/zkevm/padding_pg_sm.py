"""PaddingPG SM: provable Poseidon sponge padding for the hashP chain.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/padding_pg_sm.py``
(the host permutation is ``ops/poseidon_gl.host_permute``; the idle
streams, identical but for their address, are filled from one template).
A re-design of the reference PaddingPG state machine
(src/sm/padding_pg/padding_pg_executor.cpp; padding_pg.pil shape): one row
per padded byte, 56-byte blocks statically aligned to the domain
(row % 56), each block hashed by one PoseidonG permutation
(8x7-byte little-endian elements + the previous block hash as capacity —
poseidonLinearHash, utils.cpp:677-712).

The byte/stream/chunk-read skeleton lives in padding_bytes.build_core
(shared with PaddingKK/PaddingSha256); this module adds the PG-specific
binding: 7-byte element accumulators, the prevHash/curHash chain, and the
per-block lookup into the PoseidonG SM permutation table
(padding_pg_executor.cpp:80-216).  Idle rows are empty-data streams, one
per remaining block (the reference's unused-block fill,
executor.cpp:230-270); all idle blocks share one Poseidon instance
(plookup multiplicity).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...fields import gl
from ...ops.poseidon_gl import host_permute
from ...stark.air import AirBuilder, Const, FirstRowSelector
from .padding_bytes import (ByteStreamCore, ByteStreamInput,
                            bind_multirate, build_core, fill_core_fixed,
                            fill_core_stream, pad_multirate)

P = gl.P
BLOCK = 56          # bytes per block
EPB = 7             # bytes per element


@dataclasses.dataclass
class PaddingPGLayout:
    core: ByteStreamCore
    fixed: dict
    witness: dict

    @property
    def n_active(self):
        return self.core.n_active

    def pos_expr(self):
        return self.core.pos_expr()


def pad_bytes(data: bytes) -> bytes:
    return pad_multirate(data, BLOCK)


def linear_hash_blocks(padded: bytes):
    """[(input12, out4) per block] of the chained sponge."""
    blocks = []
    digest = [0, 0, 0, 0]
    for off in range(0, len(padded), BLOCK):
        elems = [int.from_bytes(padded[off + EPB * k:off + EPB * (k + 1)],
                                "little") for k in range(8)]
        inp = elems + list(digest)
        digest = host_permute(inp)[:4]
        blocks.append((inp, list(digest)))
    return blocks


def linear_hash_bytes(data: bytes) -> list:
    """The 4-element Poseidon linear hash of a byte stream (the reference's
    poseidonLinearHash, utils.cpp:677-712): the hashP digest."""
    return linear_hash_blocks(pad_bytes(data))[-1][1]


def build(b: AirBuilder, n_bits: int) -> PaddingPGLayout:
    core = build_core(b, "PP", n_bits, BLOCK)
    bind_multirate(b, core)
    w = dict(core.witness)
    fixed = dict(core.fixed)
    for k in range(8):
        fixed[f"F{k}"] = b.fixed(f"PP_F{k}")
    for k in range(8):
        w[f"acc{k}"] = b.witness(f"pp_acc{k}")
    for j in range(4):
        w[f"prevHash{j}"] = b.witness(f"pp_prevHash{j}")
        w[f"curHash{j}"] = b.witness(f"pp_curHash{j}")

    one = Const(1)
    nlast = fixed["NLAST"]
    lastch = fixed["LASTCH"]
    bfirst = fixed["BFIRST"]
    l1 = FirstRowSelector()
    for j in range(4):
        b.constrain(l1 * w[f"prevHash{j}"])

    # 7-byte element accumulation (inclusive of this row's byte)
    for k in range(8):
        b.constrain(bfirst * (w[f"acc{k}"] - w["freeIn"] * fixed[f"F{k}"]))
        b.constrain(nlast * (w[f"acc{k}"].shifted() - w[f"acc{k}"]
                             - w["freeIn"].shifted()
                             * fixed[f"F{k}"].shifted()))

    # prevHash chain across blocks; resets at stream ends
    lh = w["lastHash"]
    for j in range(4):
        b.constrain(nlast * (w[f"prevHash{j}"].shifted()
                             - w[f"prevHash{j}"]))
        b.constrain(lastch * (w[f"prevHash{j}"].shifted()
                              - (one - lh) * w[f"curHash{j}"]))

    return PaddingPGLayout(core=core, fixed=fixed, witness=w)


def poseidon_lookup_cols(layout: PaddingPGLayout):
    """(f_cols, f_sel) of the block -> PoseidonG permutation lookup."""
    w = layout.witness
    f_cols = ([w[f"acc{k}"] for k in range(8)]
              + [w[f"prevHash{j}"] for j in range(4)]
              + [w[f"curHash{j}"] for j in range(4)])
    return f_cols, layout.fixed["LAST"]


def fill_fixed(layout: PaddingPGLayout, const_np: np.ndarray):
    fill_core_fixed(layout.core, const_np)
    fx = layout.fixed
    n = const_np.shape[0]
    r = np.arange(n)
    in_block = r % BLOCK
    active = (r < layout.n_active)
    acci = in_block // EPB
    sh = (in_block % EPB) * 8
    for k in range(8):
        const_np[:, fx[f"F{k}"].index] = \
            np.where((acci == k) & active,
                     np.uint64(1) << sh.astype(np.uint64), 0)


def expand_into(layout: PaddingPGLayout, inputs: List[ByteStreamInput],
                cm1_np: np.ndarray):
    """Fill committed columns; returns the PoseidonG request list
    (12-element inputs, deduped idle block last)."""
    na = layout.n_active
    w = layout.witness
    inputs = sorted(inputs, key=lambda s: s.addr)
    if inputs:
        base = inputs[0].addr
        assert [s.addr for s in inputs] == \
            list(range(base, base + len(inputs))), \
            "hashP stream addresses must be contiguous"
        next_addr = base + len(inputs)
    else:
        next_addr = 0

    pg_requests = []
    col = {name: c.index for name, c in w.items()}

    def put_stream(out, row, addr, data, reads, record_pg):
        padded = pad_bytes(data)
        blocks = linear_hash_blocks(padded)
        if record_pg:
            pg_requests.extend(inp for inp, _ in blocks)
        fill_core_stream(layout.core, out, row, addr, data, reads, padded)
        for j, byte in enumerate(padded):
            rr = row + j
            blk = j // BLOCK
            if j % BLOCK == BLOCK - 1:
                inp, out_hash = blocks[blk]
                for k in range(8):
                    out[rr, col[f"acc{k}"]] = inp[k]
                for q in range(4):
                    out[rr, col[f"curHash{q}"]] = out_hash[q]
            else:
                base_off = blk * BLOCK
                for k in range(8):
                    lo = base_off + EPB * k
                    span = min(j + 1 - lo, EPB) if j + 1 > lo else 0
                    if span > 0:
                        out[rr, col[f"acc{k}"]] = int.from_bytes(
                            padded[lo:lo + span], "little")
            for q in range(4):
                out[rr, col[f"prevHash{q}"]] = \
                    blocks[blk - 1][1][q] if blk else 0
        return row + len(padded)

    row = 0
    for s in inputs:
        assert row + len(pad_bytes(s.data)) <= na, \
            "PaddingPG byte capacity exceeded"
        row = put_stream(cm1_np, row, s.addr, s.data, s.reads,
                         record_pg=True)

    # idle streams: one empty-data block each, all alike but for the
    # address; the first records the shared PoseidonG instance
    n_idle = (na - row) // BLOCK
    if n_idle:
        template = np.zeros((BLOCK, cm1_np.shape[1]), dtype=np.uint64)
        put_stream(template, 0, 0, b"", [], record_pg=True)
        cols = sorted(col.values())
        idle = cm1_np[row:na].reshape(n_idle, BLOCK, cm1_np.shape[1])
        idle[:, :, cols] = template[None, :, cols]
        cm1_np[row:na, col["addr"]] = np.repeat(
            np.arange(next_addr, next_addr + n_idle, dtype=np.uint64), BLOCK)
    return pg_requests
