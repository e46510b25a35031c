"""PaddingKK SM: provable keccak sponge padding for the hashK chain.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/padding_kk_sm.py``.

A re-design of the reference PaddingKK state machine
(src/sm/padding_kk/padding_kk_executor.cpp; padding_kk.pil shape): one row
per padded byte on 136-byte statically aligned blocks.  The byte/stream/
chunk-read skeleton comes from padding_bytes.build_core; this module adds

  * ``connected``: whether a block continues the previous block's sponge
    state (reference pols.connected, padding_kk_executor.cpp) — 0 at each
    stream's first block, 1 afterwards;
  * ``hash0..7``: the stream digest as 8x32-bit limbs, committed at the
    lastHash latch (reference hash0..7 broadcast);
  * fixed ``BLOCKID``/``POSB``: the static block-instance mapping — block
    b of the byte region IS permutation instance b of the keccak bit/gate
    chain (keccak_chain_sm binds bytes, connected flags and digests).

Main's hashK/hashK1/hashKLen/hashKDigest rows bind against the chunk-read
latches, len and digest exactly like the PaddingPG pattern.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...ops.keccak import _host_keccak_f
from ...stark.air import AirBuilder, Const, FirstRowSelector
from .padding_bytes import (ByteStreamCore, ByteStreamInput,
                            bind_multirate, build_core, fill_core_fixed,
                            fill_core_stream, pad_multirate)

BLOCK = 136       # keccak-256 rate bytes

PaddingKKInput = ByteStreamInput


@dataclasses.dataclass
class PaddingKKLayout:
    core: ByteStreamCore
    fixed: dict
    witness: dict
    n_blocks: int

    @property
    def n_active(self):
        return self.core.n_active

    def pos_expr(self):
        return self.core.pos_expr()


def pad_bytes(data: bytes) -> bytes:
    return pad_multirate(data, BLOCK)


def build(b: AirBuilder, n_bits: int, n_blocks: int) -> PaddingKKLayout:
    core = build_core(b, "PK", n_bits, BLOCK, n_blocks=n_blocks)
    bind_multirate(b, core)
    w = dict(core.witness)
    fixed = dict(core.fixed)
    fixed["BLOCKID"] = b.fixed("PK_BLOCKID")
    fixed["POSB"] = b.fixed("PK_POSB")
    w["connected"] = b.witness("pk_connected")
    for j in range(8):
        w[f"hash{j}"] = b.witness(f"pk_hash{j}")

    one = Const(1)
    l1 = FirstRowSelector()
    b.constrain(l1 * w["connected"])
    b.constrain(fixed["NLAST"] * (w["connected"].shifted()
                                  - w["connected"]))
    b.constrain(fixed["LASTCH"] * (w["connected"].shifted()
                                   - one + w["lastHash"]))
    return PaddingKKLayout(core=core, fixed=fixed, witness=w,
                           n_blocks=n_blocks)


def fill_fixed(layout: PaddingKKLayout, const_np: np.ndarray):
    fill_core_fixed(layout.core, const_np)
    na = layout.n_active
    r = np.arange(na)
    const_np[:na, layout.fixed["BLOCKID"].index] = r // BLOCK
    const_np[:na, layout.fixed["POSB"].index] = r % BLOCK


def expand_into(layout: PaddingKKLayout, inputs: List[PaddingKKInput],
                cm1_np: np.ndarray):
    """Fill committed columns; returns the instance list
    [(data_bytes_of_block, connected)] in block order (one entry per
    instance, idle blocks are empty streams)."""
    na = layout.n_active
    w = layout.witness
    col = {name: c.index for name, c in w.items()}
    inputs = sorted(inputs, key=lambda s: s.addr)
    if inputs:
        base = inputs[0].addr
        assert [s.addr for s in inputs] == \
            list(range(base, base + len(inputs))), \
            "hashK stream addresses must be contiguous"
        next_addr = base + len(inputs)
    else:
        next_addr = 0

    instances = []
    row = 0

    def put_stream(addr, data, reads):
        nonlocal row
        padded = pad_bytes(data)
        fill_core_stream(layout.core, cm1_np, row, addr, data, reads,
                         padded)
        # digest limbs: big-endian keccak-256 of the stream, split into
        # 8x32-bit little-limb order (fea-style op packing)
        st = [0] * 25
        n_blk = len(padded) // BLOCK
        for bi in range(n_blk):
            blk = padded[bi * BLOCK:(bi + 1) * BLOCK]
            for k in range(BLOCK // 8):
                st[k] ^= int.from_bytes(blk[8 * k:8 * k + 8], "little")
            instances.append((blk, bi > 0))
            st = _host_keccak_f(st)
        digest = b"".join(v.to_bytes(8, "little") for v in st[:4])
        scalar = int.from_bytes(digest, "big")
        for j, byte in enumerate(padded):
            rr = row + j
            cm1_np[rr, col["connected"]] = 1 if j >= BLOCK else 0
            if j == len(padded) - 1:
                for q in range(8):
                    cm1_np[rr, col[f"hash{q}"]] = \
                        (scalar >> (32 * q)) & 0xFFFFFFFF
        row += len(padded)

    for s in inputs:
        assert row + len(pad_bytes(s.data)) <= na, \
            "PaddingKK byte capacity exceeded"
        put_stream(s.addr, s.data, s.reads)
    while row < na:
        put_stream(next_addr, b"", [])
        next_addr += 1
    assert len(instances) == layout.n_blocks
    return instances
