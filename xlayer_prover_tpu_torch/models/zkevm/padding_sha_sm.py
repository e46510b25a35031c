"""PaddingSha256 SM: provable SHA-256 padding for the hashS chain.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/padding_sha_sm.py``.

A re-design of the reference PaddingSha256 state machine
(src/sm/padding_sha256/padding_sha256_executor.cpp): one row per padded
byte on 64-byte statically aligned blocks with the FIPS-180 padding —
0x80 after the data, zeros, then the 8-byte big-endian bit length
closing the final block.

Mode-specific logic on top of padding_bytes.build_core:
  * a second countdown window ``rem + 8``: the stream can only end at a
    block boundary once the length suffix fits (j >= len + 8), tracked by
    rem8Zero/spare8 exactly like remZero/spare;
  * the suffix bytes: committed lenB0..7 decompose 8*len big-endian
    (byte-range-checked, unique), and the final block's positions 56+k
    are pinned to lenB_k through static lastHash shifts;
  * ``connected``/``hash0..7``/``BLOCKID``/``POSB``: the block-instance
    mapping for the sha_chain bit region (hash limbs are the big-endian
    sha256 digest in Main's op packing: op_j = word_{7-j}).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...fields import gl
from ...stark.air import AirBuilder, Const, FirstRowSelector
from .padding_bytes import (ByteStreamCore, ByteStreamInput, build_core,
                            fill_core_fixed, fill_core_stream)

BLOCK = 64

PaddingShaInput = ByteStreamInput


@dataclasses.dataclass
class PaddingShaLayout:
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
    padded = bytearray(data)
    padded.append(0x80)
    while len(padded) % BLOCK != BLOCK - 8:
        padded.append(0)
    padded += (8 * len(data)).to_bytes(8, "big")
    return bytes(padded)


def build(b: AirBuilder, n_bits: int, n_blocks: int) -> PaddingShaLayout:
    core = build_core(b, "PS", n_bits, BLOCK, n_blocks=n_blocks)
    w = dict(core.witness)
    fixed = dict(core.fixed)
    fixed["BLOCKID"] = b.fixed("PS_BLOCKID")
    fixed["POSB"] = b.fixed("PS_POSB")
    for k in range(8):
        fixed[f"LENPOS{k}"] = b.fixed(f"PS_LENPOS{k}")
    w["connected"] = b.witness("ps_connected")
    w["rem8Inv"] = b.witness("ps_rem8Inv")
    w["rem8Zero"] = b.witness("ps_rem8Zero")
    w["spare8"] = b.witness("ps_spare8")
    for k in range(8):
        w[f"lenB{k}"] = b.witness(f"ps_lenB{k}")
    for j in range(8):
        w[f"hash{j}"] = b.witness(f"ps_hash{j}")

    one = Const(1)
    act = fixed["ACTIVE"]
    nlast = fixed["NLAST"]
    lastch = fixed["LASTCH"]
    l1 = FirstRowSelector()

    # rem8 = rem + 8 countdown window (zero at j == len + 8)
    rem8 = w["rem"] + Const(8)
    b.constrain(w["rem8Zero"] * rem8)
    b.constrain(act * (one - w["rem8Zero"]) * (one - rem8 * w["rem8Inv"]))
    or8 = w["spare8"] + w["rem8Zero"] - w["spare8"] * w["rem8Zero"]
    b.constrain(l1 * w["spare8"])
    b.constrain(nlast * (w["spare8"].shifted() - or8))
    lh = w["lastHash"]
    b.constrain(lastch * (w["spare8"].shifted() - (one - lh) * or8))
    # stream end: first block boundary with the suffix in range
    b.constrain(lh - fixed["LAST"] * or8)

    # pad-byte values: 0x80 at j == len; zeros in the spare region except
    # the final block's last 8 positions, which hold 8*len big-endian
    b.constrain(act * w["remZero"] * (one - w["spare"])
                * (w["freeIn"] - Const(0x80)))
    suffix_sel = None
    for k in range(8):
        term = fixed[f"LENPOS{k}"] * lh.shifted(7 - k) if k < 7 \
            else fixed["LENPOS7"] * lh
        suffix_sel = term if suffix_sel is None else suffix_sel + term
        b.constrain(term * (w["freeIn"] - w[f"lenB{k}"]))
    b.constrain(w["spare"] * (one - suffix_sel) * w["freeIn"])
    # lenB: unique big-endian byte decomposition of 8*len
    recompose = None
    for k in range(8):
        t = w[f"lenB{k}"] * Const(1 << (8 * (7 - k)))
        recompose = t if recompose is None else recompose + t
        b.plookup([w[f"lenB{k}"]], [fixed["BYTE"]])
    b.constrain(act * (recompose - Const(8) * w["len"]))

    # connected: 0 at stream starts, 1 on continuation blocks
    b.constrain(l1 * w["connected"])
    b.constrain(nlast * (w["connected"].shifted() - w["connected"]))
    b.constrain(lastch * (w["connected"].shifted() - one + lh))

    return PaddingShaLayout(core=core, fixed=fixed, witness=w,
                            n_blocks=n_blocks)


def fill_fixed(layout: PaddingShaLayout, const_np: np.ndarray):
    fill_core_fixed(layout.core, const_np)
    na = layout.n_active
    r = np.arange(na)
    const_np[:na, layout.fixed["BLOCKID"].index] = r // BLOCK
    const_np[:na, layout.fixed["POSB"].index] = r % BLOCK
    for k in range(8):
        const_np[:na, layout.fixed[f"LENPOS{k}"].index] = \
            (r % BLOCK) == (BLOCK - 8 + k)


def expand_into(layout: PaddingShaLayout, inputs: List[PaddingShaInput],
                cm1_np: np.ndarray):
    """Fill committed columns; returns [(block64, connected)] per
    instance in block order."""
    import hashlib

    na = layout.n_active
    w = layout.witness
    col = {name: c.index for name, c in w.items()}
    inputs = sorted(inputs, key=lambda s: s.addr)
    if inputs:
        base = inputs[0].addr
        assert [s.addr for s in inputs] == \
            list(range(base, base + len(inputs))), \
            "hashS stream addresses must be contiguous"
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
        for bi in range(len(padded) // BLOCK):
            instances.append((padded[bi * BLOCK:(bi + 1) * BLOCK], bi > 0))
        scalar = int.from_bytes(hashlib.sha256(data).digest(), "big")
        ln = len(data)
        len_bytes = (8 * ln).to_bytes(8, "big")
        for j in range(len(padded)):
            rr = row + j
            cm1_np[rr, col["connected"]] = 1 if j >= BLOCK else 0
            rem8 = (ln + 8 - j) % gl.P
            if rem8:
                cm1_np[rr, col["rem8Inv"]] = gl.host_inv(rem8)
            else:
                cm1_np[rr, col["rem8Zero"]] = 1
            cm1_np[rr, col["spare8"]] = 1 if j > ln + 8 else 0
            for k in range(8):
                cm1_np[rr, col[f"lenB{k}"]] = len_bytes[k]
            if j == len(padded) - 1:
                for q in range(8):
                    cm1_np[rr, col[f"hash{q}"]] = \
                        (scalar >> (32 * q)) & 0xFFFFFFFF
        row += len(padded)

    for s in inputs:
        assert row + len(pad_bytes(s.data)) <= na, \
            "PaddingSha256 byte capacity exceeded"
        put_stream(s.addr, s.data, s.reads)
    while row < na:
        put_stream(next_addr, b"", [])
        next_addr += 1
    assert len(instances) == layout.n_blocks
    return instances
