"""Shared byte-stream padding core for the hash padding SMs.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/padding_bytes.py``.
The reference's PaddingPG / PaddingKK / PaddingSha256 executors
(src/sm/padding_pg/, padding_kk/, padding_sha256/) share one skeleton: a
row per padded byte, per-stream registers (addr/len/rem/spare), chunk-read
registers replaying Main's byte accesses, and block-aligned latch rows.
This module builds that common column group + constraints once; each
padding SM adds its hash-specific binding (PoseidonG block lookups for PG,
the bit/packing region for KK/SHA) on top.

Design notes (vs the reference pils): blocks are statically aligned to
``row % block_bytes`` with a fixed-inactive domain tail; acc/crV
accumulate inclusive of the current row's byte so exported values stay
degree-1; ``lastHash`` doubles as the len/digest latch selector.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...fields import gl
from ...stark.air import AirBuilder, Const, FirstRowSelector

P = gl.P
MAX_READ = 32


@dataclasses.dataclass
class ByteStreamInput:
    """One hash stream (reference Padding*ExecutorInput)."""
    addr: int
    data: bytes
    reads: List[int]          # read lengths partitioning the padded bytes
    len_called: bool = False
    digest_called: bool = False


@dataclasses.dataclass
class ByteStreamCore:
    n_bits: int
    block_bytes: int
    n_active: int
    fixed: dict
    witness: dict
    prefix: str

    def pos_expr(self):
        """Start position of the latched read: len - rem - crLen + 1."""
        w = self.witness
        return w["len"] - w["rem"] - w["crLen"] + Const(1)


def build_core(b: AirBuilder, prefix: str, n_bits: int, block_bytes: int,
               n_blocks: int = None) -> ByteStreamCore:
    """Common padding columns + constraints; ``n_blocks`` caps the active
    region (default: as many whole blocks as fit the domain)."""
    n = 1 << n_bits
    max_blocks = n // block_bytes
    if n_blocks is None:
        n_blocks = max_blocks
    assert 1 <= n_blocks <= max_blocks
    n_active = block_bytes * n_blocks
    assert n_active < n, "need a fixed-inactive tail row"
    assert n >= 512, "byte table needs 256 rows + >=1 block"

    fixed = {name: b.fixed(f"{prefix}_{name}")
             for name in ("ACTIVE", "LAST", "LASTCH", "NLAST", "BFIRST",
                          "CRSEL", "CROFF", "BYTE")}
    for k in range(8):
        fixed[f"CRFT{k}"] = b.fixed(f"{prefix}_CRFT{k}")

    w = {}
    for name in ("freeIn", "addr", "len", "rem", "remInv", "remZero",
                 "spare", "lastHash", "incCounter", "crLen", "crOffset",
                 "crOffsetInv", "crLatch"):
        w[name] = b.witness(f"{prefix.lower()}_{name}")
    for k in range(8):
        w[f"crV{k}"] = b.witness(f"{prefix.lower()}_crV{k}")
        w[f"crF{k}"] = b.witness(f"{prefix.lower()}_crF{k}")

    one = Const(1)
    act = fixed["ACTIVE"]
    last = fixed["LAST"]
    lastch = fixed["LASTCH"]
    nlast = fixed["NLAST"]
    l1 = FirstRowSelector()

    # ---- row-0 stream/read start ------------------------------------
    b.constrain(l1 * (w["rem"] - w["len"]))
    b.constrain(l1 * w["spare"])
    b.constrain(l1 * (w["incCounter"] - one))
    b.constrain(l1 * (w["crOffset"] - w["crLen"] + one))
    for k in range(8):
        b.constrain(l1 * (w[f"crV{k}"] - w["freeIn"] * w[f"crF{k}"]))

    # ---- helper flags ------------------------------------------------
    rem_or = w["spare"] + w["remZero"] - w["spare"] * w["remZero"]
    b.constrain(w["remZero"] * w["rem"])
    b.constrain(act * (one - w["remZero"])
                * (one - w["rem"] * w["remInv"]))
    b.constrain(w["spare"] * (one - w["spare"]))
    b.constrain(w["crLatch"] * w["crOffset"])
    b.constrain(act * (one - w["crLatch"])
                * (one - w["crOffset"] * w["crOffsetInv"]))
    b.constrain((one - act) * w["crLatch"])
    # stream ends only on a read boundary
    b.constrain(w["lastHash"] * (one - w["crLatch"]))

    # byte range; the lastHash definition and the pad-byte value rules
    # are mode-specific (bind_multirate / the SHA suffix rules)
    b.plookup([w["freeIn"]], [fixed["BYTE"]])

    # ---- chunk-read registers ---------------------------------------
    b.plookup([w["crOffset"]] + [w[f"crF{k}"] for k in range(8)],
              [fixed["CROFF"]] + [fixed[f"CRFT{k}"] for k in range(8)],
              f_sel=act, t_sel=fixed["CRSEL"])
    chg = nlast + lastch
    b.constrain(chg * (one - w["crLatch"])
                * (w["crOffset"].shifted() - w["crOffset"] + one))
    b.constrain(chg * w["crLatch"]
                * (w["crOffset"].shifted() - w["crLen"].shifted() + one))
    b.constrain(chg * (one - w["crLatch"])
                * (w["crLen"].shifted() - w["crLen"]))
    for k in range(8):
        b.constrain(chg * w["crLatch"]
                    * (w[f"crV{k}"].shifted() - w["freeIn"].shifted()
                       * w[f"crF{k}"].shifted()))
        b.constrain(chg * (one - w["crLatch"])
                    * (w[f"crV{k}"].shifted() - w[f"crV{k}"]
                       - w["freeIn"].shifted()
                       * w[f"crF{k}"].shifted()))

    # ---- stream registers -------------------------------------------
    b.constrain(nlast * (w["rem"].shifted() - w["rem"] + one))
    b.constrain(nlast * (w["len"].shifted() - w["len"]))
    b.constrain(nlast * (w["addr"].shifted() - w["addr"]))
    b.constrain(nlast * (w["spare"].shifted() - rem_or))
    b.constrain(nlast * (w["incCounter"].shifted() - w["incCounter"]))

    lh = w["lastHash"]
    b.constrain(lastch * (w["rem"].shifted() - lh * w["len"].shifted()
                          - (one - lh) * (w["rem"] - one)))
    b.constrain(lastch * (one - lh) * (w["len"].shifted() - w["len"]))
    b.constrain(lastch * (w["addr"].shifted() - w["addr"] - lh))
    b.constrain(lastch * (w["spare"].shifted() - (one - lh) * rem_or))
    b.constrain(lastch * (w["incCounter"].shifted() - one
                          - (one - lh) * w["incCounter"]))

    return ByteStreamCore(n_bits=n_bits, block_bytes=block_bytes,
                          n_active=n_active, fixed=fixed, witness=w,
                          prefix=prefix)


def bind_multirate(b: AirBuilder, core: ByteStreamCore):
    """0x01 ... 0x80 padding: streams end at the first block boundary at
    or past the 0x01 byte (PG sponge + keccak semantics)."""
    w = core.witness
    one = Const(1)
    rem_or = w["spare"] + w["remZero"] - w["spare"] * w["remZero"]
    b.constrain(w["lastHash"] - core.fixed["LAST"] * rem_or)
    pad80 = Const(0x80) * w["lastHash"]
    b.constrain(core.fixed["ACTIVE"] * w["remZero"] * (one - w["spare"])
                * (w["freeIn"] - one - pad80))
    b.constrain(w["spare"] * (w["freeIn"] - pad80))


def fill_core_fixed(core: ByteStreamCore, const_np: np.ndarray):
    n = const_np.shape[0]
    na = core.n_active
    bb = core.block_bytes
    fx = core.fixed
    r = np.arange(n)
    in_block = r % bb
    active = (r < na).astype(np.uint64)
    const_np[:, fx["ACTIVE"].index] = active
    last = ((in_block == bb - 1) & (r < na)).astype(np.uint64)
    const_np[:, fx["LAST"].index] = last
    const_np[:, fx["LASTCH"].index] = last * (r + 1 < na)
    const_np[:, fx["NLAST"].index] = active * (in_block != bb - 1)
    const_np[:, fx["BFIRST"].index] = active * (in_block == 0)
    off = np.arange(MAX_READ)
    const_np[:MAX_READ, fx["CRSEL"].index] = 1
    const_np[:MAX_READ, fx["CROFF"].index] = off
    for k in range(8):
        const_np[:MAX_READ, fx[f"CRFT{k}"].index] = \
            np.where(off // 4 == k,
                     np.uint64(1) << ((off % 4) * 8).astype(np.uint64), 0)
    const_np[:256, fx["BYTE"].index] = np.arange(256)


def pad_multirate(data: bytes, block_bytes: int) -> bytes:
    """0x01 ... 0x80 padding (shared by the PG sponge and keccak)."""
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % block_bytes:
        padded.append(0)
    padded[-1] |= 0x80
    return bytes(padded)


def fill_core_stream(core: ByteStreamCore, cm1_np: np.ndarray, row: int,
                     addr: int, data: bytes, reads: List[int],
                     padded: bytes):
    """Fill the common columns for one stream starting at ``row``;
    returns the row past the stream."""
    col = {name: c.index for name, c in core.witness.items()}
    ln = len(data)
    reads = list(reads) + [1] * (len(padded) - sum(reads))
    assert sum(reads) == len(padded), "reads overrun the padded stream"
    r_i = 0
    cr_off = reads[0] - 1
    cr_len = reads[0]
    cr_v = [0] * 8
    bb = core.block_bytes
    for j, byte in enumerate(padded):
        rr = row + j
        cm1_np[rr, col["freeIn"]] = byte
        cm1_np[rr, col["addr"]] = addr
        cm1_np[rr, col["len"]] = ln
        rem = (ln - j) % P
        cm1_np[rr, col["rem"]] = rem
        if rem:
            cm1_np[rr, col["remInv"]] = gl.host_inv(rem)
        else:
            cm1_np[rr, col["remZero"]] = 1
        cm1_np[rr, col["spare"]] = 1 if j > ln else 0
        if j == len(padded) - 1:
            cm1_np[rr, col["lastHash"]] = 1
        cm1_np[rr, col["incCounter"]] = j // bb + 1
        limb, csh = cr_off // 4, 8 * (cr_off % 4)
        cr_v[limb] += byte << csh
        cm1_np[rr, col["crLen"]] = cr_len
        cm1_np[rr, col["crOffset"]] = cr_off
        if cr_off:
            cm1_np[rr, col["crOffsetInv"]] = gl.host_inv(cr_off)
        cm1_np[rr, col[f"crF{limb}"]] = 1 << csh
        for k in range(8):
            cm1_np[rr, col[f"crV{k}"]] = cr_v[k]
        if cr_off == 0:
            cm1_np[rr, col["crLatch"]] = 1
            r_i += 1
            if r_i < len(reads):
                cr_len = reads[r_i]
                cr_off = cr_len - 1
                cr_v = [0] * 8
        else:
            cr_off -= 1
    return row + len(padded)
