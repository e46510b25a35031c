"""PaddingKK chain: byte streams -> padded blocks -> KeccakF instances.

The port's own copy of ``xlayer_prover_tpu/models/zkevm/padding_kk.py``.

Equivalent of the reference PaddingKK -> PaddingKKBit -> Bits2Field ->
KeccakF chain (src/sm/{padding_kk,padding_kkbit,bits2field,keccak_f}/):
each Main SM keccak hash request (an arbitrary byte stream) is padded to
136-byte sponge blocks (multi-rate 0x01..0x80), absorbed block-by-block
into chained Keccak-f states, and the per-block (state_in, state_out)
pairs become the packed instances the gate-circuit SM proves.

``expand`` returns both the per-stream block/trace metadata and the batch
of permutation instances; ``run_instances`` executes them through the
levelized gate script (bit-packed, on a device) and returns digests.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...ops.keccak import _host_keccak_f
from . import gates, keccak_gates

RATE = 136


@dataclasses.dataclass
class PaddedStream:
    data: bytes
    blocks: List[bytes]            # padded 136-byte blocks
    instance_ids: List[int]        # indices into the permutation batch
    digest: bytes = b""


def pad_stream(data: bytes) -> List[bytes]:
    padded = bytearray(data)
    pad_len = RATE - (len(padded) % RATE)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    return [bytes(padded[i:i + RATE]) for i in range(0, len(padded), RATE)]


def expand(streams: List[bytes]):
    """Returns (padded_streams, instance_states) where instance_states is a
    (n_instances, 25) uint64 array of Keccak-f INPUT states in chain order.

    Chained absorbs are data-dependent (block k+1's input state includes
    block k's output), so instances are generated by running the chain with
    the host permutation; the gate SM re-derives every output and the
    verifier's connection constraints tie the chain together.
    """
    padded_streams = []
    instances = []
    for data in streams:
        blocks = pad_stream(data)
        st = [0] * 25
        ids = []
        for blk in blocks:
            for i in range(RATE // 8):
                st[i] ^= int.from_bytes(blk[8 * i:8 * i + 8], "little")
            ids.append(len(instances))
            instances.append(list(st))
            st = _host_keccak_f(st)
        digest = b"".join(st_i.to_bytes(8, "little") for st_i in st[:4])
        padded_streams.append(PaddedStream(data=data, blocks=blocks,
                                           instance_ids=ids, digest=digest))
    states = np.array(instances, dtype=np.uint64) if instances else \
        np.zeros((0, 25), dtype=np.uint64)
    return padded_streams, states


def run_instances(states: np.ndarray, device=None) -> np.ndarray:
    """Execute all permutation instances through the gate circuit on
    `device` (None: the GPU)."""
    if states.shape[0] == 0:
        return np.zeros((0, 25), dtype=np.uint64)
    script = keccak_gates.build_script()
    packed = keccak_gates.pack_states(states)
    out_bits = gates.execute(script, packed, device=device)
    return keccak_gates.unpack_states(out_bits.cpu().numpy(),
                                      states.shape[0])


def digests_from_outputs(padded_streams: List[PaddedStream],
                         outputs: np.ndarray) -> List[bytes]:
    """Digest of each stream = first 4 lanes of its LAST block's output."""
    out = []
    for ps in padded_streams:
        last = outputs[ps.instance_ids[-1]]
        out.append(b"".join(int(last[i]).to_bytes(8, "little")
                            for i in range(4)))
    return out
