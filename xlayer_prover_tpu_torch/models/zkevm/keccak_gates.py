"""Keccak-f[1600] as a gate circuit (the KeccakF SM's program).

The port's own copy of ``xlayer_prover_tpu/models/zkevm/keccak_gates.py``.

Equivalent of the reference's build-time keccak script generator
(tools/sm/keccak_f/keccak_gen.cpp + config keccakScriptFile): the
permutation unrolls into XOR/ANDP gates over 1600 state-bit wires; rho/pi
are pure wire permutations, chi is a ^ ((~b) & c), iota XORs the constant-1
wire into the bits set in RC.  The generated script executes bit-packed
through gates.execute (a device) or gates.execute_all_wires_np (the
host).
"""

from __future__ import annotations

import functools

import numpy as np

from ...ops.keccak import NUM_ROUNDS, round_constants, rotation_offsets
from .gates import GateBuilder, GateScript, levelize


def _bit_index(x: int, y: int, z: int) -> int:
    """State bit (x, y, z) -> input index (lane x+5y, bit z, LE)."""
    return 64 * (x + 5 * y) + z


@functools.lru_cache(maxsize=None)
def build_script() -> GateScript:
    b = GateBuilder(n_inputs=1600)
    rc = round_constants()
    rot = rotation_offsets()

    # wires[x][y][z]
    a = [[[b.input_wire(_bit_index(x, y, z)) for z in range(64)]
          for y in range(5)] for x in range(5)]

    for ir in range(NUM_ROUNDS):
        # theta
        c = [[b.xor_many([a[x][y][z] for y in range(5)]) for z in range(64)]
             for x in range(5)]
        d = [[b.xor(c[(x - 1) % 5][z], c[(x + 1) % 5][(z - 1) % 64])
              for z in range(64)] for x in range(5)]
        a = [[[b.xor(a[x][y][z], d[x][z]) for z in range(64)]
              for y in range(5)] for x in range(5)]
        # rho + pi (wire permutation)
        bb = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                r = rot[x][y]
                bb[y][(2 * x + 3 * y) % 5] = [a[x][y][(z - r) % 64]
                                              for z in range(64)]
        # chi
        a = [[[b.xor(bb[x][y][z],
                     b.andp(bb[(x + 1) % 5][y][z], bb[(x + 2) % 5][y][z]))
               for z in range(64)] for y in range(5)] for x in range(5)]
        # iota
        for z in range(64):
            if (rc[ir] >> z) & 1:
                a[0][0][z] = b.xor(a[0][0][z], b.ONE)

    outputs = [a[x][y][z] for y in range(5) for x in range(5)
               for z in range(64)]
    return levelize(b, outputs)


def pack_states(states_u64: np.ndarray) -> np.ndarray:
    """(batch, 25) uint64 lanes -> (1600, ceil(batch/32)) uint32 packed bits.

    Instance i lives in bit (i % 32) of packed word (i // 32)."""
    batch = states_u64.shape[0]
    lanes = (batch + 31) // 32
    bits = np.zeros((1600, lanes), dtype=np.uint32)
    for i in range(batch):
        word, bitpos = divmod(i, 32)
        for lane in range(25):
            v = int(states_u64[i, lane])
            for z in range(64):
                if (v >> z) & 1:
                    bits[64 * lane + z, word] |= np.uint32(1 << bitpos)
    return bits


def unpack_states(bits: np.ndarray, batch: int) -> np.ndarray:
    out = np.zeros((batch, 25), dtype=np.uint64)
    bits = np.asarray(bits)
    for i in range(batch):
        word, bitpos = divmod(i, 32)
        for lane in range(25):
            v = 0
            for z in range(64):
                if (int(bits[64 * lane + z, word]) >> bitpos) & 1:
                    v |= 1 << z
            out[i, lane] = v
    return out
