"""SHA-256 compression as a gate circuit (the Sha256F SM's program).

The port's own copy of ``xlayer_prover_tpu/models/zkevm/sha256_gates.py``.

Equivalent of the reference's SHA-256 gate-script generator + executor
(tools/sm/sha256/, src/sm/sha256_f/, config/scripts/sha256_gates.json): one
512-bit block compression unrolls to XOR/ANDP gates; richer ops (AND, OR,
CH, MAJ, 32-bit ADD) are macro-expanded — NOT(a) = ANDP(a, ONE) since the
ONE wire carries all-ones lanes, ADD is a ripple-carry of CH/MAJ-style bit
logic.  Executes bit-packed through gates.execute or
gates.execute_all_wires_np.

Inputs: 256 state bits (h0..h7, MSB-first per word) then 512 message bits.
Outputs: 256 updated state bits.
"""

from __future__ import annotations

import functools

import numpy as np

from .gates import GateBuilder, GateScript, levelize

K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


class _W:
    """32-bit word as a list of 32 wire ids, MSB first."""

    def __init__(self, bits):
        assert len(bits) == 32
        self.bits = list(bits)


def _const_word(b: GateBuilder, value: int) -> _W:
    return _W([b.ONE if (value >> (31 - i)) & 1 else b.ZERO
               for i in range(32)])


def _not(b, w):
    return b.andp(w, b.ONE)


def _and(b, x, y):
    return b.andp(_not(b, x), y)


def _xor_w(b, *ws):
    return _W([b.xor_many([w.bits[i] for w in ws]) for i in range(32)])


def _and_w(b, x, y):
    return _W([_and(b, x.bits[i], y.bits[i]) for i in range(32)])


def _ch_w(b, e, f, g):
    # ch = (e & f) ^ (~e & g)
    return _W([b.xor(_and(b, e.bits[i], f.bits[i]),
                     b.andp(e.bits[i], g.bits[i])) for i in range(32)])


def _maj_w(b, x, y, z):
    return _W([b.xor(b.xor(_and(b, x.bits[i], y.bits[i]),
                           _and(b, x.bits[i], z.bits[i])),
                     _and(b, y.bits[i], z.bits[i])) for i in range(32)])


def _rotr(w: _W, n: int) -> _W:
    return _W(w.bits[-n:] + w.bits[:-n])


def _shr(b, w: _W, n: int) -> _W:
    return _W([b.ZERO] * n + w.bits[:-n])


def _add_w(b, x: _W, y: _W) -> _W:
    """Ripple-carry addition mod 2^32 (LSB = bits[31])."""
    out = [None] * 32
    carry = b.ZERO
    for i in range(31, -1, -1):
        a_, b_ = x.bits[i], y.bits[i]
        s = b.xor(b.xor(a_, b_), carry)
        # carry' = maj(a, b, carry)
        carry = b.xor(b.xor(_and(b, a_, b_), _and(b, a_, carry)),
                      _and(b, b_, carry))
        out[i] = s
    return _W(out)


def _add_many(b, *ws):
    acc = ws[0]
    for w in ws[1:]:
        acc = _add_w(b, acc, w)
    return acc


@functools.lru_cache(maxsize=None)
def build_script() -> GateScript:
    b = GateBuilder(n_inputs=256 + 512)
    state = [_W([b.input_wire(32 * k + i) for i in range(32)])
             for k in range(8)]
    w = [_W([b.input_wire(256 + 32 * k + i) for i in range(32)])
         for k in range(16)]

    for t in range(16, 64):
        s0 = _xor_w(b, _rotr(w[t - 15], 7), _rotr(w[t - 15], 18),
                    _shr(b, w[t - 15], 3))
        s1 = _xor_w(b, _rotr(w[t - 2], 17), _rotr(w[t - 2], 19),
                    _shr(b, w[t - 2], 10))
        w.append(_add_many(b, w[t - 16], s0, w[t - 7], s1))

    a, bb, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _xor_w(b, _rotr(e, 6), _rotr(e, 11), _rotr(e, 25))
        ch = _ch_w(b, e, f, g)
        temp1 = _add_many(b, h, S1, ch, _const_word(b, K[t]), w[t])
        S0 = _xor_w(b, _rotr(a, 2), _rotr(a, 13), _rotr(a, 22))
        maj = _maj_w(b, a, bb, c)
        temp2 = _add_w(b, S0, maj)
        h, g, f = g, f, e
        e = _add_w(b, d, temp1)
        d, c, bb = c, bb, a
        a = _add_w(b, temp1, temp2)

    outs = []
    for k, (s, v) in enumerate(zip(state, [a, bb, c, d, e, f, g, h])):
        outs.append(_add_w(b, s, v))
    output_wires = [bit for wrd in outs for bit in wrd.bits]
    return levelize(b, output_wires)


def pack_inputs(states: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """states (batch, 8) u32 words, blocks (batch, 16) u32 words ->
    (768, lanes) packed input bits (MSB-first per word)."""
    batch = states.shape[0]
    lanes = (batch + 31) // 32
    bits = np.zeros((768, lanes), dtype=np.uint32)
    for i in range(batch):
        word, pos = divmod(i, 32)
        for k in range(8):
            v = int(states[i, k])
            for z in range(32):
                if (v >> (31 - z)) & 1:
                    bits[32 * k + z, word] |= np.uint32(1 << pos)
        for k in range(16):
            v = int(blocks[i, k])
            for z in range(32):
                if (v >> (31 - z)) & 1:
                    bits[256 + 32 * k + z, word] |= np.uint32(1 << pos)
    return bits


def unpack_outputs(bits: np.ndarray, batch: int) -> np.ndarray:
    out = np.zeros((batch, 8), dtype=np.uint32)
    bits = np.asarray(bits)
    for i in range(batch):
        word, pos = divmod(i, 32)
        for k in range(8):
            v = 0
            for z in range(32):
                if (int(bits[32 * k + z, word]) >> pos) & 1:
                    v |= 1 << (31 - z)
            out[i, k] = v
    return out
