"""Fiat-Shamir transcript (Poseidon-GL sponge), host-side and bit-exact.

Counterpart of ``xlayer_prover_tpu/stark/transcript.py``: pending buffer
of 8, state capacity of 4, 12-wide Poseidon output; ``get_fields1``
consumes the out buffer front-to-back and re-squeezes when drained; any
``put`` resets the out cursor; ``get_permutations`` packs 63-bit
little-endian draws.  It squeezes through the pure Python-int permutation
(``ops.poseidon_gl.host_permute``): a few hundred permutations per proof.
"""

from __future__ import annotations

from ..fields import gl
from ..ops.poseidon_gl import host_permute

STATE_SIZE = 4
PENDING_SIZE = 8
OUT_SIZE = 12


class Transcript:
    def __init__(self):
        self.state = [0] * STATE_SIZE
        self.pending = [0] * PENDING_SIZE
        self.out = [0] * OUT_SIZE
        self.pending_cursor = 0
        self.out_cursor = 0

    def _squeeze(self):
        inputs = list(self.pending) + list(self.state)
        self.out = host_permute(inputs)
        self.out_cursor = OUT_SIZE
        self.pending = [0] * PENDING_SIZE
        self.pending_cursor = 0
        self.state = self.out[:STATE_SIZE]

    def put(self, values):
        for v in values:
            self.pending[self.pending_cursor] = int(v) % gl.P
            self.pending_cursor += 1
            self.out_cursor = 0
            if self.pending_cursor == PENDING_SIZE:
                self._squeeze()

    def get_fields1(self) -> int:
        if self.out_cursor == 0:
            self._squeeze()
        res = self.out[(OUT_SIZE - self.out_cursor) % OUT_SIZE]
        self.out_cursor -= 1
        return res

    def get_field(self):
        """Draw a degree-3 extension challenge as a list of 3 ints."""
        return [self.get_fields1() for _ in range(3)]

    def get_permutations(self, n: int, n_bits: int):
        """Draw n indices of n_bits bits each (63 usable bits per field)."""
        total_bits = n * n_bits
        n_fields = (total_bits - 1) // 63 + 1
        fields = [self.get_fields1() for _ in range(n_fields)]
        res = []
        cur_field = 0
        cur_bit = 0
        for _ in range(n):
            a = 0
            for j in range(n_bits):
                bit = (fields[cur_field] >> cur_bit) & 1
                if bit:
                    a += 1 << j
                cur_bit += 1
                if cur_bit == 63:
                    cur_bit = 0
                    cur_field += 1
            res.append(a)
        return res
