"""R1CS over BN254 Fr: constraint system + builder.

The port's own copy of ``xlayer_prover_tpu/snark/r1cs.py``.  The
circom-circuit equivalent layer for the final SNARK stage: the
reference's verifier circuits compile to R1CS consumed by rapidsnark
(src/rapidsnark/groth16.cpp, zkey_utils.cpp).  Wires: s[0] = 1, then
public inputs, then private witnesses; every constraint is
(A_k . s) * (B_k . s) = (C_k . s) with sparse coefficient rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..fields.bn254 import R


@dataclasses.dataclass
class R1CS:
    n_public: int                 # public inputs (excluding the 1 wire)
    n_wires: int                  # total including wire 0
    constraints: List[tuple]      # (A: dict, B: dict, C: dict) wire->coeff


class R1CSBuilder:
    """Author small circuits; wire 0 is the constant 1."""

    def __init__(self):
        self.n_wires = 1
        self.n_public = 0
        self.constraints: List[tuple] = []
        self._values: List[int] = [1]

    def public(self, value: int = 0) -> int:
        assert self.n_wires == 1 + self.n_public, \
            "declare publics before private wires"
        w = self.n_wires
        self.n_wires += 1
        self.n_public += 1
        self._values.append(value % R)
        return w

    def wire(self, value: int = 0) -> int:
        w = self.n_wires
        self.n_wires += 1
        self._values.append(value % R)
        return w

    def set_value(self, w: int, value: int):
        self._values[w] = value % R

    def constrain(self, a: Dict[int, int], b: Dict[int, int],
                  c: Dict[int, int]):
        self.constraints.append((
            {k: v % R for k, v in a.items()},
            {k: v % R for k, v in b.items()},
            {k: v % R for k, v in c.items()}))

    def mul(self, a: int, b: int) -> int:
        c = self.wire(self._values[a] * self._values[b] % R)
        self.constrain({a: 1}, {b: 1}, {c: 1})
        return c

    def add_lc(self, terms: Dict[int, int], const: int = 0) -> int:
        """Wire pinned to a linear combination (via a *1 constraint)."""
        val = (sum(self._values[w] * k for w, k in terms.items()) + const) % R
        c = self.wire(val)
        a = dict(terms)
        a[0] = a.get(0, 0) + const
        self.constrain(a, {0: 1}, {c: 1})
        return c

    def assert_eq_lc(self, terms: Dict[int, int], const: int, w: int):
        a = dict(terms)
        a[0] = a.get(0, 0) + const
        self.constrain(a, {0: 1}, {w: 1})

    def build(self) -> "R1CS":
        return R1CS(n_public=self.n_public, n_wires=self.n_wires,
                    constraints=list(self.constraints))

    def witness(self) -> List[int]:
        return list(self._values)


def check_witness(r1cs: R1CS, witness: List[int]) -> bool:
    for (a, b, c) in r1cs.constraints:
        av = sum(witness[w] * k for w, k in a.items()) % R
        bv = sum(witness[w] * k for w, k in b.items()) % R
        cv = sum(witness[w] * k for w, k in c.items()) % R
        if av * bv % R != cv:
            return False
    return True
