"""PLONK arithmetization over BN254 Fr (the circuit form fflonk proves).

The port's copy of ``xlayer_prover_tpu/snark/plonk.py`` (the reference's
fflonk prover consumes a PLONK-ified circom circuit via zkey_fflonk,
src/rapidsnark/fflonk_prover.hpp, zkey_fflonk.cpp): a 3-wire gate system
plus an R1CS converter, so the final circuit's R1CS
(``snark/final_circuit.py``) can be proven by Groth16 or by fflonk.

Gate equation (per row i):
    qM*a*b + qL*a + qR*b + qO*c + qC + PI = 0
Copy constraints: one permutation sigma over the 3n wire slots encoded as
S1,S2,S3 polynomials on cosets {1, k1, k2} (k1=2, k2=3), the standard
PLONK permutation argument.

Two forms of one circuit:

  * the list of ``PlonkGate`` objects (``r1cs_to_plonk``, ``plonk_witness``,
    ``check_plonk``, ``wire_columns``), as written in the JAX package, for
    small circuits and the tests;
  * ``PlonkArrays`` (``r1cs_to_arrays``): the five selector columns as
    (gates, 4) int64 Fr words and the a / b / c wire ids as int64, built
    in one pass over the R1CS without a Python object a gate, with the
    accumulation wires' values when a witness is given.  The fflonk prover
    on the card reads this form (``sigma`` gives the copy permutation).

Both give the same gates in the same order: R1CS wire w is PLONK wire
w + 1 (PLONK wire 0 is the constant zero), the public-input gates lead,
then per constraint the accumulation gates of A, B and C (one a term of a
linear combination that is not a single wire with coefficient 1), then its
multiplication gate; accumulation wires are numbered from n_wires + 1 in
gate order.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..fields.bn254 import R
from ..ops.bn254_mont import to_words
from .r1cs import R1CS, R1CSBuilder

SELECTORS = ("qL", "qR", "qM", "qO", "qC")


@dataclasses.dataclass
class PlonkGate:
    qM: int = 0
    qL: int = 0
    qR: int = 0
    qO: int = 0
    qC: int = 0
    a: int = 0          # wire ids (0 = the constant-zero wire)
    b: int = 0
    c: int = 0


def domain_size(n_gates: int) -> int:
    n = max(n_gates, 2)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class PlonkCircuit:
    gates: List[PlonkGate]
    n_public: int                # first n_public gates are PI gates
    n_wires: int

    @property
    def n(self) -> int:
        return domain_size(len(self.gates))


def r1cs_to_plonk(r1cs: R1CS) -> PlonkCircuit:
    """Each R1CS constraint (A.w)(B.w) = (C.w) becomes LC-accumulation
    gates + one multiplication gate.  R1CS wire 0 is the constant 1;
    PLONK wire 0 is constant 0, so R1CS wires map to id+1 and constants
    fold into qC."""
    gates: List[PlonkGate] = []
    n_plonk_wires = r1cs.n_wires + 1     # +1: plonk zero wire at 0
    next_wire = [n_plonk_wires]

    def fresh() -> int:
        w = next_wire[0]
        next_wire[0] += 1
        return w

    # public-input gates first (PLONK convention: PI rows lead)
    for i in range(r1cs.n_public):
        gates.append(PlonkGate(qL=1, a=i + 2))   # r1cs wire 1+i -> 2+i

    def lc_wire(lc: Dict[int, int]) -> Tuple[int, int]:
        """Reduce a linear combination to (wire, const): the value is
        wire_value + const.  Emits accumulation gates as needed."""
        const = lc.get(0, 0) % R
        terms = [(w, k % R) for (w, k) in lc.items() if w != 0 and k % R]
        if not terms:
            return 0, const
        if len(terms) == 1 and terms[0][1] == 1:
            return terms[0][0] + 1, const
        acc_wire = 0
        first = True
        for (w, k) in terms:
            if first:
                # acc = k*w  via gate: qL*k*a - acc = 0
                acc = fresh()
                gates.append(PlonkGate(qL=k, qO=R - 1, a=w + 1, c=acc))
                acc_wire = acc
                first = False
            else:
                acc = fresh()
                gates.append(PlonkGate(qL=1, qR=k, qO=R - 1,
                                       a=acc_wire, b=w + 1, c=acc))
                acc_wire = acc
        return acc_wire, const

    for (A, B, C) in r1cs.constraints:
        wa, ca = lc_wire(A)
        wb, cb = lc_wire(B)
        wc, cc = lc_wire(C)
        # (wa + ca)(wb + cb) = (wc + cc)
        # qM*a*b + cb*a + ca*b + (-1)*c + (ca*cb - cc) = 0
        gates.append(PlonkGate(qM=1, qL=cb % R, qR=ca % R, qO=R - 1,
                               qC=(ca * cb - cc) % R,
                               a=wa, b=wb, c=wc))
    return PlonkCircuit(gates=gates, n_public=r1cs.n_public,
                        n_wires=next_wire[0])


def plonk_witness(circuit: PlonkCircuit, r1cs: R1CS,
                  r1cs_witness: List[int]) -> List[int]:
    """Wire values for the converted circuit: plonk wire 0 = 0, wires
    1..n_r1cs = r1cs witness, accumulator wires re-derived by replaying
    the gates."""
    vals = [0] + [int(v) % R for v in r1cs_witness]
    vals += [0] * (circuit.n_wires - len(vals))
    for g in circuit.gates:
        if g.c != 0 and g.qO == R - 1 and g.qM == 0 and g.qC == 0:
            # accumulation gate: c = qL*a + qR*b
            vals[g.c] = (g.qL * vals[g.a] + g.qR * vals[g.b]) % R
    return vals


def check_plonk(circuit: PlonkCircuit, vals: List[int],
                publics: List[int]) -> bool:
    for i, g in enumerate(circuit.gates):
        pi = -int(publics[i]) % R if i < circuit.n_public else 0
        a, b, c = vals[g.a], vals[g.b], vals[g.c]
        if (g.qM * a * b + g.qL * a + g.qR * b + g.qO * c + g.qC + pi) \
                % R != 0:
            return False
    return True


def wire_columns(circuit: PlonkCircuit, vals: List[int]):
    """(a_col, b_col, c_col) of length n (zero-padded) + the copy
    permutation sigma over the 3n slots (slot j*n + i <-> column j row
    i); slots holding the same wire form a cycle."""
    n = circuit.n
    a = [0] * n
    b = [0] * n
    c = [0] * n
    occurrences: Dict[int, List[int]] = {}
    for i, g in enumerate(circuit.gates):
        a[i] = vals[g.a] if vals else 0
        b[i] = vals[g.b] if vals else 0
        c[i] = vals[g.c] if vals else 0
        for col, wire in ((0, g.a), (1, g.b), (2, g.c)):
            if wire != 0:
                occurrences.setdefault(wire, []).append(col * n + i)
    sigma = list(range(3 * n))
    for slots in occurrences.values():
        if len(slots) > 1:
            for idx, s in enumerate(slots):
                sigma[s] = slots[(idx + 1) % len(slots)]
    return (a, b, c), sigma


# ---------------------------------------------------------------------------
# The array form
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlonkArrays:
    """The gates of a PLONK circuit as columns: ``q[name]`` (gates, 4)
    int64 canonical Fr words for each of SELECTORS, ``wires`` (3, gates)
    int64 (a, b, c), in the gate order of ``r1cs_to_plonk``.  ``vals`` is
    the (n_wires, 4) word table of every wire's value when the circuit
    was built with a witness (None otherwise)."""
    q: Dict[str, np.ndarray]
    wires: np.ndarray
    n_public: int
    n_wires: int
    vals: Optional[np.ndarray] = None

    @property
    def n_gates(self) -> int:
        return int(self.wires.shape[1])

    @property
    def n(self) -> int:
        return domain_size(self.n_gates)


def r1cs_to_arrays(r1cs: R1CS,
                   witness: Optional[List[int]] = None) -> PlonkArrays:
    """``r1cs_to_plonk`` as columns, in one pass over the constraints; with
    `witness` (the R1CS witness) also every wire's value, as
    ``plonk_witness`` gives them.  One accumulation gate a term: a linear
    combination of terms (w_1, k_1) .. (w_m, k_m) becomes the gates
    acc_1 = k_1 w_1 (qL = k_1, qO = -1, a = w_1 + 1, c = acc_1) and
    acc_j = acc_{j-1} + k_j w_j (qL = 1, qR = k_j, qO = -1, a = acc_{j-1},
    b = w_j + 1, c = acc_j), unless it is one term with k = 1 (the wire
    itself) or none (the zero wire)."""
    n_pub = r1cs.n_public
    base = r1cs.n_wires + 1              # the first accumulation wire
    term_w: List[int] = []               # every accumulated term in order
    term_k: List[int] = []
    first: List[int] = []                # term index of each LC's first
    mul_at: List[int] = []               # terms before each mul gate
    mul_w: List[int] = []                # (wa, wb, wc) per constraint
    mul_q: List[int] = []                # (cb, ca, ca cb - cc) per constraint
    acc_vals: List[int] = []
    wit = None if witness is None else [int(v) % R for v in witness]
    add_w, add_k, add_acc = term_w.append, term_k.append, acc_vals.append
    for (A, B, C) in r1cs.constraints:
        cs = []
        for lc in (A, B, C):
            cs.append(lc.get(0, 0) % R)
            terms = [(w, k % R) for (w, k) in lc.items() if w != 0 and k % R]
            if not terms:
                mul_w.append(0)
            elif len(terms) == 1 and terms[0][1] == 1:
                mul_w.append(terms[0][0] + 1)
            else:
                first.append(len(term_w))
                acc = 0
                for w, k in terms:
                    add_w(w)
                    add_k(k)
                    if wit is not None:
                        acc = (acc + k * wit[w]) % R
                        add_acc(acc)
                mul_w.append(base + len(term_w) - 1)
        ca, cb, cc = cs
        mul_at.append(len(term_w))
        mul_q += [cb, ca, (ca * cb - cc) % R]

    n_terms, n_mul = len(term_w), len(r1cs.constraints)
    n_gates = n_pub + n_terms + n_mul
    # gate index of each mul gate; accumulation gates fill the rest in order
    mul_pos = n_pub + np.asarray(mul_at, dtype=np.int64) \
        + np.arange(n_mul, dtype=np.int64)
    is_acc = np.ones(n_gates, dtype=bool)
    is_acc[:n_pub] = False
    is_acc[mul_pos] = False
    acc_pos = np.nonzero(is_acc)[0]

    tw = np.asarray(term_w, dtype=np.int64) + 1
    is_first = np.zeros(n_terms, dtype=bool)
    is_first[np.asarray(first, dtype=np.int64)] = True
    acc_id = base + np.arange(n_terms, dtype=np.int64)
    prev = np.concatenate([[0], acc_id[:-1]]) if n_terms else acc_id
    wires = np.zeros((3, n_gates), dtype=np.int64)
    wires[0, :n_pub] = np.arange(n_pub, dtype=np.int64) + 2
    wires[0, acc_pos] = np.where(is_first, tw, prev)
    wires[1, acc_pos] = np.where(is_first, 0, tw)
    wires[2, acc_pos] = acc_id
    wires[:, mul_pos] = np.asarray(mul_w, dtype=np.int64).reshape(-1, 3).T

    k_words = to_words(term_k)
    mq = to_words(mul_q).reshape(n_mul, 3, 4)
    one, minus_one = to_words([1, R - 1])
    q = {name: np.zeros((n_gates, 4), dtype=np.int64) for name in SELECTORS}
    q["qL"][:n_pub] = one
    q["qL"][acc_pos] = np.where(is_first[:, None], k_words, one)
    q["qR"][acc_pos] = np.where(is_first[:, None], 0, k_words)
    q["qO"][acc_pos] = minus_one
    q["qM"][mul_pos] = one
    q["qL"][mul_pos] = mq[:, 0]
    q["qR"][mul_pos] = mq[:, 1]
    q["qO"][mul_pos] = minus_one
    q["qC"][mul_pos] = mq[:, 2]

    vals = None
    if wit is not None:
        vals = to_words([0] + wit + acc_vals)
    return PlonkArrays(q=q, wires=wires, n_public=n_pub,
                       n_wires=base + n_terms, vals=vals)


def arrays_of(circuit: PlonkCircuit,
              vals: Optional[List[int]] = None) -> PlonkArrays:
    """The list form -> the array form (``vals``, when given, the wire
    values of ``plonk_witness``)."""
    g = circuit.gates
    q = {name: to_words(getattr(x, name) % R for x in g).reshape(-1, 4)
         for name in SELECTORS}
    wires = np.array([[x.a for x in g], [x.b for x in g], [x.c for x in g]],
                     dtype=np.int64).reshape(3, len(g))
    return PlonkArrays(q=q, wires=wires, n_public=circuit.n_public,
                       n_wires=circuit.n_wires,
                       vals=None if vals is None else to_words(vals))


def sigma(wires: torch.Tensor, n: int) -> torch.Tensor:
    """``wire_columns``'s copy permutation from (3, gates) wire ids on any
    device: (3 n,) int64, slot j n + i <-> column j row i.  The slots of
    one wire form a cycle in the order ``wire_columns`` appends them, gate
    by gate and a, b, c within a gate, so one stable sort of the 3 gates
    slots by wire, taken in that order, lists each cycle."""
    g = wires.shape[1]
    dev = wires.device
    row = torch.arange(g, dtype=torch.int64, device=dev)
    slot = (torch.arange(3, dtype=torch.int64, device=dev)[:, None] * n
            + row).T.reshape(-1)                 # (gate, column) order
    wire = wires.T.reshape(-1)
    live = wire != 0
    wire, slot = wire[live], slot[live]
    wire, order = torch.sort(wire, stable=True)
    slot = slot[order]
    # each slot points at the next slot of its wire; the last of a run at
    # its first
    nxt = torch.roll(slot, -1)
    starts = torch.ones_like(wire, dtype=torch.bool)
    starts[1:] = wire[1:] != wire[:-1]
    run_first = slot[torch.cummax(torch.where(
        starts, torch.arange(wire.shape[0], device=dev), 0), 0).values]
    ends = torch.roll(starts, -1)
    out = torch.arange(3 * n, dtype=torch.int64, device=dev)
    out[slot] = torch.where(ends, run_first, nxt)
    return out


def seeded_r1cs(seed: int, n_constraints: int, n_public: int = 4):
    """A satisfied R1CS drawn from random.Random(seed), with the shapes of
    a final circuit's: `n_public` publics, then constraints (A.s)(B.s) =
    (C.s) over linear combinations of 1 to 5 earlier wires, their
    coefficients 1, r - 1, small or uniform, constants (wire 0) on either
    side, one-term combinations of coefficient 1 and not, wires used again
    across constraints and columns, and C of one new wire with a
    coefficient and a constant.  -> (R1CS, witness)"""
    rng = random.Random(seed)
    b = R1CSBuilder()
    wires = [b.public(rng.randrange(R)) for _ in range(n_public)]
    wires += [b.wire(rng.randrange(R)) for _ in range(4)]
    vals = b.witness()

    def coef() -> int:
        return rng.choice([1, 1, R - 1, rng.randrange(2, 9),
                           rng.randrange(R)])

    def lc() -> Dict[int, int]:
        terms = {rng.choice(wires): coef()
                 for _ in range(rng.choice([1, 1, 1, 2, 3, 5]))}
        if rng.random() < 0.3:
            terms[0] = rng.choice([1, rng.randrange(R)])
        return terms

    def value(terms) -> int:
        return sum(vals[w] * k for w, k in terms.items()) % R

    while len(b.constraints) < n_constraints:
        A, B = lc(), lc()
        k, k0 = rng.choice([1, 1, coef()]), rng.choice([0, 0, coef()])
        v = (value(A) * value(B) - k0) * pow(k, R - 2, R) % R
        c = b.wire(v)
        vals = b.witness()
        C = {c: k}
        if k0:
            C[0] = k0
        b.constrain(A, B, C)
        wires.append(c)
    return b.build(), b.witness()
