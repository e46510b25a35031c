"""Gate-circuit tracer for the recursion stack.

The port's own copy of ``xlayer_prover_tpu/recursion/circuit.py``: the
same gate program, op for op, so both packages lay out the same gate AIR.
The reference expresses its STARK verifiers as circom-generated circuits
(src/starkpil/*/witness) proven by compression STARKs whose rows are
12-wire PlonK-ish gates with copy constraints (c12a = "compression, 12
wires"; prover.cpp:591-645).  Here the same role is played by:

  * this tracer: records a straight-line gate program (arith gates,
    Poseidon permutations, witness hints) over abstract wires with static
    control flow, and can re-execute it to fill witnesses;
  * recursion/gate_air.py: lays the program out on a 12-wire AIR with
    Poseidon-round rows and a wide connection (copy-constraint) argument.

Gate semantics (one arith gate): qM*a*b + qL*a + qR*b + qO*c + qC = 0.
Hints introduce witness-only values (inverses, bit decompositions) that
are then pinned down by gates — the circom "signal <-- / ===" pattern.

``run`` is host Python: every Poseidon op goes through
``ops/poseidon_gl.host_permute``, and the inverse of each distinct output
coefficient -qO is computed once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from ..fields import gl
from ..fields.gl3 import _host_inv3
from ..ops.poseidon_gl import host_permute

P = gl.P


@dataclasses.dataclass
class Gate:
    a: int
    b: int
    c: Optional[int]
    qM: int
    qL: int
    qR: int
    qO: int
    qC: int


@dataclasses.dataclass
class PoseidonOp:
    inputs: List[int]      # 12 wires
    outputs: List[int]     # 12 wires


@dataclasses.dataclass
class HintOp:
    fn: Callable           # values(list for ins) -> list for outs
    ins: List[int]
    outs: List[int]


class Tracer:
    def __init__(self):
        self.n_wires = 0
        self.ops: list = []
        self.input_wires: List[int] = []
        self.public_wires: List[int] = []
        self._const_cache = {}
        self.scope = ""           # breadcrumb for witness-failure reports
        self._op_scopes: list = []
        self.zero = self.constant(0)
        self.one = self.constant(1)

    # -- wires -----------------------------------------------------------
    def _new(self) -> int:
        w = self.n_wires
        self.n_wires += 1
        return w

    def _op(self, op):
        self._op_scopes.append(self.scope)
        self.ops.append(op)

    def input(self) -> int:
        w = self._new()
        self.input_wires.append(w)
        return w

    def inputs(self, n: int) -> List[int]:
        return [self.input() for _ in range(n)]

    def mark_public(self, w: int):
        self.public_wires.append(w)

    def constant(self, value: int) -> int:
        value = int(value) % P
        hit = self._const_cache.get(value)
        if hit is not None:
            return hit
        c = self._new()
        # -c + value = 0
        self._op(Gate(a=c, b=c, c=c, qM=0, qL=0, qR=0, qO=P - 1, qC=value))
        self._const_cache[value] = c
        return c

    # -- base-field gates -------------------------------------------------
    def add(self, a: int, b: int) -> int:
        c = self._new()
        self._op(Gate(a, b, c, 0, 1, 1, P - 1, 0))
        return c

    def sub(self, a: int, b: int) -> int:
        c = self._new()
        self._op(Gate(a, b, c, 0, 1, P - 1, P - 1, 0))
        return c

    def mul(self, a: int, b: int) -> int:
        c = self._new()
        self._op(Gate(a, b, c, 1, 0, 0, P - 1, 0))
        return c

    def addc(self, a: int, k: int) -> int:
        c = self._new()
        self._op(Gate(a, a, c, 0, 1, 0, P - 1, int(k) % P))
        return c

    def mulc(self, a: int, k: int) -> int:
        c = self._new()
        self._op(Gate(a, a, c, 0, int(k) % P, 0, P - 1, 0))
        return c

    def mul_add(self, a: int, b: int, d: int) -> int:
        """a*b + d in two wires-limited gates."""
        return self.add(self.mul(a, b), d)

    def lin(self, pairs: Sequence[Tuple[int, int]], const: int = 0) -> int:
        """sum(k_i * w_i) + const via a chain of gates."""
        acc = None
        for (k, w) in pairs:
            if acc is None:
                acc = self.mulc(w, k) if k != 1 else w
            else:
                c = self._new()
                self._op(Gate(acc, w, c, 0, 1, int(k) % P, P - 1, 0))
                acc = c
        if acc is None:
            return self.constant(const)
        if const:
            acc = self.addc(acc, const)
        return acc

    def assert_eq(self, a: int, b: int):
        self._op(Gate(a, b, None, 0, 1, P - 1, 0, 0))

    def assert_zero(self, a: int):
        self._op(Gate(a, a, None, 0, 1, 0, 0, 0))

    def assert_const(self, a: int, k: int):
        self._op(Gate(a, a, None, 0, 1, 0, 0, (-int(k)) % P))

    def assert_bool(self, b: int):
        # b*b - b = 0
        self._op(Gate(b, b, None, 1, P - 1, 0, 0, 0))

    def select(self, bit: int, x: int, y: int) -> int:
        """bit ? x : y  (bit assumed boolean)."""
        return self.add(self.mul(bit, self.sub(x, y)), y)

    def is_zero(self, a: int) -> int:
        """1 if a == 0 else 0 (sound: a*z = 0 and a*ainv + z = 1)."""
        z, ainv = self.hint(
            lambda v: [1 if v[0] == 0 else 0,
                       0 if v[0] == 0 else pow(v[0], P - 2, P)], [a], 2)
        self.assert_zero(self.mul(a, z))
        self.assert_const(self.add(self.mul(a, ainv), z), 1)
        return z

    def all_eq(self, xs, ys) -> int:
        """1 if every xs[k] == ys[k] else 0 (product of is_zero diffs)."""
        acc = self.one
        for x, y in zip(xs, ys):
            acc = self.mul(acc, self.is_zero(self.sub(x, y)))
        return acc

    # -- hints ------------------------------------------------------------
    def hint(self, fn: Callable, ins: List[int], n_outs: int) -> List[int]:
        outs = [self._new() for _ in range(n_outs)]
        self._op(HintOp(fn=fn, ins=list(ins), outs=outs))
        return outs

    def inv(self, a: int) -> int:
        """1/a (a must be nonzero; constrained by a*w = 1)."""
        [w] = self.hint(lambda v: [pow(v[0], P - 2, P)], [a], 1)
        self.assert_const(self.mul(a, w), 1)
        return w

    def bits(self, x: int, n: int) -> List[int]:
        """Little-endian bit decomposition, constrained to recompose to x.

        Note: for n = 63 (a full transcript field draw) the decomposition
        of values below 2^63 - P would admit a second representative; the
        transcript outputs are Poseidon-uniform so this matches the
        reference verifier's num2bits usage."""
        bs = self.hint(lambda v: [(v[0] >> i) & 1 for i in range(n)],
                       [x], n)
        for b in bs:
            self.assert_bool(b)
        acc = self.lin([(1 << i, b) for i, b in enumerate(bs)])
        self.assert_eq(acc, x)
        return bs

    # -- poseidon ---------------------------------------------------------
    def poseidon(self, state: Sequence[int]) -> List[int]:
        assert len(state) == 12
        outs = [self._new() for _ in range(12)]
        self._op(PoseidonOp(inputs=list(state), outputs=outs))
        return outs

    # -- cubic-extension helpers (triples of wires) -----------------------
    def c3(self, w0: int, w1: int, w2: int):
        return (w0, w1, w2)

    def const3(self, vals):
        return tuple(self.constant(v) for v in vals)

    def add3(self, a, b):
        return tuple(self.add(a[k], b[k]) for k in range(3))

    def sub3(self, a, b):
        return tuple(self.sub(a[k], b[k]) for k in range(3))

    def mulc3(self, a, k: int):
        return tuple(self.mulc(a[k_], k) for k_ in range(3))

    def mul3(self, a, b):
        d0 = self.mul(a[0], b[0])
        d1 = self.add(self.mul(a[0], b[1]), self.mul(a[1], b[0]))
        d2 = self.add(self.add(self.mul(a[0], b[2]), self.mul(a[1], b[1])),
                      self.mul(a[2], b[0]))
        d3 = self.add(self.mul(a[1], b[2]), self.mul(a[2], b[1]))
        d4 = self.mul(a[2], b[2])
        # x^3 = x + 1 ; x^4 = x^2 + x
        return (self.add(d0, d3), self.add(d1, self.add(d3, d4)),
                self.add(d2, d4))

    def mul3_base(self, a, s: int):
        return tuple(self.mul(a[k], s) for k in range(3))

    def inv3(self, a):
        """Extension inverse via hint + product check."""
        ws = self.hint(lambda v: _host_inv3([v[0], v[1], v[2]]),
                       list(a), 3)
        prod = self.mul3(a, tuple(ws))
        self.assert_const(prod[0], 1)
        self.assert_zero(prod[1])
        self.assert_zero(prod[2])
        return tuple(ws)

    def assert_eq3(self, a, b):
        for k in range(3):
            self.assert_eq(a[k], b[k])

    def select3(self, bit: int, x, y):
        return tuple(self.select(bit, x[k], y[k]) for k in range(3))

    def pow_static(self, a, e: int):
        """a^e for a triple, static exponent (square and multiply)."""
        result = None
        base = a
        while e:
            if e & 1:
                result = base if result is None else self.mul3(result, base)
            e >>= 1
            if e:
                base = self.mul3(base, base)
        return result if result is not None else self.const3([1, 0, 0])

    # -- witness execution ------------------------------------------------
    def run(self, input_values: Sequence[int]) -> List[int]:
        """Execute the program; returns all wire values.  Raises
        ValueError when an assertion gate fails."""
        vals = [0] * self.n_wires
        if len(input_values) != len(self.input_wires):
            raise ValueError(f"{len(input_values)} inputs, expected "
                             f"{len(self.input_wires)}")
        for w, v in zip(self.input_wires, input_values):
            vals[w] = int(v) % P
        inv_negqo = {}
        for oi, op in enumerate(self.ops):
            if isinstance(op, Gate):
                rhs = (op.qM * vals[op.a] * vals[op.b] + op.qL * vals[op.a]
                       + op.qR * vals[op.b] + op.qC)
                if op.c is not None and op.qO != 0:
                    # c = (qM ab + qL a + qR b + qC) / (-qO)
                    k = inv_negqo.get(op.qO)
                    if k is None:
                        k = inv_negqo[op.qO] = pow((-op.qO) % P, P - 2, P)
                    vals[op.c] = rhs % P * k % P
                else:
                    if op.c is not None:
                        rhs += op.qO * vals[op.c]
                    if rhs % P != 0:
                        raise ValueError(
                            "assertion gate failed during witness "
                            f"generation (op {oi}, scope "
                            f"'{self._op_scopes[oi]}')")
            elif isinstance(op, PoseidonOp):
                out = host_permute([vals[w] for w in op.inputs])
                for w, v in zip(op.outputs, out):
                    vals[w] = v
            else:
                res = op.fn([vals[w] for w in op.ins])
                for w, v in zip(op.outs, res):
                    vals[w] = int(v) % P
        return vals

    def stats(self):
        gates = sum(1 for o in self.ops if isinstance(o, Gate))
        pos = sum(1 for o in self.ops if isinstance(o, PoseidonOp))
        return {"wires": self.n_wires, "gates": gates, "poseidons": pos}
