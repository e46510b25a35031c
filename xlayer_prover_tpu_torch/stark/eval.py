"""Constraint-expression evaluation over whole-column tensors.

Counterpart of ``xlayer_prover_tpu/stark/eval.py``: the expression DAG is
evaluated as tensor ops over full columns, or over a window of rows of
the domain, one code path for every circuit.  Values are tagged ('base', tensor) or ('ext', triple) so
base-field subtrees do not pay the 3x extension cost; promotion happens at
the first mixed op.  ``ScalarEnv`` is the verifier's Python-int evaluator.
"""

from __future__ import annotations

import torch

from .. import device as dev
from ..fields import gl, gl3
from .air import (BinOp, Challenge, Col, Const, Expr, FirstRowSelector,
                  Public, XSymbol)


class EvalEnv:
    """Evaluation environment for one domain (natural H or extended coset).

    sections: dict name -> (rows, width) int64 tensor.
    challenges: dict slot -> gl3 scalar (triple of 0-d tensors).
    publics: list of 0-d tensors.
    x: (rows,) domain values; l1: (rows,) L1 values.
    shift_rows: row distance of "next" (1 on H, blowup on the ext domain).
    refcounts: optional ``count_refs`` map; an entry of the memo is then
    dropped after its last use, so peak memory is the live frontier.
    window: None for whole columns (a shifted column is rolled, once per
    env); else the number of rows B of a window [r0, r0 + B) of the
    domain, and each section holds the window and its halo: row j is
    domain row (r0 + j) mod rows, for j < B + max_shift * shift_rows
    (``halo_rows``).  A column shifted by s is then the slice
    [s * shift_rows, s * shift_rows + B) of its section, with no copy;
    x and l1 hold the window's B rows.
    """

    def __init__(self, sections, challenges, publics, x, l1, shift_rows: int,
                 refcounts=None, window: int | None = None):
        self.sections = sections
        self.challenges = challenges
        self.publics = publics
        self.x = x
        self.l1 = l1
        self.shift_rows = shift_rows
        self.window = window
        self.device = x.device
        self._memo = {}
        # whole columns: the same (section, index, shift) appears in many
        # Col nodes, so each shifted column is rolled once per env
        self._col_cache = {}
        self._consts = {}
        self._remaining = dict(refcounts) if refcounts else None

    # -- tagged-value helpers -------------------------------------------
    @staticmethod
    def _add(a, b):
        ka, va = a
        kb, vb = b
        if ka == "base" and kb == "base":
            return ("base", gl.add(va, vb))
        if ka == "base":
            return ("ext", gl3.add_base(vb, va))
        if kb == "base":
            return ("ext", gl3.add_base(va, vb))
        return ("ext", gl3.add(va, vb))

    @staticmethod
    def _sub(a, b):
        ka, va = a
        kb, vb = b
        if ka == "base" and kb == "base":
            return ("base", gl.sub(va, vb))
        if ka == "base":
            return ("ext", gl3.base_sub(va, vb))
        if kb == "base":
            return ("ext", gl3.sub_base(va, vb))
        return ("ext", gl3.sub(va, vb))

    @staticmethod
    def _mul(a, b):
        ka, va = a
        kb, vb = b
        if ka == "base" and kb == "base":
            return ("base", gl.mul(va, vb))
        if ka == "base":
            return ("ext", gl3.mul_base(vb, va))
        if kb == "base":
            return ("ext", gl3.mul_base(va, vb))
        return ("ext", gl3.mul(va, vb))

    # -- evaluation ------------------------------------------------------
    def eval(self, e: Expr):
        """Returns a tagged value; vectors broadcast over the domain rows."""
        key = id(e)
        hit = self._memo.get(key)
        if hit is not None and hit[0] is e:
            if self._remaining is not None:
                self._remaining[key] -= 1
                if self._remaining[key] <= 0:
                    del self._memo[key]
            return hit[1]
        v = self._eval(e)
        if self._remaining is None:
            # keep the expr object alive so a GC'd node can't recycle its id
            self._memo[key] = (e, v)
        else:
            rc = self._remaining.get(key, 1)
            if rc > 1:
                self._memo[key] = (e, v)
                self._remaining[key] = rc - 1
        return v

    def eval_ext(self, e: Expr):
        """Evaluate and force the extension representation (gl3 triple)."""
        k, v = self.eval(e)
        if k == "base":
            return gl3.from_base(v)
        return v

    def _col_values(self, c: Col):
        if self.window is not None:
            off = c.shift * self.shift_rows
            block = self.sections[c.section][off:off + self.window,
                                             c.index:c.index + c.dim]
            if block.shape[0] != self.window:
                raise ValueError(f"EvalEnv: section {c.section!r} holds "
                                 f"too short a halo for shift {c.shift}")
            return self._tagged(block, c.dim)
        shifted = bool(c.shift and self.shift_rows)
        key = (c.section, c.index, c.dim, c.shift) if shifted else None
        if key is not None:
            hit = self._col_cache.get(key)
            if hit is not None:
                return hit
        block = self.sections[c.section][:, c.index:c.index + c.dim]
        if shifted:
            block = torch.roll(block, -c.shift * self.shift_rows, dims=0)
        res = self._tagged(block, c.dim)
        if key is not None:
            self._col_cache[key] = res
        return res

    @staticmethod
    def _tagged(block, dim: int):
        if dim == 1:
            return ("base", block[:, 0])
        return ("ext", tuple(block[:, k] for k in range(3)))

    def _const(self, v: int):
        t = self._consts.get(v)
        if t is None:
            t = self._consts[v] = dev.scalar(v, self.device)
        return t

    def _eval(self, e: Expr):
        if isinstance(e, Col):
            return self._col_values(e)
        if isinstance(e, Const):
            return ("base", self._const(e.value % gl.P))
        if isinstance(e, Challenge):
            return ("ext", self.challenges[e.index])
        if isinstance(e, Public):
            return ("base", self.publics[e.index])
        if isinstance(e, XSymbol):
            return ("base", self.x)
        if isinstance(e, FirstRowSelector):
            return ("base", self.l1)
        if isinstance(e, BinOp):
            a = self.eval(e.a)
            b = self.eval(e.b)
            if e.op == "add":
                return self._add(a, b)
            if e.op == "sub":
                return self._sub(a, b)
            return self._mul(a, b)
        raise TypeError(type(e))


# ---------------------------------------------------------------------------
# Host-side scalar evaluation (python ints in the cubic extension): the
# verifier evaluates the constraints at xi from the proof's evals.
# ---------------------------------------------------------------------------

class ScalarEnv:
    """Col -> gl3 value from the proof evals; everything in python ints."""

    def __init__(self, air, evals, challenges, publics, xi, l1_xi):
        # evals: dict (section, index, shift) -> [e0, e1, e2]
        self.air = air
        self.evals = evals
        self.challenges = challenges
        self.publics = publics
        self.xi = xi            # [3]
        self.l1_xi = l1_xi      # [3]
        self._memo = {}

    def eval(self, e: Expr):
        key = id(e)
        hit = self._memo.get(key)
        if hit is not None and hit[0] is e:
            return hit[1]
        v = self._eval(e)
        # keep the expr object alive so a GC'd node can't recycle its id
        self._memo[key] = (e, v)
        return v

    def _eval(self, e: Expr):
        P = gl.P
        if isinstance(e, Col):
            return list(self.evals[(e.section, e.index, int(e.shift))])
        if isinstance(e, Const):
            return [e.value % P, 0, 0]
        if isinstance(e, Challenge):
            return list(self.challenges[e.index])
        if isinstance(e, Public):
            return [self.publics[e.index] % P, 0, 0]
        if isinstance(e, XSymbol):
            return list(self.xi)
        if isinstance(e, FirstRowSelector):
            return list(self.l1_xi)
        if isinstance(e, BinOp):
            a = self.eval(e.a)
            b = self.eval(e.b)
            if e.op == "add":
                return [(x + y) % P for x, y in zip(a, b)]
            if e.op == "sub":
                return [(x - y) % P for x, y in zip(a, b)]
            return gl3._host_mul3(a, b)
        raise TypeError(type(e))


def count_refs(roots) -> dict:
    """DAG in-degree per node id over the expressions about to be
    evaluated (one count per child slot, plus one per root); feeds
    EvalEnv's bounded memo.  The caller keeps `roots` alive while the
    counts are used."""
    counts: dict = {}
    seen = set()
    stack = []
    for r in roots:
        counts[id(r)] = counts.get(id(r), 0) + 1
        stack.append(r)
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, BinOp):
            for ch in (e.a, e.b):
                counts[id(ch)] = counts.get(id(ch), 0) + 1
                stack.append(ch)
    return counts


def max_shift(roots) -> int:
    """The largest row shift of a Col in the expressions `roots`."""
    best = 0
    seen = set()
    stack = list(roots)
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, Col):
            best = max(best, int(e.shift))
        elif isinstance(e, BinOp):
            stack.extend((e.a, e.b))
    return best


def halo_rows(roots, shift_rows: int) -> int:
    """Rows a window's sections hold past its end for `roots`' shifts."""
    return max_shift(roots) * shift_rows
