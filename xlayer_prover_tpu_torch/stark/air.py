"""Circuit IR: algebraic intermediate representation + compiled Air.

The port's own copy of ``xlayer_prover_tpu/stark/air.py`` (host Python,
unchanged in behaviour, so one ``const_np``/``cm1_np`` feeds both
packages and the degree-lowering pass commits the same ``im`` columns).
It replaces the reference's PIL pipeline: the ``*.starkinfo.json``
metadata (stark_info.hpp:269-336), the per-circuit generated constraint
evaluators (``chelpers``) and the plookup/permutation/connection contexts
(PuCtx/PeCtx/CiCtx, stark_info.hpp:105-139) are all subsumed by:

  * an expression DAG (``Expr``) over named columns, challenges, publics and
    domain symbols, which the prover evaluates as tensor ops over whole
    columns (``stark/eval.py``);
  * ``AirBuilder`` for authoring circuits (fixed/witness columns, vanishing
    constraints, plookup/permutation/connection arguments, publics);
  * ``Air``: the compiled layout — section column maps, argument contexts,
    quotient degree, evaluation map — the equivalent of StarkInfo.

Challenge indices follow the reference schedule (starks.cpp:68-341):
0=u, 1=defVal, 2=gamma, 3=beta, 4=vc (constraint combiner), 5=v1, 6=v2,
7=xi.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

# Challenge slots (reference starks.cpp round draws)
CH_U = 0
CH_DEFVAL = 1
CH_GAMMA = 2
CH_BETA = 3
CH_VC = 4
CH_V1 = 5
CH_V2 = 6
CH_XI = 7
NUM_CHALLENGES = 8

FIELD_EXTENSION = 3


# ---------------------------------------------------------------------------
# Expression DAG
# ---------------------------------------------------------------------------

class Expr:
    """Base algebraic expression node. Build with +,-,*, shift(.prime)."""

    def __add__(self, other):
        return BinOp("add", self, _wrap(other))

    def __radd__(self, other):
        return BinOp("add", _wrap(other), self)

    def __sub__(self, other):
        return BinOp("sub", self, _wrap(other))

    def __rsub__(self, other):
        return BinOp("sub", _wrap(other), self)

    def __mul__(self, other):
        return BinOp("mul", self, _wrap(other))

    def __rmul__(self, other):
        return BinOp("mul", _wrap(other), self)

    def __neg__(self):
        return BinOp("sub", Const(0), self)


def _wrap(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, int):
        return Const(v)
    raise TypeError(f"cannot use {type(v)} in expression")


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    """Reference to a column: section in {'const','cm1','cm2','cm3'}, index
    within section, dim in {1,3}, shift = row offset (1 = the reference's
    "prime"; larger shifts serve row-spread designs like the Arith SM)."""
    section: str
    index: int
    dim: int = 1
    shift: int = 0
    name: str = ""

    @property
    def prime(self) -> bool:
        return self.shift != 0

    def shifted(self, by: int = 1) -> "Col":
        return Col(self.section, self.index, self.dim, self.shift + by,
                   self.name)


@dataclasses.dataclass(frozen=True, eq=False)
class Const(Expr):
    value: int


@dataclasses.dataclass(frozen=True, eq=False)
class Challenge(Expr):
    index: int  # CH_* slot


@dataclasses.dataclass(frozen=True, eq=False)
class Public(Expr):
    index: int


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str  # add | sub | mul
    a: Expr
    b: Expr


def expr_degree(e: Expr) -> int:
    """Multiplicative degree in column units (challenges/consts are deg 0).

    FirstRowSelector (degree N-1 analytic) counts as a column; the bare
    domain variable x is negligible against N-1 and counts 0.
    """
    if isinstance(e, (Col, FirstRowSelector)):
        return 1
    if isinstance(e, (Const, Challenge, Public, XSymbol)):
        return 0
    if isinstance(e, BinOp):
        da, db = expr_degree(e.a), expr_degree(e.b)
        return da + db if e.op == "mul" else max(da, db)
    raise TypeError(type(e))


def expr_cols(e: Expr, out=None):
    """Collect Col references (with prime flags) used by an expression."""
    if out is None:
        out = []
    if isinstance(e, Col):
        out.append(e)
    elif isinstance(e, BinOp):
        expr_cols(e.a, out)
        expr_cols(e.b, out)
    return out


# ---------------------------------------------------------------------------
# Argument contexts (compiled)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlookupCtx:
    """f must be a sub-multiset of t. h1/h2/z live in cm2/cm3 sections.

    f_im/t_im: committed copies of the compressed selectors (im pols, the
    pil-stark imPols pattern) so the Z recurrence stays degree 3; their
    defining constraints live in air.constraints via air.im_defs."""
    f_exp: Expr
    t_exp: Expr
    h1_col: Col = None
    h2_col: Col = None
    z_col: Col = None
    f_im: Col = None
    t_im: Col = None


@dataclasses.dataclass
class PermutationCtx:
    f_exp: Expr
    t_exp: Expr
    z_col: Col = None
    f_im: Col = None
    t_im: Col = None


@dataclasses.dataclass
class ConnectionCtx:
    """PlonK-style copy constraints over `cols` with sigma columns `s_cols`;
    k_coeffs are the coset multipliers k_j (k_0 = 1).

    Wide connections (len(cols) > 3) split their grand-product factors into
    committed intermediate columns (im chains, the pil-stark imPols
    pattern) so every emitted constraint stays degree <= 3: the first im
    covers 3 factors, each later im multiplies 2 more, and the Z recurrence
    consumes the last im directly."""
    cols: list
    s_cols: list
    k_coeffs: list
    z_col: Col = None
    num_ims: list = dataclasses.field(default_factory=list)
    den_ims: list = dataclasses.field(default_factory=list)

    def factor_groups(self):
        """Partition of factor indices: [0..2], then pairs."""
        n = len(self.cols)
        groups = [list(range(min(3, n)))]
        i = 3
        while i < n:
            groups.append(list(range(i, min(i + 2, n))))
            i += 2
        return groups


@dataclasses.dataclass
class EvMapEntry:
    section: str   # 'const' | 'cm1' | 'cm2' | 'cm3' | 'cm4'
    index: int     # base column index within section (start of dim block)
    dim: int
    shift: int     # evaluation point is w^shift * xi


# ---------------------------------------------------------------------------
# Compiled Air
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Air:
    name: str
    n_bits: int
    n_bits_ext: int
    n_queries: int
    fri_steps: list            # [nBits_0 = n_bits_ext, nBits_1, ...]
    n_publics: int
    const_width: int
    cm1_width: int
    cm2_width: int
    cm3_width: int
    q_deg: int                 # number of quotient chunks
    q_dim: int                 # 3
    constraints: list          # [Expr] that vanish on H
    plookups: list             # [PlookupCtx]
    permutations: list         # [PermutationCtx]
    connections: list          # [ConnectionCtx]
    publics_map: list          # [(section, col_index, row)]
    ev_map: list               # [EvMapEntry] built at compile
    scheme: str = "gl"         # commitment scheme: "gl" | "bn128"
    im_defs: list = dataclasses.field(default_factory=list)
    # ^ [(cm3 Col, Expr)]: auto-committed intermediate pols capping every
    #   constraint at degree 3 (blowup 2x); the prover fills them on H

    @property
    def n(self):
        return 1 << self.n_bits

    @property
    def n_ext(self):
        return 1 << self.n_bits_ext

    @property
    def cm4_width(self):
        return self.q_deg * self.q_dim

    def tree_widths(self):
        """Leaf widths of the 5 query trees: cm1..cm4, const."""
        return [self.cm1_width, self.cm2_width, self.cm3_width,
                self.cm4_width, self.const_width]


def _substitute(e: Expr, memo: dict) -> Expr:
    """Replace memoized nodes (id-keyed, identity-verified) by their im
    columns, rebuilding only the affected spine."""
    hit = memo.get(id(e))
    if hit is not None and hit[0] is e:
        return hit[1]
    if isinstance(e, BinOp):
        a = _substitute(e.a, memo)
        b = _substitute(e.b, memo)
        if a is e.a and b is e.b:
            return e
        return BinOp(e.op, a, b)
    return e


def _pick_node(e: Expr) -> Expr:
    """Walk the maximal-degree path down to the first subexpression of
    degree <= 3 (it has degree >= 2 by construction)."""
    while expr_degree(e) > 3:
        assert isinstance(e, BinOp)
        da, db = expr_degree(e.a), expr_degree(e.b)
        e = e.a if da >= db else e.b
    assert expr_degree(e) >= 2
    return e


def _lower_constraints(constraints, new_im3):
    """Cap every constraint at degree 3 by committing high-degree
    subexpressions as im columns; shared subtrees (by identity) are
    committed once.  Returns (lowered constraints, [(col, expr)])."""
    memo = {}
    defs = []
    out = []
    for c in constraints:
        c = _substitute(c, memo)
        while expr_degree(c) > 3:
            node = _pick_node(c)
            col = new_im3()
            memo[id(node)] = (node, col)
            defs.append((col, node))
            c = _substitute(c, memo)
        out.append(c)
    return out, defs


class AirBuilder:
    """Author a circuit; ``compile`` produces the Air + constraint schedule.

    All arguments follow the reference protocol: multi-column tuples are
    compressed with powers of the ``u`` challenge; selected arguments blend
    with the ``defVal`` challenge.
    """

    def __init__(self, name: str, n_bits: int, n_bits_ext: Optional[int] = None,
                 n_queries: int = 16, fri_fold_bits: int = 2,
                 scheme: str = "gl"):
        self.name = name
        self.scheme = scheme
        self.n_bits = n_bits
        self._n_bits_ext = n_bits_ext
        self.n_queries = n_queries
        self.fri_fold_bits = fri_fold_bits
        self._const_cols = []     # names
        self._cm1_cols = []       # names
        self._constraints = []
        self._plookups = []       # raw specs
        self._permutations = []
        self._connections = []
        self._publics = []

    # -- columns ---------------------------------------------------------
    def fixed(self, name: str) -> Col:
        c = Col("const", len(self._const_cols), 1, False, name)
        self._const_cols.append(name)
        return c

    def witness(self, name: str) -> Col:
        c = Col("cm1", len(self._cm1_cols), 1, False, name)
        self._cm1_cols.append(name)
        return c

    def public(self, section_col: Col, row: int) -> Public:
        """Declare a public input bound to a trace cell.

        Only row 0 is supported for now; the binding constraint
        L1 * (col - pub) = 0 is added automatically so the verifier checks
        the claimed public against the committed trace.
        """
        assert row == 0, "public bindings only supported at row 0"
        idx = len(self._publics)
        self._publics.append((section_col.section, section_col.index, row))
        p = Public(idx)
        self._constraints.append(FirstRowSelector() * (section_col - p))
        return p

    def public_value(self) -> Public:
        """Declare a public input with no automatic binding; the circuit must
        reference it in a constraint (e.g. a last-row selector check)."""
        idx = len(self._publics)
        self._publics.append((None, None, None))
        return Public(idx)

    # -- constraints -----------------------------------------------------
    def constrain(self, expr: Expr):
        """expr must vanish on the whole domain H."""
        self._constraints.append(expr)

    def _compress(self, cols, sel):
        u = Challenge(CH_U)
        acc = None
        for c in cols:
            acc = c if acc is None else acc * u + c
        if sel is not None:
            dv = Challenge(CH_DEFVAL)
            acc = sel * (acc - dv) + dv
        return acc

    def plookup(self, f_cols, t_cols, f_sel=None, t_sel=None):
        assert len(f_cols) == len(t_cols) >= 1
        f = self._compress(list(f_cols), f_sel)
        t = self._compress(list(t_cols), t_sel)
        self._plookups.append((f, t))

    def permutation(self, f_cols, t_cols, f_sel=None, t_sel=None):
        assert len(f_cols) == len(t_cols) >= 1
        f = self._compress(list(f_cols), f_sel)
        t = self._compress(list(t_cols), t_sel)
        self._permutations.append((f, t))

    def connection(self, cols, s_cols, k_coeffs):
        assert len(cols) == len(s_cols) == len(k_coeffs)
        self._connections.append((list(cols), list(s_cols), list(k_coeffs)))

    # -- compile ---------------------------------------------------------
    def compile(self) -> Air:
        cm2_w = 0
        plookups = []
        for (f, t) in self._plookups:
            h1 = Col("cm2", cm2_w, 3, name="h1")
            h2 = Col("cm2", cm2_w + 3, 3, name="h2")
            cm2_w += 6
            plookups.append(PlookupCtx(f_exp=f, t_exp=t, h1_col=h1, h2_col=h2))

        cm3_w = 0
        for pu in plookups:
            pu.z_col = Col("cm3", cm3_w, 3, name="z_pu")
            cm3_w += 3
        permutations = []
        for (f, t) in self._permutations:
            z = Col("cm3", cm3_w, 3, name="z_pe")
            cm3_w += 3
            permutations.append(PermutationCtx(f_exp=f, t_exp=t, z_col=z))
        connections = []
        for (cols, s_cols, ks) in self._connections:
            z = Col("cm3", cm3_w, 3, name="z_ci")
            cm3_w += 3
            ctx = ConnectionCtx(cols=cols, s_cols=s_cols, k_coeffs=ks,
                                z_col=z)
            if len(cols) > 3:
                n_ims = len(ctx.factor_groups())
                for _ in range(n_ims):
                    ctx.num_ims.append(Col("cm3", cm3_w, 3, name="im_num"))
                    cm3_w += 3
                for _ in range(n_ims):
                    ctx.den_ims.append(Col("cm3", cm3_w, 3, name="im_den"))
                    cm3_w += 3
            connections.append(ctx)

        # ---- degree lowering (auto-committed im pols) -----------------
        # cap every emitted constraint at degree 3 so the quotient needs
        # only a 2x extension: commit the compressed lookup selectors and
        # any high-degree identity subexpression as cm3 columns with
        # defining constraints (the reference/pil-stark imPols pattern,
        # here fully automatic).
        im_defs = []
        im_counter = [cm3_w]

        def new_im3():
            col = Col("cm3", im_counter[0], 3, name="im")
            im_counter[0] += 3
            return col

        for pu in plookups:
            if expr_degree(pu.f_exp) > 1:
                pu.f_im = new_im3()
                im_defs.append((pu.f_im, pu.f_exp))
            if expr_degree(pu.t_exp) > 1:
                pu.t_im = new_im3()
                im_defs.append((pu.t_im, pu.t_exp))
        for pe in permutations:
            if expr_degree(pe.f_exp) > 2:
                pe.f_im = new_im3()
                im_defs.append((pe.f_im, pe.f_exp))
            if expr_degree(pe.t_exp) > 2:
                pe.t_im = new_im3()
                im_defs.append((pe.t_im, pe.t_exp))

        constraints, id_defs = _lower_constraints(self._constraints, new_im3)
        im_defs.extend(id_defs)
        for col, expr in im_defs:
            constraints.append(BinOp("sub", col, expr))
        cm3_w = im_counter[0]

        # Full constraint list (identity + argument constraints) is built by
        # the prover/verifier via `all_constraints`; the quotient degree needs
        # the max degree across them.
        air = Air(
            name=self.name,
            n_bits=self.n_bits,
            n_bits_ext=0,  # fixed below
            n_queries=self.n_queries,
            fri_steps=[],
            n_publics=len(self._publics),
            const_width=len(self._const_cols),
            cm1_width=len(self._cm1_cols),
            cm2_width=cm2_w,
            cm3_width=cm3_w,
            q_deg=1,
            q_dim=FIELD_EXTENSION,
            constraints=constraints,
            plookups=plookups,
            permutations=permutations,
            connections=connections,
            publics_map=list(self._publics),
            ev_map=[],
            scheme=self.scheme,
            im_defs=im_defs,
        )

        max_deg = 1
        for c in all_constraints(air):
            max_deg = max(max_deg, expr_degree(c))
        air.q_deg = max(1, max_deg - 1)

        blowup_bits = max(1, (air.q_deg - 1).bit_length()) \
            if air.q_deg > 1 else 1
        n_bits_ext = self._n_bits_ext or (self.n_bits + blowup_bits)
        assert (1 << (n_bits_ext - self.n_bits)) >= air.q_deg, \
            "extension domain too small for quotient degree"
        air.n_bits_ext = n_bits_ext

        # FRI schedule: fold by fri_fold_bits per step down to a small final
        # polynomial (sent in clear), mirroring starkStruct.steps.
        final_bits = min(5, n_bits_ext)
        steps = [n_bits_ext]
        cur = n_bits_ext
        while cur > final_bits:
            cur = max(cur - self.fri_fold_bits, final_bits)
            steps.append(cur)
        air.fri_steps = steps

        air.ev_map = build_ev_map(air)
        return air


# ---------------------------------------------------------------------------
# Constraint schedule (shared by prover and verifier)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class FirstRowSelector(Expr):
    """L1(x): 1 on the first row of H, 0 elsewhere.

    Analytic off H: L1(x) = (x^N - 1) / (N * (x - 1)); evaluated directly on
    the extended domain and at xi by prover and verifier.
    """


def all_constraints(air: Air):
    """The full constraint list, in a fixed canonical order.

    Identity constraints first, then per-plookup (recurrence, Z boundary),
    per-permutation, per-connection.  Every constraint vanishes on H.
    """
    gamma = Challenge(CH_GAMMA)
    beta = Challenge(CH_BETA)
    one_plus_beta = beta + 1
    l1 = FirstRowSelector()
    out = list(air.constraints)

    for pu in air.plookups:
        f = pu.f_im if pu.f_im is not None else pu.f_exp
        t = pu.t_im if pu.t_im is not None else pu.t_exp
        h1, h2, z = pu.h1_col, pu.h2_col, pu.z_col
        h1p = h1.shifted()
        zp = z.shifted()
        tp = _shift_expr(t)
        gb = gamma * one_plus_beta
        num = one_plus_beta * (gamma + f) * (gb + t + beta * tp)
        den = (gb + h1 + beta * h2) * (gb + h2 + beta * h1p)
        out.append(zp * den - z * num)     # recurrence
        out.append(l1 * (z - 1))           # boundary Z[0] = 1
    for pe in air.permutations:
        f = pe.f_im if pe.f_im is not None else pe.f_exp
        t = pe.t_im if pe.t_im is not None else pe.t_exp
        z = pe.z_col
        zp = z.shifted()
        out.append(zp * (t + gamma) - z * (f + gamma))
        out.append(l1 * (z - 1))
    for ci in air.connections:
        z = ci.z_col
        zp = z.shifted()
        xx = XSymbol()
        num_factors = [c + beta * k * xx + gamma
                       for c, k in zip(ci.cols, ci.k_coeffs)]
        den_factors = [c + beta * s + gamma
                       for c, s in zip(ci.cols, ci.s_cols)]
        if not ci.num_ims:
            num = Const(1)
            den = Const(1)
            for fn, fd in zip(num_factors, den_factors):
                num = num * fn
                den = den * fd
            out.append(zp * den - z * num)
        else:
            groups = ci.factor_groups()
            for ims, factors in ((ci.num_ims, num_factors),
                                 (ci.den_ims, den_factors)):
                prev = None
                for gi, grp in enumerate(groups):
                    prod = Const(1) if prev is None else prev
                    for fi in grp:
                        prod = prod * factors[fi]
                    out.append(ims[gi] - prod)      # im defining constraint
                    prev = ims[gi]
            # the last ims hold the full per-row products
            out.append(zp * ci.den_ims[-1] - z * ci.num_ims[-1])
        out.append(l1 * (z - 1))
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class XSymbol(Expr):
    """The domain variable x itself (x_n on H, shift*w_ext^k extended)."""


def _shift_expr(e: Expr) -> Expr:
    """Replace every Col in e with its next-row version."""
    if isinstance(e, Col):
        return e.shifted()
    if isinstance(e, BinOp):
        return BinOp(e.op, _shift_expr(e.a), _shift_expr(e.b))
    return e


def build_ev_map(air: Air):
    """Every (section, base-index, dim, shift) needed to evaluate all
    constraints at xi, plus the quotient chunks. Canonical order."""
    needed = {}

    def visit(e):
        for c in expr_cols(e):
            key = (c.section, c.index, c.dim, int(c.shift))
            needed[key] = True

    for c in all_constraints(air):
        visit(c)
    entries = [EvMapEntry(*k) for k in sorted(needed.keys(),
                                              key=lambda k: (k[0], k[1], k[3]))]
    for p in range(air.q_deg):
        entries.append(EvMapEntry("cm4", p * air.q_dim, air.q_dim, 0))
    return entries
