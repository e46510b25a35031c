"""Final SNARK stage: the recursiveF (BN128-scheme) STARK verifier as a
BN254-Fr R1CS circuit.

The port's own copy of ``xlayer_prover_tpu/snark/final_circuit.py``, op
for op, so that the constraints and the witness come out equal; host
Python over Python ints.  Groth16 (``prove_final`` in the JAX package) is
not ported.

Equivalent of the reference's circom "final" verification circuit +
witness calculator (src/starkpil/recursivefinal/main.final.cpp, consumed
at prover.cpp:893-915): for a fixed inner Air (scheme="bn128") + verkey,
`build_final_circuit` traces the ENTIRE native verifier
(stark/verifier.py) into R1CS over BN254 Fr — TranscriptBN128 replay with
native Poseidon-BN254 gadgets, strict 254-bit field splits for the
Goldilocks challenge draws, the quotient identity at xi over the inner
constraint DAG, arity-16 Merkle openings, FRI folds (constant-twiddle
INTTs cost only reductions), and the final-polynomial degree bound.

Goldilocks arithmetic is emulated with lazy reduction: a GL value is one
Fr wire plus a static integer bound; products stay unreduced until the
bound nears 2^248, then a hinted (q, r) division with bit-decomposed
range checks restores canonical form (r + 2^32 - 1 fitting 64 bits is
exactly r < p).  All hints (inverses, quotients, bits) are pinned by
constraints, and the circuit SHAPE depends only on (air, verkey) — the
same structure verifies any proof, so one Groth16 setup serves the stage
(the proof's publics are the R1CS public inputs).
"""

from __future__ import annotations

from typing import Dict, List

from ..fields import gl
from ..ops import poseidon_bn254
from ..stark import air as air_mod
from ..stark.air import (CH_BETA, CH_DEFVAL, CH_GAMMA, CH_U, CH_V1, CH_V2,
                         CH_VC, CH_XI, BinOp, Challenge, Col, Const,
                         FirstRowSelector, Public, XSymbol)
from ..stark.proof import StarkProof
from .r1cs import R1CSBuilder

P = gl.P
FR = poseidon_bn254.P
CAP = 1 << 248          # lazy-reduction ceiling (< FR ~ 2^254)
ARITY = 16
GL_PER_FR = 3


class LC:
    """Sparse linear combination over wires + tracked concrete value."""
    __slots__ = ("terms", "const", "val")

    def __init__(self, terms: Dict[int, int], const: int, val: int):
        self.terms = terms
        self.const = const
        self.val = val


class Gl:
    """Emulated Goldilocks value: Fr linear combination + integer bound
    (the tracked .val is exact as long as bound < CAP < FR)."""
    __slots__ = ("lc", "bound")

    def __init__(self, lc: LC, bound: int):
        assert bound < FR
        self.lc = lc
        self.bound = bound


class FinalBuilder:
    def __init__(self):
        self.rb = R1CSBuilder()

    # ---- Fr linear-combination layer ---------------------------------
    def lc_const(self, c: int) -> LC:
        c %= FR
        return LC({}, c, c)

    def new_wire(self, v: int) -> LC:
        v %= FR
        w = self.rb.wire(v)
        return LC({w: 1}, 0, v)

    def new_public(self, v: int) -> LC:
        v %= FR
        w = self.rb.public(v)
        return LC({w: 1}, 0, v)

    def lc_add(self, a: LC, b: LC) -> LC:
        t = dict(a.terms)
        for w, k in b.terms.items():
            t[w] = (t.get(w, 0) + k) % FR
        return LC(t, (a.const + b.const) % FR, (a.val + b.val) % FR)

    def lc_sub(self, a: LC, b: LC) -> LC:
        return self.lc_add(a, self.lc_scale(b, -1))

    def lc_scale(self, a: LC, c: int) -> LC:
        c %= FR
        return LC({w: (k * c) % FR for w, k in a.terms.items()},
                  (a.const * c) % FR, (a.val * c) % FR)

    def lc_addc(self, a: LC, c: int) -> LC:
        return LC(dict(a.terms), (a.const + c) % FR, (a.val + c) % FR)

    def _adict(self, a: LC) -> Dict[int, int]:
        d = dict(a.terms)
        if a.const:
            d[0] = (d.get(0, 0) + a.const) % FR
        return d

    def lc_mul(self, a: LC, b: LC) -> LC:
        out = self.new_wire(a.val * b.val % FR)
        self.rb.constrain(self._adict(a), self._adict(b), self._adict(out))
        return out

    def assert_zero(self, a: LC):
        assert a.val % FR == 0, "witness violates constraint"
        self.rb.constrain(self._adict(a), {0: 1}, {})

    def assert_eq(self, a: LC, b: LC):
        self.assert_zero(self.lc_sub(a, b))

    def assert_mul(self, a: LC, b: LC, c: LC):
        assert a.val * b.val % FR == c.val % FR
        self.rb.constrain(self._adict(a), self._adict(b), self._adict(c))

    # ---- bit gadgets ---------------------------------------------------
    def bits(self, a: LC, n: int) -> List[LC]:
        """Decompose into n bits (booleans + recomposition)."""
        v = a.val
        assert 0 <= v < (1 << n), "value does not fit bit width"
        out = []
        for i in range(n):
            bit = (v >> i) & 1
            b = self.new_wire(bit)
            # b * (b - 1) = 0
            self.rb.constrain(self._adict(b), self._adict(self.lc_addc(b, -1)),
                              {})
            out.append(b)
        acc = self.lc_const(0)
        for i, b in enumerate(out):
            acc = self.lc_add(acc, self.lc_scale(b, 1 << i))
        self.assert_eq(acc, a)
        return out

    def assert_bits_lt_const(self, bits: List[LC], c: int):
        """value(bits) < c, scanning MSB -> LSB with an eq-prefix chain."""
        n = len(bits)
        assert 0 < c < (1 << n)
        lt = self.lc_const(0)
        eq = self.lc_const(1)
        for i in range(n - 1, -1, -1):
            b = bits[i]
            if (c >> i) & 1:
                # bit of c is 1: value bit 0 while prefix equal => less
                lt = self.lc_add(lt, self.lc_mul(
                    eq, self.lc_sub(self.lc_const(1), b)))
                eq = self.lc_mul(eq, b)
            else:
                eq = self.lc_mul(eq, self.lc_sub(self.lc_const(1), b))
        self.assert_eq(lt, self.lc_const(1))

    def fr_split_strict(self, a: LC):
        """254-bit strict decomposition (unique: value < FR); returns the
        bit list LSB-first."""
        bs = self.bits(a, 254)
        self.assert_bits_lt_const(bs, FR)
        return bs

    def bits_value(self, bits: List[LC], lo: int, hi: int) -> LC:
        acc = self.lc_const(0)
        for i in range(lo, hi):
            acc = self.lc_add(acc, self.lc_scale(bits[i], 1 << (i - lo)))
        return acc

    # ---- Goldilocks layer ----------------------------------------------
    def gl_const(self, v: int) -> Gl:
        v %= P
        return Gl(self.lc_const(v), v + 1)

    def gl_wire(self, v: int, range64: bool = True) -> Gl:
        assert 0 <= v < (1 << 64)
        lc = self.new_wire(v)
        if range64:
            self.bits(lc, 64)
        return Gl(lc, 1 << 64)

    def g_add(self, a: Gl, b: Gl) -> Gl:
        out = Gl(self.lc_add(a.lc, b.lc), a.bound + b.bound)
        return self.g_norm(out)

    def g_sub(self, a: Gl, b: Gl) -> Gl:
        k = -(-b.bound // P)          # ceil
        out = Gl(self.lc_addc(self.lc_sub(a.lc, b.lc), k * P),
                 a.bound + k * P)
        return self.g_norm(out)

    def g_scale(self, a: Gl, c: int) -> Gl:
        assert c >= 0
        return self.g_norm(Gl(self.lc_scale(a.lc, c), a.bound * c + 1))

    def g_norm(self, a: Gl) -> Gl:
        return self.g_reduce(a) if a.bound >= CAP else a

    def g_mul(self, a: Gl, b: Gl) -> Gl:
        if a.bound * b.bound >= CAP:
            a = self.g_reduce(a)
            if a.bound * b.bound >= CAP:
                b = self.g_reduce(b)
        return Gl(self.lc_mul(a.lc, b.lc), a.bound * b.bound)

    def g_reduce(self, a: Gl) -> Gl:
        """Canonical form: val = q*P + r, r < P (via r + 2^32 - 1 < 2^64)."""
        if a.bound <= P:
            return a
        v = a.lc.val
        assert v < a.bound
        q, r = divmod(v, P)
        qbits = max(1, (a.bound // P).bit_length())
        qlc = self.new_wire(q)
        self.bits(qlc, qbits)
        rlc = self.new_wire(r)
        self.bits(self.lc_addc(rlc, (1 << 32) - 1), 64)
        self.assert_zero(self.lc_sub(a.lc, self.lc_add(
            self.lc_scale(qlc, P), rlc)))
        return Gl(rlc, P)

    def g_assert_zero(self, a: Gl):
        v = a.lc.val
        assert v % P == 0
        q = v // P
        qbits = max(1, (a.bound // P + 1).bit_length())
        qlc = self.new_wire(q)
        self.bits(qlc, qbits)
        self.assert_zero(self.lc_sub(a.lc, self.lc_scale(qlc, P)))

    def g_assert_eq(self, a: Gl, b: Gl):
        self.g_assert_zero(self.g_sub(a, b))

    def g_pow_bits(self, base_const: int, bits: List[LC]) -> Gl:
        """base^value(bits) for a CONSTANT base: one mul per bit."""
        acc = self.gl_const(1)
        sq = base_const % P
        for b in bits:
            # acc *= (1 + bit*(sq - 1))
            factor = Gl(self.lc_addc(self.lc_scale(b, sq - 1), 1), P)
            acc = self.g_mul(acc, factor)
            acc = self.g_reduce(acc)
            sq = sq * sq % P
        return acc

    # ---- GL3 (cubic extension, x^3 = x + 1) -----------------------------
    def g3_const(self, v3) -> List[Gl]:
        return [self.gl_const(v3[0]), self.gl_const(v3[1]),
                self.gl_const(v3[2])]

    def g3_add(self, a, b):
        return [Gl(self.lc_add(x.lc, y.lc), x.bound + y.bound)
                for x, y in zip(a, b)]

    def g3_sub(self, a, b):
        return [self.g_sub(x, y) for x, y in zip(a, b)]

    def g3_norm(self, a):
        return [self.g_norm(x) for x in a]

    def g3_reduce(self, a):
        return [self.g_reduce(x) for x in a]

    def g3_mul(self, a, b, reduce: bool = True):
        d = [None] * 5
        for i in range(3):
            for j in range(3):
                t = self.g_mul(a[i], b[j])
                d[i + j] = t if d[i + j] is None else \
                    Gl(self.lc_add(d[i + j].lc, t.lc), d[i + j].bound + t.bound)
        out = [Gl(self.lc_add(d[0].lc, d[3].lc), d[0].bound + d[3].bound),
               Gl(self.lc_add(self.lc_add(d[1].lc, d[3].lc), d[4].lc),
                  d[1].bound + d[3].bound + d[4].bound),
               Gl(self.lc_add(d[2].lc, d[4].lc), d[2].bound + d[4].bound)]
        return self.g3_reduce(out) if reduce else self.g3_norm(out)

    def g3_mul_const(self, a, c3):
        """a * constant triple, UNREDUCED (bounds tracked)."""
        c = [x % P for x in c3]
        d = [None] * 5
        for i in range(3):
            for j in range(3):
                if c[j] == 0:
                    continue
                t = Gl(self.lc_scale(a[i].lc, c[j]), a[i].bound * c[j])
                d[i + j] = t if d[i + j] is None else \
                    Gl(self.lc_add(d[i + j].lc, t.lc), d[i + j].bound + t.bound)
        zero = Gl(self.lc_const(0), 1)
        d = [x if x is not None else zero for x in d]
        out = [Gl(self.lc_add(d[0].lc, d[3].lc), d[0].bound + d[3].bound),
               Gl(self.lc_add(self.lc_add(d[1].lc, d[3].lc), d[4].lc),
                  d[1].bound + d[3].bound + d[4].bound),
               Gl(self.lc_add(d[2].lc, d[4].lc), d[2].bound + d[4].bound)]
        return self.g3_norm(out)

    def g3_scale(self, a, s: Gl):
        return [self.g_mul(x, s) for x in a]

    def g3_pow_const_exp(self, a, e: int):
        r = self.g3_const([1, 0, 0])
        base = a
        while e:
            if e & 1:
                r = self.g3_mul(r, base)
            base = self.g3_mul(base, base)
            e >>= 1
        return r

    def g3_inv(self, a):
        """Hinted inverse pinned by a * inv == 1."""
        from ..fields.gl3 import _host_inv3
        av = [x.lc.val % P for x in a]
        inv = _host_inv3(av)
        iw = [self.gl_wire(v) for v in inv]
        prod = self.g3_mul(a, iw)
        self.g_assert_eq(prod[0], self.gl_const(1))
        self.g_assert_zero(prod[1])
        self.g_assert_zero(prod[2])
        return iw

    def g3_assert_eq(self, a, b):
        for x, y in zip(a, b):
            self.g_assert_eq(x, y)

    def g3_mux(self, sel_bits: List[LC], options):
        """2^len(sel_bits)-way mux over GL3 values (componentwise)."""
        cur = options
        for b in sel_bits:
            nxt = []
            for i in range(0, len(cur), 2):
                lo, hi = cur[i], cur[i + 1]
                comp = []
                for c in range(3):
                    d = self.lc_sub(hi[c].lc, lo[c].lc)
                    delta = self.lc_mul(b, d)
                    comp.append(Gl(self.lc_add(lo[c].lc, delta),
                                   max(lo[c].bound, hi[c].bound) + P))
                nxt.append(comp)
            cur = nxt
        assert len(cur) == 1
        return cur[0]

    def lc_mux(self, sel_bits: List[LC], options: List[LC]) -> LC:
        cur = list(options)
        for b in sel_bits:
            nxt = []
            for i in range(0, len(cur), 2):
                lo, hi = cur[i], cur[i + 1]
                delta = self.lc_mul(b, self.lc_sub(hi, lo))
                nxt.append(self.lc_add(lo, delta))
            cur = nxt
        assert len(cur) == 1
        return cur[0]

    # ---- Poseidon-BN254 gadget ------------------------------------------
    def poseidon(self, state: List[LC]) -> List[LC]:
        t = len(state)
        assert 2 <= t <= 17
        C, M, Pm, S = poseidon_bn254._constants()
        c, m, pmat, s = C[t - 2], M[t - 2], Pm[t - 2], S[t - 2]
        nrp = poseidon_bn254.N_ROUNDS_P[t - 2]
        NF = poseidon_bn254.N_ROUNDS_F

        def e5(x: LC) -> LC:
            x2 = self.lc_mul(x, x)
            x4 = self.lc_mul(x2, x2)
            return self.lc_mul(x4, x)

        def mix(vals, mat):
            out = []
            for i in range(t):
                acc = self.lc_const(0)
                for j in range(t):
                    acc = self.lc_add(acc, self.lc_scale(vals[j], mat[j][i]))
                out.append(acc)
            return out

        st = [self.lc_addc(state[i], c[i]) for i in range(t)]
        for r in range(NF // 2 - 1):
            st = [self.lc_addc(e5(st[i]), c[(r + 1) * t + i])
                  for i in range(t)]
            st = mix(st, m)
        st = [self.lc_addc(e5(st[i]), c[(NF // 2) * t + i]) for i in range(t)]
        st = mix(st, pmat)
        for r in range(nrp):
            st0 = self.lc_addc(e5(st[0]), c[(NF // 2 + 1) * t + r])
            s0 = self.lc_const(0)
            srow = s[(t * 2 - 1) * r:(t * 2 - 1) * (r + 1)]
            s0 = self.lc_scale(st0, srow[0])
            for j in range(1, t):
                s0 = self.lc_add(s0, self.lc_scale(st[j], srow[j]))
            for j in range(1, t):
                st[j] = self.lc_add(st[j], self.lc_scale(st0, srow[t + j - 1]))
            st[0] = s0
        for r in range(NF // 2 - 1):
            st = [self.lc_addc(e5(st[i]),
                               c[(NF // 2 + 1) * t + nrp + r * t + i])
                  for i in range(t)]
            st = mix(st, m)
        st = [e5(x) for x in st]
        return mix(st, m)


class CircuitTranscriptBN128:
    """Wire-level mirror of stark/commitment.py TranscriptBN128."""

    def __init__(self, fb: FinalBuilder):
        self.fb = fb
        self.state = [fb.lc_const(0)]
        self.pending: List[LC] = []
        self.out: List[LC] = [fb.lc_const(0)]     # reference quirk
        self.out3: List[Gl] = []

    def put(self, values: List[LC]):
        for v in values:
            self.pending.append(v)
            self.out = []
            self.out3 = []
            if len(self.pending) == ARITY:
                self._update()

    def _update(self):
        fb = self.fb
        while len(self.pending) < ARITY:
            self.pending.append(fb.lc_const(0))
        out = fb.poseidon(self.state + self.pending)
        self.out = list(out)
        self.state = [out[0]]
        self.out3 = []
        self.pending = []

    def get_fields253(self) -> LC:
        if self.out:
            return self.out.pop(0)
        self._update()
        return self.get_fields253()

    def get_fields1(self) -> Gl:
        fb = self.fb
        if self.out3:
            return self.out3.pop(0)
        if self.out:
            v = self.out.pop(0)
            bs = fb.fr_split_strict(v)
            self.out3 = [Gl(fb.bits_value(bs, 64 * k, 64 * (k + 1)),
                            1 << 64) for k in range(3)]
            return self.get_fields1()
        self._update()
        return self.get_fields1()

    def get_field(self) -> List[Gl]:
        return [self.get_fields1() for _ in range(3)]

    def get_permutation_bits(self, n: int, n_bits: int) -> List[List[LC]]:
        fb = self.fb
        total = n * n_bits
        n_fields = (total - 1) // 253 + 1
        field_bits = []
        for _ in range(n_fields):
            v = self.get_fields253()
            field_bits.append(fb.fr_split_strict(v))
        res = []
        cur_field = 0
        cur_bit = 0
        for _ in range(n):
            bits = []
            for _j in range(n_bits):
                bits.append(field_bits[cur_field][cur_bit])
                cur_bit += 1
                if cur_bit == 253:
                    cur_bit = 0
                    cur_field += 1
            res.append(bits)
        return res


# ---------------------------------------------------------------------------
# Merkle gadgets (BN128 scheme: arity-16 Poseidon trees)
# ---------------------------------------------------------------------------

def leaf_hash_gadget(fb: FinalBuilder, row: List[Gl]) -> LC:
    """commitment.leaf_hash_bn128 over wires (row = 64-bit-checked GLs)."""
    w = len(row)
    if w <= 4:
        acc = fb.lc_const(0)
        for k, g in enumerate(row):
            acc = fb.lc_add(acc, fb.lc_scale(g.lc, 1 << (64 * k)))
        return acc
    packed = []
    for start in range(0, w, GL_PER_FR):
        chunk = row[start:start + GL_PER_FR]
        acc = fb.lc_const(0)
        for k, g in enumerate(chunk):
            acc = fb.lc_add(acc, fb.lc_scale(g.lc, 1 << (64 * k)))
        packed.append(acc)
    digest = fb.lc_const(0)
    pending = len(packed)
    pos = 0
    while pending > 0:
        batch = min(ARITY, pending)
        elements = [digest] + packed[pos:pos + batch]
        if batch == ARITY:
            elements = elements + [fb.lc_const(0)] * (ARITY + 1
                                                      - len(elements))
        digest = fb.poseidon(elements)[0]
        pos += batch
        pending -= batch
    return digest


def merkle_verify_gadget(fb: FinalBuilder, root: LC, idx_bits: List[LC],
                         row: List[Gl], sibling_groups: List[List[int]]):
    """Arity-16 path check: leaf digest selected by index nibbles."""
    digest = leaf_hash_gadget(fb, row)
    bitpos = 0
    for group_vals in sibling_groups:
        group = [fb.new_wire(v) for v in group_vals]
        nib = idx_bits[bitpos:bitpos + 4]
        while len(nib) < 4:
            nib.append(fb.lc_const(0))
        sel = fb.lc_mux(nib, group)
        fb.assert_eq(sel, digest)
        digest = fb.poseidon([fb.lc_const(0)] + group)[0]
        bitpos += 4
    fb.assert_eq(digest, root)


# ---------------------------------------------------------------------------
# Constraint-DAG evaluation (ScalarEnv over GL3 wires)
# ---------------------------------------------------------------------------

class CircuitScalarEnv:
    def __init__(self, fb: FinalBuilder, air, evals, challenges, publics,
                 xi, l1_xi):
        self.fb = fb
        self.air = air
        self.evals = evals          # (section, index, shift) -> GL3 wires
        self.challenges = challenges
        self.publics = publics      # list of Gl
        self.xi = xi
        self.l1_xi = l1_xi
        self._memo = {}

    def eval(self, e):
        key = id(e)
        hit = self._memo.get(key)
        if hit is not None and hit[0] is e:
            return hit[1]
        v = self._eval(e)
        self._memo[key] = (e, v)
        return v

    def _eval(self, e):
        fb = self.fb
        if isinstance(e, Col):
            return self.evals[(e.section, e.index, int(e.shift))]
        if isinstance(e, Const):
            return fb.g3_const([e.value % P, 0, 0])
        if isinstance(e, Challenge):
            return self.challenges[e.index]
        if isinstance(e, Public):
            return [self.publics[e.index], fb.gl_const(0), fb.gl_const(0)]
        if isinstance(e, XSymbol):
            return self.xi
        if isinstance(e, FirstRowSelector):
            return self.l1_xi
        if isinstance(e, BinOp):
            a = self.eval(e.a)
            b = self.eval(e.b)
            if e.op == "add":
                return fb.g3_norm(fb.g3_add(a, b))
            if e.op == "sub":
                return fb.g3_sub(a, b)
            return fb.g3_mul(a, b)
        raise TypeError(type(e))


# ---------------------------------------------------------------------------
# The full verifier circuit
# ---------------------------------------------------------------------------

def build_final_circuit(air, verkey, proof: StarkProof):
    """Trace the BN128-scheme verifier into R1CS; returns
    (r1cs, witness, fb).  The structure depends only on (air, verkey)."""
    assert getattr(air, "scheme", "gl") == "bn128", \
        "final circuit consumes a BN128-scheme (recursiveF) proof"
    fb = FinalBuilder()
    n = air.n
    steps = air.fri_steps

    # publics first (R1CS public inputs), then all proof wires
    publics = [fb.new_public(v % P) for v in proof.publics]
    pub_gl = [Gl(lc, 1 << 64) for lc in publics]
    for lc in publics:
        fb.bits(lc, 64)

    roots = [fb.new_wire(r[0] % FR) for r in proof.roots]
    evals = []
    for ev in proof.evals:
        evals.append([fb.gl_wire(v % P) for v in ev])
    fri_roots = {}
    for si in range(1, len(steps)):
        fri_roots[si] = fb.new_wire(proof.fri_steps[si].root[0] % FR)
    final_pol = [[fb.gl_wire(v % P) for v in row] for row in proof.final_pol]

    # ---- transcript replay -------------------------------------------
    t = CircuitTranscriptBN128(fb)
    t.put([fb.lc_const(v % FR) for v in verkey])
    t.put([lc for lc in publics])
    t.put([roots[0]])
    ch = {}
    ch[CH_U] = t.get_field()
    ch[CH_DEFVAL] = t.get_field()
    t.put([roots[1]])
    ch[CH_GAMMA] = t.get_field()
    ch[CH_BETA] = t.get_field()
    t.put([roots[2]])
    ch[CH_VC] = t.get_field()
    t.put([roots[3]])
    ch[CH_XI] = t.get_field()
    for ev in evals:
        t.put([g.lc for g in ev])
    ch[CH_V1] = t.get_field()
    ch[CH_V2] = t.get_field()
    special_xs = []
    for si in range(len(steps)):
        special_xs.append(t.get_field())
        if si < len(steps) - 1:
            t.put([fri_roots[si + 1]])
        else:
            for row in final_pol:
                t.put([g.lc for g in row])
    y_bits = t.get_permutation_bits(air.n_queries, steps[0])

    # ---- quotient identity at xi --------------------------------------
    xi = ch[CH_XI]
    xi_n = fb.g3_pow_const_exp(xi, n)
    one3 = fb.g3_const([1, 0, 0])
    zh = fb.g3_sub(xi_n, one3)
    denom = [fb.g_scale(x, n) for x in fb.g3_sub(xi, one3)]
    l1_xi = fb.g3_mul(zh, fb.g3_inv(denom))

    evals_by_key = {}
    q_evals = []
    for entry, ev in zip(air.ev_map, evals):
        if entry.section == "cm4":
            q_evals.append(ev)
        else:
            evals_by_key[(entry.section, entry.index, entry.shift)] = ev
    assert len(q_evals) == air.q_deg

    env = CircuitScalarEnv(fb, air, evals_by_key, ch, pub_gl, xi, l1_xi)
    constraints = air_mod.all_constraints(air)
    c_val = fb.g3_const([0, 0, 0])
    vc = ch[CH_VC]
    for c in constraints:
        c_val = fb.g3_norm(fb.g3_add(fb.g3_mul(c_val, vc), env.eval(c)))

    xi_pow = one3
    q_val = fb.g3_const([0, 0, 0])
    for p_i in range(air.q_deg):
        q_val = fb.g3_norm(fb.g3_add(q_val, fb.g3_mul(xi_pow, q_evals[p_i])))
        if p_i + 1 < air.q_deg:
            xi_pow = fb.g3_mul(xi_pow, xi_n)
    fb.g3_assert_eq(fb.g3_reduce(c_val), fb.g3_mul(q_val, zh))

    # ---- per-query checks ----------------------------------------------
    tree_widths = air.tree_widths()
    roots5 = roots + [fb.lc_const(verkey[0] % FR)]
    section_tree = {"cm1": 0, "cm2": 1, "cm3": 2, "cm4": 3, "const": 4}
    w_ext = gl.host_w(air.n_bits_ext)
    w_n = gl.host_w(air.n_bits)
    v1, v2 = ch[CH_V1], ch[CH_V2]
    shifts = sorted({e.shift for e in air.ev_map})

    # v1 powers are query-independent
    v1_pows = [one3]
    for _ in range(len(air.ev_map) - 1):
        v1_pows.append(fb.g3_mul(v1_pows[-1], v1))
    v2_pows = [one3]
    for _ in range(len(shifts) - 1):
        v2_pows.append(fb.g3_mul(v2_pows[-1], v2))

    for qi in range(air.n_queries):
        yb = y_bits[qi]
        q0 = proof.fri_steps[0].queries[qi]
        assert len(q0) == 5, "step-0 query must open 5 trees"
        tree_rows = []
        for ti in range(5):
            mp = q0[ti]
            assert len(mp.values) == tree_widths[ti]
            row = [fb.gl_wire(v % P) for v in mp.values]
            merkle_verify_gadget(fb, roots5[ti], yb, row, mp.siblings)
            tree_rows.append(row)

        # friPol(x_y)
        x_y = fb.g_mul(fb.gl_const(gl.SHIFT),
                       fb.g_pow_bits(w_ext, yb))
        accs = {s_: fb.g3_const([0, 0, 0]) for s_ in shifts}
        for i, entry in enumerate(air.ev_map):
            row = tree_rows[section_tree[entry.section]]
            if entry.dim == 1:
                pv = [row[entry.index], fb.gl_const(0), fb.gl_const(0)]
            else:
                pv = row[entry.index:entry.index + 3]
            term = fb.g3_mul(fb.g3_sub(pv, evals[i]), v1_pows[i])
            accs[entry.shift] = fb.g3_norm(fb.g3_add(accs[entry.shift], term))
        cur = fb.g3_const([0, 0, 0])
        x_y3 = [x_y, fb.gl_const(0), fb.gl_const(0)]
        for k_s, s_ in enumerate(shifts):
            pt = fb.g3_mul_const(xi, [pow(w_n, s_, P), 0, 0])
            xdiv = fb.g3_scale(fb.g3_inv(fb.g3_sub(x_y3, pt)), x_y)
            contrib = fb.g3_mul(fb.g3_mul(accs[s_], xdiv), v2_pows[k_s])
            cur = fb.g3_norm(fb.g3_add(cur, contrib))
        cur = fb.g3_reduce(cur)

        # FRI fold chain
        shift_inv = gl.host_inv(gl.SHIFT)
        for si in range(1, len(steps)):
            bits_prev = steps[si - 1]
            bits_cur = steps[si]
            m = 1 << (bits_prev - bits_cur)
            st = proof.fri_steps[si]
            mp = st.queries[qi][0]
            assert len(mp.values) == m * 3
            row = [fb.gl_wire(v % P) for v in mp.values]
            merkle_verify_gadget(fb, fri_roots[si], yb[:bits_cur], row,
                                 mp.siblings)
            group = [row[3 * k:3 * k + 3] for k in range(m)]
            j_bits = yb[bits_cur:bits_prev]
            sel = fb.g3_mux(j_bits, group)
            fb.g3_assert_eq(fb.g3_reduce([Gl(s.lc, s.bound) for s in sel]),
                            cur)
            # INTT with constant twiddles: linear + reductions only
            w_prev_inv = gl.host_inv(gl.host_w(bits_prev))
            w_m_inv = pow(w_prev_inv, 1 << bits_cur, P)
            m_inv = pow(m, P - 2, P)
            coeffs = []
            for jj in range(m):
                acc = None
                for k in range(m):
                    tw = pow(w_m_inv, jj * k, P) * m_inv % P
                    tterm = fb.g3_mul_const(group[k], [tw, 0, 0])
                    acc = tterm if acc is None else fb.g3_norm(
                        fb.g3_add(acc, tterm))
                coeffs.append(fb.g3_reduce(acc))
            # offset_inv = shift_inv * w_prev_inv^idx_cur
            offset_inv = fb.g_mul(
                fb.gl_const(shift_inv),
                fb.g_pow_bits(w_prev_inv, yb[:bits_cur]))
            offset_inv = fb.g_reduce(offset_inv)
            # Horner at special_x with offset_inv^i scaling
            oi_pows = [fb.gl_const(1)]
            for _ in range(m - 1):
                oi_pows.append(fb.g_reduce(fb.g_mul(oi_pows[-1],
                                                    offset_inv)))
            sx = special_xs[si]
            cur = fb.g3_const([0, 0, 0])
            for i in range(m - 1, -1, -1):
                ci = fb.g3_scale(coeffs[i], oi_pows[i])
                cur = fb.g3_norm(fb.g3_add(fb.g3_mul(cur, sx), ci))
            cur = fb.g3_reduce(cur)
            for _ in range(bits_prev - bits_cur):
                shift_inv = shift_inv * shift_inv % P

        final_sel = fb.g3_mux(yb[:steps[-1]], final_pol)
        fb.g3_assert_eq(fb.g3_reduce([Gl(s.lc, s.bound) for s in final_sel]),
                        cur)

    # ---- final polynomial degree bound ---------------------------------
    last_bits = steps[-1]
    ext_bits = air.n_bits_ext - air.n_bits
    max_deg = 1 << max(0, last_bits - ext_bits)
    shift_inv = gl.host_inv(gl.SHIFT)
    for _ in range(air.n_bits_ext - last_bits):
        shift_inv = shift_inv * shift_inv % P
    m = 1 << last_bits
    w_last_inv = gl.host_inv(gl.host_w(last_bits))
    m_inv = pow(m, P - 2, P)
    for i in range(max_deg, m):
        acc = None
        for k in range(m):
            tw = pow(w_last_inv, i * k, P) * m_inv % P
            tw = tw * pow(shift_inv, i, P) % P
            tterm = fb.g3_mul_const(final_pol[k], [tw, 0, 0])
            acc = tterm if acc is None else fb.g3_norm(fb.g3_add(acc, tterm))
        for comp in acc:
            fb.g_assert_zero(comp)

    r1cs = fb.rb.build()
    witness = fb.rb.witness()
    return r1cs, witness, fb
