"""The STARK verifier as a gate circuit — the recursion step.

Equivalent of the reference's circom verifier circuits + witness
calculators (src/starkpil/zkevm/witness, recursive1/2; consumed at
prover.cpp:591-645): for a fixed inner Air + verkey this module traces the
ENTIRE native verifier (stark/verifier.py) into a gate program over proof
wires — transcript replay (Poseidon sponge), quotient identity at xi over
the inner constraint DAG, Merkle openings, the FRI fold chain per query,
and the final-polynomial degree bound.  The traced circuit is proven by
the compression gate AIR (recursion/gate_air.py), yielding a STARK whose
statement is "I know a proof the inner verifier accepts", with the inner
publics re-exposed as the recursion proof's publics.

Control flow is fully static: data-dependent branches of the native
verifier become select/mux gadgets over transcript-derived index bits, and
inverses/bit-splits enter as hinted witnesses pinned by gates.

The port's own copy of ``xlayer_prover_tpu/recursion/verifier_circuit.py``
over the port's AIR IR (``stark/air.py``): it traces the same program op
for op (wires, gate coefficients, Poseidon ops, hints and publics), which
byte-equal recursive proofs depend on.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..fields import gl
from ..stark import air as air_mod
from ..stark.air import (CH_BETA, CH_DEFVAL, CH_GAMMA, CH_U, CH_V1, CH_V2,
                         CH_VC, CH_XI, BinOp, Challenge, Col, Const,
                         FirstRowSelector, Public, XSymbol)
from .circuit import Tracer

P = gl.P


class CircuitTranscript:
    """Wire-level mirror of stark/transcript.py (bit-exact schedule)."""

    def __init__(self, t: Tracer):
        self.t = t
        self.state = [t.zero] * 4
        self.pending: List[int] = []
        self.out: List[int] = [t.zero] * 12
        self.out_cursor = 0

    def _squeeze(self):
        pend = self.pending + [self.t.zero] * (8 - len(self.pending))
        self.out = self.t.poseidon(pend + self.state)
        self.out_cursor = 12
        self.pending = []
        self.state = self.out[:4]

    def put(self, wires):
        for w in wires:
            self.pending.append(w)
            self.out_cursor = 0
            if len(self.pending) == 8:
                self._squeeze()

    def get_fields1(self) -> int:
        if self.out_cursor == 0:
            self._squeeze()
        res = self.out[(12 - self.out_cursor) % 12]
        self.out_cursor -= 1
        return res

    def get_field(self):
        return tuple(self.get_fields1() for _ in range(3))

    def get_permutation_bits(self, n: int, n_bits: int):
        """n queries x n_bits bit-wires (little-endian per query)."""
        total_bits = n * n_bits
        n_fields = (total_bits - 1) // 63 + 1
        fields = [self.get_fields1() for _ in range(n_fields)]
        # 64-bit decomposition: field elements reach 2^64 - 2^32; only the
        # low 63 bits feed indices (transcript.get_permutations semantics)
        field_bits = [self.t.bits(f, 64) for f in fields]
        res = []
        cur_field = 0
        cur_bit = 0
        for _ in range(n):
            bits = []
            for _j in range(n_bits):
                bits.append(field_bits[cur_field][cur_bit])
                cur_bit += 1
                if cur_bit == 63:
                    cur_bit = 0
                    cur_field += 1
            res.append(bits)
        return res


@dataclasses.dataclass
class ProofWires:
    publics: list            # [n_publics]
    roots: list              # [4][4]
    evals: list              # [nEv] triples
    fri_roots: list          # [n_steps] (None for step 0) [4]
    final_pol: list          # [2^last] triples
    # step 0: [q][5 trees] (values, siblings); steps>0: [q] (values, siblings)
    step0_queries: list
    fri_queries: list        # [si>=1][q] -> (values, siblings)


def _tree_depth(leaves_bits: int) -> int:
    return leaves_bits


def declare_proof_wires(t: Tracer, air) -> ProofWires:
    steps = air.fri_steps
    tw = air.tree_widths()
    pubs = t.inputs(air.n_publics)
    roots = [t.inputs(4) for _ in range(4)]
    evals = [tuple(t.inputs(3)) for _ in range(len(air.ev_map))]
    fri_roots = [None] + [t.inputs(4) for _ in range(1, len(steps))]
    final_pol = [tuple(t.inputs(3)) for _ in range(1 << steps[-1])]
    step0 = []
    for _q in range(air.n_queries):
        trees = []
        for ti in range(5):
            values = t.inputs(tw[ti])
            siblings = [t.inputs(4)
                        for _ in range(_tree_depth(air.n_bits_ext))]
            trees.append((values, siblings))
        step0.append(trees)
    fri_queries = [None]
    for si in range(1, len(steps)):
        m = 1 << (steps[si - 1] - steps[si])
        qs = []
        for _q in range(air.n_queries):
            values = t.inputs(m * 3)
            siblings = [t.inputs(4) for _ in range(_tree_depth(steps[si]))]
            qs.append((values, siblings))
        fri_queries.append(qs)
    return ProofWires(publics=pubs, roots=roots, evals=evals,
                      fri_roots=fri_roots, final_pol=final_pol,
                      step0_queries=step0, fri_queries=fri_queries)


def flatten_proof(air, proof) -> List[int]:
    """Proof -> input values in declare_proof_wires order."""
    steps = air.fri_steps
    vals: List[int] = []
    vals += [int(p) % P for p in proof.publics]
    for r in proof.roots:
        vals += [int(v) % P for v in r]
    for ev in proof.evals:
        vals += [int(v) % P for v in ev]
    for si in range(1, len(steps)):
        vals += [int(v) % P for v in proof.fri_steps[si].root]
    for row in proof.final_pol:
        vals += [int(v) % P for v in row]
    for qi in range(air.n_queries):
        for ti in range(5):
            mp = proof.fri_steps[0].queries[qi][ti]
            vals += [int(v) % P for v in mp.values]
            for sib in mp.siblings:
                vals += [int(v) % P for v in sib]
    for si in range(1, len(steps)):
        for qi in range(air.n_queries):
            mp = proof.fri_steps[si].queries[qi][0]
            vals += [int(v) % P for v in mp.values]
            for sib in mp.siblings:
                vals += [int(v) % P for v in sib]
    return vals


def _linear_hash(t: Tracer, values: List[int]) -> List[int]:
    if len(values) <= 4:
        return values + [t.zero] * (4 - len(values))
    digest = [t.zero] * 4
    for start in range(0, len(values), 8):
        chunk = values[start:start + 8]
        chunk = chunk + [t.zero] * (8 - len(chunk))
        digest = t.poseidon(chunk + digest)[:4]
    return digest


def _verify_merkle(t: Tracer, root, idx_bits, leaf_values, siblings):
    digest = _linear_hash(t, list(leaf_values))
    for level, sib in enumerate(siblings):
        bit = idx_bits[level]
        left = [t.select(bit, sib[k], digest[k]) for k in range(4)]
        right = [t.select(bit, digest[k], sib[k]) for k in range(4)]
        digest = t.poseidon(left + right + [t.zero] * 4)[:4]
    for k in range(4):
        t.assert_eq(digest[k], root[k])


def _mux3(t: Tracer, items, bits):
    """items: 2^len(bits) triples; select items[index(bits)] (LE bits)."""
    cur = list(items)
    for b in bits:
        nxt = []
        for i in range(0, len(cur), 2):
            nxt.append(t.select3(b, cur[i + 1], cur[i]))
        cur = nxt
    assert len(cur) == 1
    return cur[0]


def _pow_from_bits(t: Tracer, base: int, bits) -> int:
    """base^index as a wire, index given by LE bit wires; base a host int."""
    acc = t.one
    cur = base % P
    for b in bits:
        factor = t.select(b, t.constant(cur), t.one)
        acc = t.mul(acc, factor)
        cur = (cur * cur) % P
    return acc


class _WireEnv:
    """ScalarEnv twin over wires: evaluates inner-air constraint exprs."""

    def __init__(self, t: Tracer, evals_by_key, challenges, publics, xi,
                 l1_xi):
        self.t = t
        self.evals = evals_by_key
        self.ch = challenges
        self.publics = publics
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
        t = self.t
        if isinstance(e, Col):
            return self.evals[(e.section, e.index, int(e.shift))]
        if isinstance(e, Const):
            return t.const3([e.value % P, 0, 0])
        if isinstance(e, Challenge):
            return self.ch[e.index]
        if isinstance(e, Public):
            return (self.publics[e.index], t.zero, t.zero)
        if isinstance(e, XSymbol):
            return self.xi
        if isinstance(e, FirstRowSelector):
            return self.l1_xi
        if isinstance(e, BinOp):
            a = self.eval(e.a)
            b = self.eval(e.b)
            if e.op == "add":
                return t.add3(a, b)
            if e.op == "sub":
                return t.sub3(a, b)
            return t.mul3(a, b)
        raise TypeError(type(e))


def build_verifier_circuit(air, verkey):
    """Trace verify(air, verkey, proof) into a fresh Tracer.

    Returns (tracer, ProofWires).  The inner proof's publics are exposed
    as the circuit's publics (in order)."""
    t = Tracer()
    pw = trace_verify(t, air, verkey)
    for p in pw.publics:
        t.mark_public(p)
    return t, pw


def trace_verify(t: Tracer, air, verkey=None, vk_wires=None,
                 pw: ProofWires = None) -> ProofWires:
    """Trace one inner-proof verification into an existing Tracer.

    The verkey enters either baked as constants (`verkey`, recursive1's
    fixed inner circuit) or as circuit WIRES (`vk_wires`) — the
    shape-stable recursive2 passes the key as an input so one circuit
    verifies proofs of any same-shape circuit (reference recursive2's
    rootC signal, prover.cpp:676-825)."""
    if pw is None:
        pw = declare_proof_wires(t, air)

    n = air.n
    steps = air.fri_steps
    if vk_wires is not None:
        vk = list(vk_wires)
        assert len(vk) == 4
    else:
        vk = [t.constant(v) for v in verkey]

    # ---- transcript replay -------------------------------------------
    t.scope = "transcript"
    tr = CircuitTranscript(t)
    tr.put(vk)
    tr.put(pw.publics)
    tr.put(pw.roots[0])
    ch = {}
    ch[CH_U] = tr.get_field()
    ch[CH_DEFVAL] = tr.get_field()
    tr.put(pw.roots[1])
    ch[CH_GAMMA] = tr.get_field()
    ch[CH_BETA] = tr.get_field()
    tr.put(pw.roots[2])
    ch[CH_VC] = tr.get_field()
    tr.put(pw.roots[3])
    ch[CH_XI] = tr.get_field()
    for ev in pw.evals:
        tr.put(list(ev))
    ch[CH_V1] = tr.get_field()
    ch[CH_V2] = tr.get_field()
    special_xs = []
    for si in range(len(steps)):
        special_xs.append(tr.get_field())
        if si < len(steps) - 1:
            tr.put(pw.fri_roots[si + 1])
        else:
            for row in pw.final_pol:
                tr.put(list(row))
    ys_bits = tr.get_permutation_bits(air.n_queries, steps[0])

    # ---- quotient identity at xi -------------------------------------
    t.scope = "quotient"
    xi = ch[CH_XI]
    xi_n = t.pow_static(xi, n)
    one3 = t.const3([1, 0, 0])
    zh = t.sub3(xi_n, one3)
    den = t.mulc3(t.sub3(xi, one3), n)
    l1_xi = t.mul3(zh, t.inv3(den))

    evals_by_key = {}
    q_evals = []
    for entry, ev in zip(air.ev_map, pw.evals):
        if entry.section == "cm4":
            q_evals.append(ev)
        else:
            evals_by_key[(entry.section, entry.index, entry.shift)] = ev

    env = _WireEnv(t, evals_by_key, ch, pw.publics, xi, l1_xi)
    c_val = t.const3([0, 0, 0])
    vc = ch[CH_VC]
    for c in air_mod.all_constraints(air):
        c_val = t.add3(t.mul3(c_val, vc), env.eval(c))

    xi_pow = one3
    q_val = t.const3([0, 0, 0])
    for p_i in range(air.q_deg):
        q_val = t.add3(q_val, t.mul3(xi_pow, q_evals[p_i]))
        xi_pow = t.mul3(xi_pow, xi_n)
    t.assert_eq3(c_val, t.mul3(q_val, zh))

    # ---- per-query checks --------------------------------------------
    tree_widths = air.tree_widths()
    roots5 = [pw.roots[0], pw.roots[1], pw.roots[2], pw.roots[3], vk]
    section_tree = {"cm1": 0, "cm2": 1, "cm3": 2, "cm4": 3, "const": 4}
    w_ext = gl.host_w(air.n_bits_ext)
    w_n = gl.host_w(air.n_bits)
    v1, v2 = ch[CH_V1], ch[CH_V2]
    shifts = sorted({e.shift for e in air.ev_map})

    for qi in range(air.n_queries):
        ybits = ys_bits[qi]
        trees = pw.step0_queries[qi]
        for ti in range(5):
            t.scope = f"q{qi}-merkle{ti}"
            values, siblings = trees[ti]
            assert len(values) == tree_widths[ti]
            _verify_merkle(t, roots5[ti], ybits, values, siblings)

        # x_y = SHIFT * w_ext^y
        t.scope = f"q{qi}-deep"
        x_y = t.mulc(_pow_from_bits(t, w_ext, ybits), gl.SHIFT)
        accs = {s_: t.const3([0, 0, 0]) for s_ in shifts}
        v1_pow = one3
        for i, entry in enumerate(air.ev_map):
            values, _sib = trees[section_tree[entry.section]]
            if entry.dim == 1:
                pv = (values[entry.index], t.zero, t.zero)
            else:
                pv = tuple(values[entry.index + k] for k in range(3))
            term = t.mul3(t.sub3(pv, pw.evals[i]), v1_pow)
            accs[entry.shift] = t.add3(accs[entry.shift], term)
            v1_pow = t.mul3(v1_pow, v1)
        cur = t.const3([0, 0, 0])
        v2_pow = one3
        x_y3 = (x_y, t.zero, t.zero)
        for s_ in shifts:
            pt = t.mulc3(xi, pow(w_n, s_, P))
            xdiv = t.mul3(t.inv3(t.sub3(x_y3, pt)),
                          (x_y, t.zero, t.zero))
            cur = t.add3(cur, t.mul3(t.mul3(accs[s_], xdiv), v2_pow))
            v2_pow = t.mul3(v2_pow, v2)

        # FRI fold chain
        shift_inv = gl.host_inv(gl.SHIFT)
        for si in range(1, len(steps)):
            t.scope = f"q{qi}-fold{si}"
            bits_prev = steps[si - 1]
            bits_cur = steps[si]
            m = 1 << (bits_prev - bits_cur)
            idx_cur_bits = ybits[:bits_cur]
            j_bits = ybits[bits_cur:bits_prev]
            values, siblings = pw.fri_queries[si][qi]
            _verify_merkle(t, pw.fri_roots[si], idx_cur_bits, values,
                           siblings)
            group = [tuple(values[3 * k:3 * k + 3]) for k in range(m)]
            sel = _mux3(t, group, j_bits)
            t.assert_eq3(sel, cur)
            # INTT (static matrix) then fold at special_x
            w_prev_inv = gl.host_inv(gl.host_w(bits_prev))
            w_m_inv = pow(w_prev_inv, 1 << bits_cur, P)
            m_inv = pow(m, P - 2, P)
            coeffs = []
            for jj in range(m):
                acc = None
                for k in range(m):
                    tw = pow(w_m_inv, jj * k, P) * m_inv % P
                    term = t.mulc3(group[k], tw)
                    acc = term if acc is None else t.add3(acc, term)
                coeffs.append(acc)
            off = t.mulc(_pow_from_bits(t, w_prev_inv, idx_cur_bits),
                         shift_inv)
            off_pows = [t.one]
            for _i in range(1, m):
                off_pows.append(t.mul(off_pows[-1], off))
            sx = special_xs[si]
            cur = t.const3([0, 0, 0])
            for i in range(m - 1, -1, -1):
                ci = t.mul3_base(coeffs[i], off_pows[i])
                cur = t.add3(t.mul3(cur, sx), ci)
            for _ in range(bits_prev - bits_cur):
                shift_inv = (shift_inv * shift_inv) % P

        t.scope = f"q{qi}-final"
        final_bits = ybits[:steps[-1]]
        sel_final = _mux3(t, pw.final_pol, final_bits)
        t.assert_eq3(sel_final, cur)

    # ---- final polynomial degree bound -------------------------------
    t.scope = "degree-bound"
    last_bits = steps[-1]
    ext_bits = air.n_bits_ext - air.n_bits
    max_deg = 1 << max(0, last_bits - ext_bits)
    m_last = 1 << last_bits
    shift_inv = gl.host_inv(gl.SHIFT)
    for _ in range(air.n_bits_ext - last_bits):
        shift_inv = (shift_inv * shift_inv) % P
    w_last_inv = gl.host_inv(gl.host_w(last_bits))
    m_inv = pow(m_last, P - 2, P)
    for jj in range(max_deg, m_last):
        acc = None
        for k in range(m_last):
            tw = pow(w_last_inv, jj * k, P) * m_inv % P
            tw = tw * pow(shift_inv, jj, P) % P
            term = t.mulc3(pw.final_pol[k], tw)
            acc = term if acc is None else t.add3(acc, term)
        t.assert_zero(acc[0])
        t.assert_zero(acc[1])
        t.assert_zero(acc[2])

    return pw
