"""STARK verifier (host-exact, python ints).

The port's own copy of ``xlayer_prover_tpu/stark/verifier.py``, so that
proofs made on the GPU are checked without the JAX package.

The reference delegates verification to circom-generated verifier circuits
(src/starkpil/*/witness) and pil-stark JS; here we provide a native verifier
for the same protocol so the framework is self-checking end-to-end: it
re-derives every transcript challenge, checks the combined constraint /
quotient identity at xi, all Merkle openings, the FRI fold chain at each
query, and the final polynomial's degree bound.
"""

from __future__ import annotations

from ..fields import gl
from ..fields.gl3 import _host_mul3, _host_pow3
from . import air as air_mod
from .commitment import get_scheme
from .air import CH_BETA, CH_DEFVAL, CH_GAMMA, CH_U, CH_V1, CH_V2, CH_VC, CH_XI
from .eval import ScalarEnv
from .proof import StarkProof

P = gl.P


class VerifyError(Exception):
    pass


def _inv3(a):
    return _host_pow3(list(a), P ** 3 - 2)


def _add3(a, b):
    return [(x + y) % P for x, y in zip(a, b)]


def _sub3(a, b):
    return [(x - y) % P for x, y in zip(a, b)]


def _scale3(a, s):
    return [(x * s) % P for x in a]


def _host_intt(vals3, w_inv: int):
    """Inverse DFT of a small list of gl3 values (direct O(m^2))."""
    m = len(vals3)
    m_inv = pow(m, P - 2, P)
    out = []
    for j in range(m):
        acc = [0, 0, 0]
        for k in range(m):
            tw = pow(w_inv, j * k, P)
            acc = _add3(acc, _scale3(vals3[k], tw))
        out.append(_scale3(acc, m_inv))
    return out


def verify(air, verkey, proof: StarkProof) -> bool:
    """Raises VerifyError on failure; returns True on success."""
    n = air.n
    steps = air.fri_steps
    publics = proof.publics
    if len(publics) != air.n_publics:
        raise VerifyError("publics length mismatch")
    if len(proof.evals) != len(air.ev_map):
        raise VerifyError("evals length mismatch")

    # ---- transcript replay -------------------------------------------
    scheme = get_scheme(air)
    t = scheme.transcript()
    t.put(verkey)
    t.put(publics)
    t.put(proof.roots[0])
    ch = {}
    ch[CH_U] = t.get_field()
    ch[CH_DEFVAL] = t.get_field()
    t.put(proof.roots[1])
    ch[CH_GAMMA] = t.get_field()
    ch[CH_BETA] = t.get_field()
    t.put(proof.roots[2])
    ch[CH_VC] = t.get_field()
    t.put(proof.roots[3])
    ch[CH_XI] = t.get_field()
    for ev in proof.evals:
        t.put(ev)
    ch[CH_V1] = t.get_field()
    ch[CH_V2] = t.get_field()
    special_xs = []
    for si in range(len(steps)):
        special_xs.append(t.get_field())
        if si < len(steps) - 1:
            st = proof.fri_steps[si + 1]
            if st.root is None:
                raise VerifyError("missing FRI root")
            t.put(st.root)
        else:
            for row in proof.final_pol:
                t.put(row)
    ys = t.get_permutations(air.n_queries, steps[0])

    # ---- quotient identity at xi -------------------------------------
    xi = ch[CH_XI]
    xi_n = _host_pow3(xi, n)
    zh = _sub3(xi_n, [1, 0, 0])                 # xi^N - 1
    l1_xi = _host_mul3(zh, _inv3(_scale3(_sub3(xi, [1, 0, 0]), n)))

    evals_by_key = {}
    q_evals = []
    for entry, ev in zip(air.ev_map, proof.evals):
        if entry.section == "cm4":
            q_evals.append(ev)
        else:
            evals_by_key[(entry.section, entry.index, entry.shift)] = ev
    if len(q_evals) != air.q_deg:
        raise VerifyError("quotient evals count mismatch")

    env = ScalarEnv(air, evals_by_key, ch, [p % P for p in publics], xi, l1_xi)
    constraints = air_mod.all_constraints(air)
    c_val = [0, 0, 0]
    vc = ch[CH_VC]
    for c in constraints:
        c_val = _add3(_host_mul3(c_val, vc), env.eval(c))

    xi_pow_n = [1, 0, 0]
    q_val = [0, 0, 0]
    for p_i in range(air.q_deg):
        q_val = _add3(q_val, _host_mul3(xi_pow_n, q_evals[p_i]))
        xi_pow_n = _host_mul3(xi_pow_n, xi_n)
    if c_val != _host_mul3(q_val, zh):
        raise VerifyError("quotient identity C(xi) != Q(xi)*Zh(xi) fails")

    # ---- per-query checks --------------------------------------------
    tree_widths = air.tree_widths()
    roots5 = [proof.roots[0], proof.roots[1], proof.roots[2], proof.roots[3],
              verkey]
    section_tree = {"cm1": 0, "cm2": 1, "cm3": 2, "cm4": 3, "const": 4}
    w_ext = gl.host_w(air.n_bits_ext)
    w_n = gl.host_w(air.n_bits)
    v1 = ch[CH_V1]
    v2 = ch[CH_V2]
    shifts = sorted({e.shift for e in air.ev_map})

    for qi, y in enumerate(ys):
        # main tree openings
        q0 = proof.fri_steps[0].queries[qi]
        if len(q0) != 5:
            raise VerifyError("step-0 query must open 5 trees")
        for ti in range(5):
            mp = q0[ti]
            if len(mp.values) != tree_widths[ti]:
                raise VerifyError(f"query {qi}: tree {ti} width mismatch")
            if not scheme.verify(roots5[ti], y, mp.values, mp.siblings):
                raise VerifyError(f"query {qi}: tree {ti} merkle proof fails")

        # recompute friPol(x_y)
        x_y = (gl.SHIFT * pow(w_ext, y, P)) % P
        accs = {s_: [0, 0, 0] for s_ in shifts}
        v1_pow = [1, 0, 0]
        for i, entry in enumerate(air.ev_map):
            mp = q0[section_tree[entry.section]]
            if entry.dim == 1:
                pv = [mp.values[entry.index] % P, 0, 0]
            else:
                pv = [v % P for v in mp.values[entry.index:entry.index + 3]]
            term = _host_mul3(_sub3(pv, proof.evals[i]), v1_pow)
            accs[entry.shift] = _add3(accs[entry.shift], term)
            v1_pow = _host_mul3(v1_pow, v1)
        cur = [0, 0, 0]
        v2_pow = [1, 0, 0]
        for s_ in shifts:
            pt = _scale3(xi, pow(w_n, s_, P))
            xdiv = _scale3(_inv3(_sub3([x_y, 0, 0], pt)), x_y)
            cur = _add3(cur, _host_mul3(_host_mul3(accs[s_], xdiv), v2_pow))
            v2_pow = _host_mul3(v2_pow, v2)

        # FRI fold chain
        shift_inv = gl.host_inv(gl.SHIFT)
        for si in range(1, len(steps)):
            bits_prev = steps[si - 1]
            bits_cur = steps[si]
            m = 1 << (bits_prev - bits_cur)
            idx_prev = y % (1 << bits_prev)
            idx_cur = y % (1 << bits_cur)
            j = idx_prev >> bits_cur
            st = proof.fri_steps[si]
            mp = st.queries[qi][0]
            if len(mp.values) != m * 3:
                raise VerifyError(f"query {qi}: FRI step {si} group size")
            if not scheme.verify(st.root, idx_cur, mp.values, mp.siblings):
                raise VerifyError(f"query {qi}: FRI step {si} merkle fails")
            group = [[v % P for v in mp.values[3 * k:3 * k + 3]]
                     for k in range(m)]
            if group[j] != cur:
                raise VerifyError(
                    f"query {qi}: FRI step {si} layer consistency fails")
            # fold the group
            w_prev_inv = gl.host_inv(gl.host_w(bits_prev))
            w_m_inv = pow(w_prev_inv, 1 << bits_cur, P)
            coeffs = _host_intt(group, w_m_inv)
            offset_inv = (shift_inv * pow(w_prev_inv, idx_cur, P)) % P
            cur = [0, 0, 0]
            sx = special_xs[si]
            for i in range(m - 1, -1, -1):
                ci = _scale3(coeffs[i], pow(offset_inv, i, P))
                cur = _add3(_host_mul3(cur, sx), ci)
            for _ in range(bits_prev - bits_cur):
                shift_inv = (shift_inv * shift_inv) % P

        final_idx = y % (1 << steps[-1])
        if [v % P for v in proof.final_pol[final_idx]] != cur:
            raise VerifyError(f"query {qi}: final polynomial mismatch")

    # ---- final polynomial degree bound -------------------------------
    last_bits = steps[-1]
    ext_bits = air.n_bits_ext - air.n_bits
    max_deg = 1 << max(0, last_bits - ext_bits)
    shift_inv = gl.host_inv(gl.SHIFT)
    for _ in range(air.n_bits_ext - last_bits):
        shift_inv = (shift_inv * shift_inv) % P
    w_last_inv = gl.host_inv(gl.host_w(last_bits))
    coeffs = _host_intt([[v % P for v in row] for row in proof.final_pol],
                        w_last_inv)
    for i in range(len(coeffs)):
        coeffs[i] = _scale3(coeffs[i], pow(shift_inv, i, P))
    for i in range(max_deg, len(coeffs)):
        if coeffs[i] != [0, 0, 0]:
            raise VerifyError("final polynomial exceeds degree bound")

    return True
