"""ECRecover point-ladder precalc (the reference's ECRecoverPrecalc).

The port's own copy of ``xlayer_prover_tpu/executor/ec_precalc.py``.

At the zkasm label ``ecrecover_store_args`` the reference precomputes
every intermediate point of the Shamir double-and-add ladder
p3 = k1*G + k2*R in Jacobian coordinates (one batch of affine
conversions instead of one modular inverse per ROM EC op) and then
serves ``x/y{Add,Dbl}PointEc`` free-input evals from the buffer until
``ecrecover_end``.  Reference: ``src/ecrecover/ecrecover.cpp:229-330``
(ECRecoverPrecalc), ``:1418-1516`` (mulPointEcJacobian1bitSave),
consumed positionally in ``eval_command.cpp:2296-2347`` and triggered
in ``main_executor.cpp:341-363``.

Design departure: the reference's buffer is positional (``buffer[pos++]``)
and silently misserves if the ROM's op order ever diverges from the
precalc's.  Here the same ladder fills a memo keyed by each op's affine
inputs; the eval functions probe the memo and fall back to direct math
on a miss — bit-exact by construction, with the same O(1)-inversions
win (one batch inverse for the whole ladder).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

P = 2 ** 256 - 2 ** 32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
N_DIV_TWO = (N - 1) // 2  # FNEC_DIV_TWO (ecrecover.cpp:12)
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# memo: ('dbl', x, y) -> (x3, y3); ('add', x1, y1, x2, y2) -> (x3, y3)
Memo = Dict[tuple, Tuple[int, int]]


def _jac_dbl(pt):
    """Jacobian doubling on y^2 = x^3 + 7; None = point at infinity."""
    x, y, z = pt
    if y == 0:
        return None
    ysq = y * y % P
    s = 4 * x * ysq % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * ysq * ysq) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _jac_add_affine(pt, ax, ay):
    """Mixed add: Jacobian pt + affine (ax, ay); None = infinity."""
    x1, y1, z1 = pt
    z1z1 = z1 * z1 % P
    u2 = ax * z1z1 % P
    s2 = ay * z1 * z1z1 % P
    if u2 == x1:
        if s2 == y1 % P:
            return _jac_dbl(pt)
        return None
    h = (u2 - x1) % P
    hh = h * h % P
    hhh = h * hh % P
    r = (s2 - y1) % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - y1 * hhh) % P
    z3 = z1 * h % P
    return (x3, y3, z3)


def _batch_affine(pts):
    """Jacobian -> affine for a list of points via one batch inversion
    (Montgomery's trick; the reference instead parallelises one inverse
    per point over nthreads, ecrecover.cpp:1506-1513)."""
    if not pts:
        return []
    pref = []
    acc = 1
    for (_x, _y, z) in pts:
        pref.append(acc)
        acc = acc * z % P
    inv = pow(acc, -1, P)
    out = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        x, y, z = pts[i]
        zi = inv * pref[i] % P
        inv = inv * z % P
        zi2 = zi * zi % P
        out[i] = (x * zi2 % P, y * zi * zi2 % P)
    return out


def precalc(signature: int, r: int, s: int, v: int) -> Optional[Memo]:
    """Run the ECRecoverPrecalc ladder of a transaction signature (s at
    most N/2); returns the op memo, or None if the signature fails any
    validity check (the interpreter then falls back to direct per-op
    math, exactly as config.ECRecoverPrecalc=false would)."""
    if r == 0 or r > N - 1 or s == 0 or s > N_DIV_TWO:
        return None
    if v == 0x1B:
        parity = 0
    elif v == 0x1C:
        parity = 1
    else:
        return None

    r_inv = pow(r, -1, N)
    a3 = (r * r % P * r + 7) % P
    if a3 == 0:
        return None  # y = 0: doubling is undefined; direct path handles it
    y = pow(a3, (P + 1) // 4, P)
    if y * y % P != a3:
        return None  # ECR_NO_SQRT_Y
    if (y & 1) != parity:
        y = P - y

    k1 = N - (signature * r_inv % N)  # reference leaves this unreduced
    k2 = s * r_inv % N

    p1 = (GX, GY)
    p2 = (r % P, y)
    # table entry 3 = p1 + p2 (affine); both table points are distinct
    # from each other unless r == GX
    p11_jac = _jac_add_affine((p1[0], p1[1], 1), p2[0], p2[1])
    p11 = _batch_affine([p11_jac])[0] if p11_jac is not None else None
    table = {1: p1, 2: p2, 3: p11}

    # the 1-bit-save ladder: record every dbl result and every
    # nonempty+nonzero add result, mirroring mulPointEcJacobian1bitSave
    events = []   # ('load', sel) | ('clear',) | ('dbl',) | ('add', sel)
    jac_saved = []
    cur = None
    for i in range(255, -1, -1):
        if cur is not None:
            cur = _jac_dbl(cur)
            if cur is None:
                return None  # y=0 doubling; bail to the direct path
            jac_saved.append(cur)
            events.append(("dbl",))
        sel_id = 2 * ((k2 >> i) & 1) + ((k1 >> i) & 1)
        if sel_id == 0:
            continue
        sel = table[sel_id]
        if sel is None:
            continue  # isz[out0]: adding infinity is a no-op
        if cur is None:
            cur = (sel[0], sel[1], 1)
            events.append(("load", sel))
        else:
            cur = _jac_add_affine(cur, sel[0], sel[1])
            if cur is None:
                events.append(("clear",))
            else:
                jac_saved.append(cur)
                events.append(("add", sel))

    affs = _batch_affine(jac_saved)

    memo: Memo = {}
    if p11 is not None:
        memo[("add", p1[0], p1[1], p2[0], p2[1])] = p11
        memo[("add", p2[0], p2[1], p1[0], p1[1])] = p11
    cur_aff = None
    k = 0
    for ev in events:
        if ev[0] == "load":
            cur_aff = ev[1]
        elif ev[0] == "clear":
            cur_aff = None
        elif ev[0] == "dbl":
            out = affs[k]
            k += 1
            memo[("dbl", cur_aff[0], cur_aff[1])] = out
            cur_aff = out
        else:  # add
            out = affs[k]
            k += 1
            sel = ev[1]
            memo[("add", cur_aff[0], cur_aff[1], sel[0], sel[1])] = out
            memo[("add", sel[0], sel[1], cur_aff[0], cur_aff[1])] = out
            cur_aff = out
    return memo
