"""fflonk: PLONK with folded commitments and ONE batched KZG opening.

The port's copy of ``xlayer_prover_tpu/snark/fflonk.py`` (the reference's
rapidsnark fflonk prover, src/rapidsnark/fflonk_prover.hpp,
zkey_fflonk.cpp): the 14 PLONK polynomials fold into three commitments

  C0(X) = qL(X^8) + X qR(X^8) + ... + X^7 Ssigma3(X^8)   (preprocessed)
  C1(X) = a(X^4) + X b(X^4) + X^2 c(X^4) + X^3 T0(X^4)
  C2(X) = z(X^3) + X T1(X^3) + X^2 T2(X^3)

opened on the 8th/4th/3rd roots of one evaluation point xi = xi_seed^24
(lcm(8,4,3) = 24, so every root set is a power of xi_seed times roots of
unity), then a single Shplonk pair (W, W') proves all openings with two
G1 points — the final proof is 4 G1 points + 15 field evaluations.

T0/T1(xi)/T2(xi) are NOT shipped: the verifier derives them from the
PLONK identities at xi, which is what binds the gate and permutation
equations.  The pairing check is
    e([L] + y [W'], [1]_2) == e([W'], [tau]_2),
with [L] assembled by the verifier from [C0], [C1], [C2], [W] and the
interpolated r_i(y) values.

Keys, transcript, blinding draws and proof are the JAX package's, byte for
byte under the same ``random.Random``: ``setup`` draws tau first, ``prove``
draws the blinding scalars 2, 2, 2 (a, b, c) and then 3 (z).  The work runs
on the keys' device (the card unless the caller asks for the CPU), on
(len, 4) int64 canonical Fr words:

  * polynomials: ``padd``, ``psub``, ``pscale``, ``pmul``, ``peval``,
    ``pdiv_zh``, ``pdivmod`` (by a binomial), ``_shift_omega`` and
    ``_combine`` take and give word tensors (``_trim`` sets lengths only);
    the few-point sets' helpers (``_vanishing``, ``_lagrange_at``,
    ``_interp``, ``_root_sets``) are Python ints, as in the JAX package;
  * ``setup``: tau^i by ``fr_scan_mul``, the SRS by ``fixed_base_g1`` in
    chunks, the copy permutation by one stable sort (``plonk.sigma``), its
    tags k w^i by ``fr_scan_mul``, the eight INTTs by ``fr_ntt``, [C0] by
    ``msm_g1`` in chunks of MSM_CHUNK points (the partial sums added on
    the host: the same point);
  * ``prove``: every product in evaluation form — T0's gate identity on
    the 4n domain (``fr_pointwise`` "gate"), T2's on the 8n domain
    ("perm_t2", z(w X) as the values 8 apart), each then an INTT and the
    division by X^n - 1 (``fr_div_binomial``, its remainder checked zero,
    as the JAX ``pdiv_zh`` asserts); z's grand product from two
    ``fr_scan_mul`` and one inversion (z_{i+1} = prod num / prod den); T1
    as (z - 1) / (n (X - 1)), the same polynomial as L1 (z - 1) / Z_H;
    every evaluation by ``fr_eval``; the openings' quotients by the root
    sets' binomials X^8 - xi, X^4 - xi, (X^3 - s2^3)(X^3 - s2b^3) and W' =
    L / (X - y) by ``fr_div_binomial`` (each remainder checked against the
    interpolation, as the JAX package asserts); W and L by ``fr_pointwise``
    "lincomb";
  * ``verify``: the JAX package's host check (Python ints, one pairing
    product).

``setup`` and ``prove`` take the circuit as ``plonk.PlonkArrays``
(``plonk.r1cs_to_arrays``, or ``plonk.arrays_of`` of the list form);
``prove`` reads the wire values from ``arr.vals``.
"""

from __future__ import annotations

import dataclasses
import secrets
import time
from typing import List, Optional

import torch

from .. import device as devices
from ..fields import bn254
from ..fields.bn254 import R, g1_add, g1_from_affine, g1_mul, g1_to_affine
from ..fields.bn254_tower import (FINAL_EXP, FQ12_ONE, G2_GEN, cast_g1,
                                  fq12_mul, fq12_pow, g2_mul, miller_loop,
                                  twist)
from ..ops import bn254_msm, fr_poly, ntt_fr
from ..ops.bn254_mont import from_words, to_words
from ..ops.ntt_fr import root_of_unity as _fr_root_of_unity
from ..utils.keccak import keccak256
from . import plonk
from .groth16 import _g1 as _g1_gen

K1 = 2
K2 = 3
C0_POLYS = ("qL", "qR", "qM", "qO", "qC", "S1", "S2", "S3")
MSM_CHUNK = 1 << 24          # points an msm_g1 call of a commitment takes
FIXED_BASE_CHUNK = 1 << 24   # scalars a fixed_base_g1 call of the SRS takes


def _words(values, device) -> torch.Tensor:
    return torch.from_numpy(to_words(int(v) % R for v in values)).to(device)


def _zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((n, 4), dtype=torch.int64, device=device)


def _pad(p: torch.Tensor, n: int) -> torch.Tensor:
    """p's first min(len, n) rows, zero-padded to n."""
    out = _zeros(n, p.device)
    k = min(n, p.shape[0])
    out[:k] = p[:k]
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Seconds by part, each read after a synchronise of the device."""

    def __init__(self, timings: dict, device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def lap(self, key: str):
        _sync(self.device)
        now = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + now - self.t
        self.t = now


# ---------------------------------------------------------------------------
# Fr polynomial helpers on word tensors (coefficients little-endian)
# ---------------------------------------------------------------------------

def _trim(p: torch.Tensor) -> torch.Tensor:
    """p without its zero top coefficients (at least one row)."""
    live = (p != 0).any(1).nonzero()
    return p[:max(1, int(live[-1]) + 1 if live.numel() else 1)]


def padd(p, q):
    return _trim(fr_poly.pointwise("lincomb", [p, q], [1, 1]))


def psub(p, q):
    return _trim(fr_poly.pointwise("lincomb", [p, q], [1, R - 1]))


def pscale(p, k):
    return _trim(fr_poly.pointwise("lincomb", [p], [k % R]))


def pmul(p, q):
    """The product, in evaluation form on the smallest power-of-two
    domain that holds it."""
    p, q = _trim(p), _trim(q)
    out_len = p.shape[0] + q.shape[0] - 1
    size = 1 << (out_len - 1).bit_length()
    fa = ntt_fr.ntt(_pad(p, size))
    fb = ntt_fr.ntt(_pad(q, size))
    fc = fr_poly.pointwise("mul", [fa, fb], [1])
    return _trim(ntt_fr.ntt(fc, inverse=True)[:out_len])


def peval(p, x):
    return fr_poly.evaluate(p, [x])[0]


def pdiv_zh(p, n):
    """Exact division by Z_H = X^n - 1."""
    return _trim(fr_poly.div_binomial(p, n, 1, exact=True)[0])


def pdivmod(p, d):
    """Division by a binomial d = [d0, 0, .., 0, dk] (Python ints, monic
    not required) -> (quotient, remainder) word tensors."""
    d = [int(v) % R for v in d]
    while len(d) > 1 and d[-1] == 0:
        d = d[:-1]
    k = len(d) - 1
    if k < 1 or any(d[1:k]):
        raise ValueError("pdivmod divides by a binomial X^k - c only")
    inv_lead = pow(d[-1], R - 2, R)
    q, r = fr_poly.div_binomial(p, k, (-d[0]) * inv_lead % R)
    return pscale(q, inv_lead), _trim(r)


def _shift_omega(p, w):
    """p(X*w) coefficient scaling."""
    powers = fr_poly.scan_mul(_words([w], p.device), exclusive=True,
                              n=p.shape[0])
    return fr_poly.pointwise("mul", [p, powers], [1])


def _combine(polys, t: int):
    """C(X) = sum_i p_i(X^t) X^i."""
    out_len = t * max(p.shape[0] for p in polys) + len(polys)
    out = _zeros(out_len, polys[0].device)
    for i, p in enumerate(polys):
        out[i:i + t * p.shape[0]:t] = p
    return _trim(out)


# -- the few-point sets, Python ints ----------------------------------------

def _itrim(p: List[int]) -> List[int]:
    while len(p) > 1 and p[-1] == 0:
        p = p[:-1]
    return p


def _ipadd(p, q):
    n = max(len(p), len(q))
    return _itrim([((p[i] if i < len(p) else 0)
                    + (q[i] if i < len(q) else 0)) % R for i in range(n)])


def _ipmul(p, q):
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        if a:
            for j, b in enumerate(q):
                out[i + j] = (out[i + j] + a * b) % R
    return _itrim(out)


def _vanishing(points: List[int]) -> List[int]:
    z = [1]
    for pt in points:
        z = _ipmul(z, [(-pt) % R, 1])
    return z


def _lagrange_at(points: List[int], values: List[int], y: int) -> int:
    acc = 0
    for i, (xi, vi) in enumerate(zip(points, values)):
        num = 1
        den = 1
        for j, xj in enumerate(points):
            if j != i:
                num = num * (y - xj) % R
                den = den * (xi - xj) % R
        acc = (acc + vi * num * pow(den, R - 2, R)) % R
    return acc


def _interp(points, values):
    """Lagrange interpolation -> coefficient poly (tiny point sets)."""
    acc = [0]
    for i, (xi, vi) in enumerate(zip(points, values)):
        term = [1]
        den = 1
        for j, xj in enumerate(points):
            if j != i:
                term = _ipmul(term, [(-xj) % R, 1])
                den = den * (xi - xj) % R
        k = vi * pow(den, R - 2, R) % R
        acc = _ipadd(acc, _itrim([v * k % R for v in term]))
    return acc


def _root_sets(xi_seed: int, n: int):
    """S0 = 8th roots of xi, S1 = 4th roots, S2 = 3rd roots of xi and of
    xi*w  (xi = xi_seed^24)."""
    w8 = _nth_root_of_unity(8)
    w4 = w8 * w8 % R
    w3 = _nth_root_of_unity(3)
    s0 = pow(xi_seed, 3, R)
    s1 = pow(xi_seed, 6, R)
    s2 = pow(xi_seed, 8, R)
    s0_pts = [s0 * pow(w8, k, R) % R for k in range(8)]
    s1_pts = [s1 * pow(w4, k, R) % R for k in range(4)]
    # cube root of the domain's omega
    w_n3 = _root_of_order(3 * n)
    s2b = s2 * w_n3 % R
    s2_pts = [s2 * pow(w3, k, R) % R for k in range(3)] + \
        [s2b * pow(w3, k, R) % R for k in range(3)]
    return s0_pts, s1_pts, s2_pts


def _nth_root_of_unity(k: int) -> int:
    return _root_of_order(k)


def _root_of_order(k: int) -> int:
    assert (R - 1) % k == 0, k
    g = 5                      # BN254 Fr multiplicative generator
    r_ = pow(g, (R - 1) // k, R)
    assert pow(r_, k, R) == 1 and pow(r_, k // 2 if k % 2 == 0 else k, R)
    return r_


# ---------------------------------------------------------------------------
# setup / keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FflonkProvingKey:
    n: int
    n_public: int
    taus_g1: torch.Tensor    # (10 n + 41, 8) G1 affine words: [tau^i] G1
    c0: tuple                # [C0] G1 affine
    polys: dict              # preprocessed coefficient polys, (n, 4) words
    sigma_cols: tuple        # S1,S2,S3 evaluations (for z), (n, 4) words
    q_cols: dict             # selector columns, (n, 4) words


@dataclasses.dataclass
class FflonkVerifyingKey:
    n: int
    n_public: int
    c0: tuple
    g2_gen: object
    g2_tau: object


@dataclasses.dataclass
class FflonkProof:
    c1: tuple
    c2: tuple
    w: tuple
    w2: tuple
    evals: dict              # name -> int


def _commit(taus_g1: torch.Tensor, poly: torch.Tensor):
    """[poly(tau)] G1: msm_g1 over chunks of MSM_CHUNK points, the partial
    sums added on the host.  The zero polynomial commits to
    g1_to_affine(g1_mul(taus_g1[0], 0)), as in the JAX package."""
    assert poly.shape[0] <= taus_g1.shape[0], (poly.shape[0],
                                               taus_g1.shape[0])
    if not bool((poly != 0).any()):
        first = bn254_msm.g1_points(taus_g1[:1])[0]
        return g1_to_affine(g1_mul(g1_from_affine(first), 0))
    acc = bn254.INF
    for s in range(0, poly.shape[0], MSM_CHUNK):
        e = min(poly.shape[0], s + MSM_CHUNK)
        part = bn254_msm.to_affine_g1(bn254_msm.msm_g1(taus_g1[s:e],
                                                       poly[s:e]))
        acc = g1_add(acc, g1_from_affine(part))
    return g1_to_affine(acc)


def _srs(taus: torch.Tensor) -> torch.Tensor:
    """[tau^i] G1 for every scalar, fixed_base_g1 over chunks of
    FIXED_BASE_CHUNK."""
    out = torch.empty((taus.shape[0], 8), dtype=torch.int64,
                      device=taus.device)
    for s in range(0, taus.shape[0], FIXED_BASE_CHUNK):
        e = min(taus.shape[0], s + FIXED_BASE_CHUNK)
        out[s:e] = bn254_msm.fixed_base_g1(bn254.G1_GEN, taus[s:e])
    return out


def setup(arr: plonk.PlonkArrays, rng=None, device=None, timings: Optional[dict] = None):
    """Test-environment trusted setup with its key on `device` (None: the
    card).  `timings` receives ``srs_s`` (tau^i and the SRS), ``sigma_s``
    (the copy permutation and its tags), ``ntt_s`` (the eight INTTs) and
    ``c0_s`` ([C0]), each after a synchronise."""
    if rng is None:
        rng = secrets.SystemRandom()
    dev = devices.resolve(device)
    timings = {} if timings is None else timings
    clock = _Clock(timings, dev)
    n = arr.n
    tau = rng.randrange(1, R)
    max_pow = 10 * n + 40
    taus = fr_poly.scan_mul(_words([tau], dev), exclusive=True,
                            n=max_pow + 1)
    taus_g1 = _srs(taus)
    del taus
    clock.lap("srs_s")

    w = _fr_root_of_unity(n.bit_length() - 1)
    q_cols = {k: _pad(torch.from_numpy(arr.q[k]).to(dev), n)
              for k in ("qL", "qR", "qM", "qO", "qC")}
    sig = plonk.sigma(torch.from_numpy(arr.wires).to(dev), n)
    one = _words([w], dev)
    tags = torch.cat([fr_poly.scan_mul(one, exclusive=True, init=k, n=n)
                      for k in (1, K1, K2)])
    s_all = tags[sig]
    del tags, sig
    s_cols = tuple(s_all[j * n:(j + 1) * n] for j in range(3))
    clock.lap("sigma_s")

    polys = {}
    for name, colv in list(q_cols.items()) + [
            ("S1", s_cols[0]), ("S2", s_cols[1]), ("S3", s_cols[2])]:
        polys[name] = ntt_fr.ntt(colv, inverse=True)
    clock.lap("ntt_s")
    c0 = _commit(taus_g1, _combine([polys[k] for k in C0_POLYS], 8))
    clock.lap("c0_s")
    pk = FflonkProvingKey(n=n, n_public=arr.n_public, taus_g1=taus_g1,
                          c0=c0, polys=polys, sigma_cols=s_cols,
                          q_cols=q_cols)
    vk = FflonkVerifyingKey(n=n, n_public=arr.n_public, c0=c0,
                            g2_gen=G2_GEN, g2_tau=g2_mul(G2_GEN, tau))
    return pk, vk


@dataclasses.dataclass
class HostProvingKey:
    """The JAX package's FflonkProvingKey layout: Python ints, the polys
    trimmed as it trims them."""
    n: int
    n_public: int
    taus_g1: list
    c0: tuple
    polys: dict
    sigma_cols: tuple
    q_cols: dict


def key_to_host(pk: FflonkProvingKey) -> HostProvingKey:
    def ints(t):
        return from_words(t)
    return HostProvingKey(
        n=pk.n, n_public=pk.n_public,
        taus_g1=bn254_msm.g1_points(pk.taus_g1), c0=pk.c0,
        polys={k: _itrim(ints(v)) for k, v in pk.polys.items()},
        sigma_cols=tuple(ints(v) for v in pk.sigma_cols),
        q_cols={k: ints(v) for k, v in pk.q_cols.items()})


def key_digests(host) -> dict:
    """sha256 of a proving key's parts over their canonical 32-byte
    little-endian words, for a key in the JAX package's layout (its own,
    or ``key_to_host``'s): the SRS's coordinates, each trimmed poly, the
    sigma and selector columns."""
    import hashlib

    def digest(values):
        return hashlib.sha256(to_words(values).tobytes()).hexdigest()
    out = {"taus_g1": digest(v for pt in host.taus_g1 for v in pt)}
    out.update({f"poly_{k}": digest(v) for k, v in host.polys.items()})
    out.update({f"sigma_{j + 1}": digest(v)
                for j, v in enumerate(host.sigma_cols)})
    out.update({f"q_{k}": digest(v) for k, v in host.q_cols.items()})
    return out


def to_json(vk, proof, publics) -> dict:
    """A verifying key, proof and publics (the port's or the JAX
    package's objects) as JSON values, numbers as decimal strings."""
    def pt(p):
        return None if p is None else [str(v) for v in p]

    def g2(p):
        return [[str(v) for v in c] for c in p]
    return {"vk": {"n": vk.n, "n_public": vk.n_public, "c0": pt(vk.c0),
                   "g2_gen": g2(vk.g2_gen), "g2_tau": g2(vk.g2_tau)},
            "proof": {"c1": pt(proof.c1), "c2": pt(proof.c2),
                      "w": pt(proof.w), "w2": pt(proof.w2),
                      "evals": {k: str(v) for k, v in proof.evals.items()}},
            "publics": [str(int(v)) for v in publics]}


# ---------------------------------------------------------------------------
# transcript
# ---------------------------------------------------------------------------

class _FS:
    def __init__(self):
        self.state = b"fflonk"

    def absorb_point(self, pt):
        self.state = keccak256(self.state + int(pt[0]).to_bytes(32, "big")
                               + int(pt[1]).to_bytes(32, "big"))

    def absorb_scalar(self, v):
        self.state = keccak256(self.state + int(v).to_bytes(32, "big"))

    def challenge(self) -> int:
        self.state = keccak256(self.state)
        return int.from_bytes(self.state, "big") % R


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------

def _blind(coeffs: torch.Tensor, bs: List[int]) -> torch.Tensor:
    """coeffs + (b_0 + b_1 X + ..) (X^n - 1), n = len(coeffs)."""
    n, k = coeffs.shape[0], len(bs)
    out = torch.cat([coeffs, _zeros(k, coeffs.device)])
    head = from_words(out[:k])
    out[:k] = _words([(h - b) % R for h, b in zip(head, bs)], out.device)
    out[n:n + k] = _words(bs, out.device)
    return out


def _quotient(cpoly: torch.Tensor, pts: List[int], binomials):
    """The quotient of cpoly by the root set's vanishing polynomial, the
    product of the binomials X^k - c in turn; the remainder must be the
    interpolation of cpoly on pts (the JAX package asserts the division
    of cpoly - r exact).  -> (quotient, cpoly's values on pts)"""
    vals = fr_poly.evaluate(cpoly, pts)
    r_poly = _interp(pts, vals)
    q, rem, mod = cpoly, [0], [1]
    for k, c in binomials:
        q, r = fr_poly.div_binomial(q, k, c)
        # rem += r * (the binomials before this one)
        rem = _ipadd(rem, _ipmul(from_words(r), mod))
        mod = _ipmul(mod, [(-c) % R] + [0] * (k - 1) + [1])
    assert _itrim(rem) == _itrim(list(r_poly)), "opening not exact"
    return q, vals


def prove(pk: FflonkProvingKey, arr: plonk.PlonkArrays, publics: List[int],
          rng=None, timings: Optional[dict] = None) -> FflonkProof:
    """A proof of `arr` with its wire values on the key's device.  `timings` receives, each after a
    synchronise: ``ntt_s`` (the INTTs and NTTs with their zero padding),
    ``pointwise_s`` (the identities, z's scans, the linear combinations),
    ``div_s`` (the divisions by X^n - 1, X - 1, the root sets and X - y),
    ``eval_s`` (the 15 evaluations and the root sets' values),
    ``commit_c1_s``, ``commit_c2_s``, ``commit_w_s``, ``commit_w2_s``
    (the MSMs and their combination), ``host_s`` (wire columns,
    blinding, transcript)."""
    if rng is None:
        rng = secrets.SystemRandom()
    timings = {} if timings is None else timings
    n = pk.n
    dev = pk.taus_g1.device
    clock = _Clock(timings, dev)
    w = _fr_root_of_unity(n.bit_length() - 1)
    wires = torch.from_numpy(arr.wires).to(dev)
    values = torch.from_numpy(arr.vals).to(dev)
    a_col, b_col, c_col = (_pad(values[wires[j]], n) for j in range(3))
    del values, wires
    pi_col = _zeros(n, dev)
    if pk.n_public:
        pi_col[:pk.n_public] = _words([-int(p) for p in
                                       publics[:pk.n_public]], dev)
    clock.lap("host_s")

    def blind(col, k):
        p = ntt_fr.ntt(col, inverse=True)
        bs = [rng.randrange(R) for _ in range(k)]
        return _blind(p, bs)

    a_p = blind(a_col, 2)
    b_p = blind(b_col, 2)
    c_p = blind(c_col, 2)
    pi_p = ntt_fr.ntt(pi_col, inverse=True)
    del pi_col
    clock.lap("ntt_s")

    # T0 = (qM a b + qL a + qR b + qO c + qC + PI) / Z_H, the gate's
    # degree 3n + 1 on the 4n domain
    e4 = [ntt_fr.ntt(_pad(p, 4 * n)) for p in (
        pk.polys["qM"], pk.polys["qL"], pk.polys["qR"], pk.polys["qO"],
        pk.polys["qC"], a_p, b_p, c_p, pi_p)]
    clock.lap("ntt_s")
    gate_e = fr_poly.pointwise("gate", e4)
    del e4
    clock.lap("pointwise_s")
    gate = ntt_fr.ntt(gate_e, inverse=True)
    del gate_e
    clock.lap("ntt_s")
    t0 = pdiv_zh(gate, n)
    del gate
    clock.lap("div_s")
    c1_poly = _combine([a_p, b_p, c_p, t0], 4)
    del t0
    c1 = _commit(pk.taus_g1, c1_poly)
    clock.lap("commit_c1_s")

    fs = _FS()
    fs.absorb_point(pk.c0)
    for p in publics:
        fs.absorb_scalar(p)
    fs.absorb_point(c1)
    beta = fs.challenge()
    gamma = fs.challenge()

    # grand product z: z_0 = 1, z_{i+1} = prod_{j <= i} num_j / den_j
    s1c, s2c, s3c = pk.sigma_cols
    num, den = fr_poly.pointwise("perm_z", [a_col, b_col, c_col, s1c, s2c,
                                            s3c], [beta, gamma], w)
    del a_col, b_col, c_col
    pnum = fr_poly.scan_mul(num[:n - 1].contiguous())
    # suffix products prod_{i < j <= n - 2} den_j
    sden = fr_poly.scan_mul(den[:n - 1], exclusive=True, reverse=True)
    total = from_words(sden[:1])[0] * from_words(den[:1])[0] % R
    del num, den
    if total == 0:
        raise ValueError("a zero permutation denominator")
    z_col = torch.cat([_words([1], dev), fr_poly.pointwise(
        "mul", [pnum, sden], [pow(total, R - 2, R)])])
    del pnum, sden
    clock.lap("pointwise_s")
    z_p = _blind(ntt_fr.ntt(z_col, inverse=True),
                 [rng.randrange(R) for _ in range(3)])
    del z_col
    clock.lap("ntt_s")

    # T1 = L1 (z - 1) / Z_H = (z - 1) / (n (X - 1))
    zm1 = z_p.clone()
    zm1[:1] = _words([from_words(z_p[:1])[0] - 1], dev)
    q, _r = fr_poly.div_binomial(zm1, 1, 1, exact=True)
    del zm1
    t1 = pscale(q, pow(n, R - 2, R))
    del q
    clock.lap("div_s")

    # T2 = (z f - z(w X) g) / Z_H, degree 4n + 5 on the 8n domain
    n8 = 8 * n
    e8 = [ntt_fr.ntt(_pad(p, n8)) for p in (
        a_p, b_p, c_p, pk.polys["S1"], pk.polys["S2"], pk.polys["S3"], z_p)]
    clock.lap("ntt_s")
    t2_e = fr_poly.pointwise("perm_t2", e8, [beta, gamma],
                             _fr_root_of_unity(n8.bit_length() - 1),
                             shift=8)
    del e8
    clock.lap("pointwise_s")
    t2_num = ntt_fr.ntt(t2_e, inverse=True)
    del t2_e
    clock.lap("ntt_s")
    t2 = pdiv_zh(t2_num, n)
    del t2_num
    clock.lap("div_s")
    c2_poly = _combine([z_p, t1, t2], 3)
    c2 = _commit(pk.taus_g1, c2_poly)
    clock.lap("commit_c2_s")

    fs.absorb_point(c2)
    xi_seed = fs.challenge()
    xi = pow(xi_seed, 24, R)
    xiw = xi * w % R

    evals = {"a": peval(a_p, xi), "b": peval(b_p, xi),
             "c": peval(c_p, xi)}
    for k in ("qL", "qR", "qM", "qO", "qC", "S1", "S2", "S3"):
        evals[k] = peval(pk.polys[k], xi)
    evals["z"], evals["zw"] = fr_poly.evaluate(z_p, [xi, xiw])
    evals["t1w"] = peval(t1, xiw)
    evals["t2w"] = peval(t2, xiw)
    del a_p, b_p, c_p, pi_p, z_p, t1, t2
    clock.lap("eval_s")
    for k in sorted(evals):
        fs.absorb_scalar(evals[k])
    alpha = fs.challenge()

    # opening point sets
    s0_pts, s1_pts, s2_pts = _root_sets(xi_seed, n)
    c0_poly = _combine([pk.polys[k] for k in C0_POLYS], 8)
    s0, s1, s2 = s0_pts[0], s1_pts[0], s2_pts[0]
    sets = ((c0_poly, s0_pts, [(8, pow(s0, 8, R))]),
            (c1_poly, s1_pts, [(4, pow(s1, 4, R))]),
            (c2_poly, s2_pts, [(3, pow(s2, 3, R)),
                               (3, pow(s2_pts[3], 3, R))]))
    quots, set_vals = [], []
    for cpoly, pts, binomials in sets:
        q, v = _quotient(cpoly, pts, binomials)
        quots.append(q)
        set_vals.append(v)
    clock.lap("div_s")
    w_poly = _trim(fr_poly.pointwise("lincomb", quots,
                                     [1, alpha, alpha * alpha % R]))
    del quots
    clock.lap("pointwise_s")
    w_c = _commit(pk.taus_g1, w_poly)
    clock.lap("commit_w_s")
    fs.absorb_point(w_c)
    y = fs.challenge()

    # L(X) = sum_i alpha^i (Z_T/Z_Si)(y) (C_i(X) - r_i(y)) - Z_T(y) W(X)
    zt_y = 1
    for pts in (s0_pts, s1_pts, s2_pts):
        for p in pts:
            zt_y = zt_y * (y - p) % R
    coefs, shift = [], 0
    for i, ((_cpoly, pts, _b), vals_) in enumerate(zip(sets, set_vals)):
        zs_y = 1
        for p in pts:
            zs_y = zs_y * (y - p) % R
        coef = pow(alpha, i, R) * zt_y % R * pow(zs_y, R - 2, R) % R
        coefs.append(coef)
        shift = (shift + coef * _lagrange_at(pts, vals_, y)) % R
    l_poly = fr_poly.pointwise("lincomb", [c0_poly, c1_poly, c2_poly, w_poly],
                               coefs + [(-zt_y) % R])
    del c0_poly, c1_poly, c2_poly, w_poly, sets
    l_poly[:1] = _words([from_words(l_poly[:1])[0] - shift], dev)
    clock.lap("pointwise_s")
    w2_poly, _r = fr_poly.div_binomial(l_poly, 1, y, exact=True)
    del l_poly
    clock.lap("div_s")
    w2_c = _commit(pk.taus_g1, w2_poly)
    clock.lap("commit_w2_s")
    return FflonkProof(c1=c1, c2=c2, w=w_c, w2=w2_c, evals=evals)


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------

def verify(vk: FflonkVerifyingKey, proof: FflonkProof,
           publics: List[int]) -> bool:
    n = vk.n
    w = _fr_root_of_unity(n.bit_length() - 1)
    ev = proof.evals

    fs = _FS()
    fs.absorb_point(vk.c0)
    for p in publics:
        fs.absorb_scalar(p)
    fs.absorb_point(proof.c1)
    beta = fs.challenge()
    gamma = fs.challenge()
    fs.absorb_point(proof.c2)
    xi_seed = fs.challenge()
    xi = pow(xi_seed, 24, R)
    for k in sorted(ev):
        fs.absorb_scalar(ev[k])
    alpha = fs.challenge()
    fs.absorb_point(proof.w)
    y = fs.challenge()

    zh_xi = (pow(xi, n, R) - 1) % R
    if zh_xi == 0:
        return False
    l1_xi = zh_xi * pow(n * (xi - 1) % R, R - 2, R) % R
    # PI(xi) from the publics (PI rows are the first gates)
    pi_xi = 0
    dom = 1
    lag_den_base = pow(n, R - 2, R)
    for i, p in enumerate(publics):
        li = zh_xi * dom % R * pow((xi - dom) % R, R - 2, R) % R \
            * lag_den_base % R
        pi_xi = (pi_xi - int(p) * li) % R
        dom = dom * w % R

    # derived quotient evaluations (binds the PLONK identities at xi)
    t0_xi = (ev["qM"] * ev["a"] * ev["b"] + ev["qL"] * ev["a"]
             + ev["qR"] * ev["b"] + ev["qO"] * ev["c"] + ev["qC"]
             + pi_xi) % R * pow(zh_xi, R - 2, R) % R
    t1_xi = l1_xi * (ev["z"] - 1) % R * pow(zh_xi, R - 2, R) % R
    f_xi = ((ev["a"] + beta * xi + gamma)
            * (ev["b"] + beta * K1 * xi + gamma)
            * (ev["c"] + beta * K2 * xi + gamma)) % R
    g_xi = ((ev["a"] + beta * ev["S1"] + gamma)
            * (ev["b"] + beta * ev["S2"] + gamma)
            * (ev["c"] + beta * ev["S3"] + gamma)) % R
    t2_xi = (ev["z"] * f_xi - ev["zw"] * g_xi) % R \
        * pow(zh_xi, R - 2, R) % R

    s0_pts, s1_pts, s2_pts = _root_sets(xi_seed, n)
    # restriction values of the combined polys on their root sets
    p0 = [ev[k] for k in C0_POLYS]
    v0 = [sum(p0[i] * pow(x, i, R) for i in range(8)) % R for x in s0_pts]
    p1 = [ev["a"], ev["b"], ev["c"], t0_xi]
    v1 = [sum(p1[i] * pow(x, i, R) for i in range(4)) % R for x in s1_pts]
    p2a = [ev["z"], t1_xi, t2_xi]
    p2b = [ev["zw"], ev["t1w"], ev["t2w"]]
    v2 = [sum(p2a[i] * pow(x, i, R) for i in range(3)) % R
          for x in s2_pts[:3]] + \
         [sum(p2b[i] * pow(x, i, R) for i in range(3)) % R
          for x in s2_pts[3:]]

    zt_y = 1
    for pts in (s0_pts, s1_pts, s2_pts):
        for p in pts:
            zt_y = zt_y * (y - p) % R

    # [L] = sum coef_i ([C_i] - r_i(y) G) - Z_T(y) [W]
    l_acc = None
    scalar_acc = 0
    for i, (c_pt, pts, vals_) in enumerate((
            (vk.c0, s0_pts, v0), (proof.c1, s1_pts, v1),
            (proof.c2, s2_pts, v2))):
        zs_y = 1
        for p in pts:
            zs_y = zs_y * (y - p) % R
        coef = pow(alpha, i, R) * zt_y % R * pow(zs_y, R - 2, R) % R
        r_y = _lagrange_at(pts, vals_, y)
        term = g1_mul(g1_from_affine(c_pt), coef)
        l_acc = term if l_acc is None else g1_add(l_acc, term)
        scalar_acc = (scalar_acc + coef * r_y) % R
    l_acc = g1_add(l_acc, g1_from_affine(_g1_gen((-scalar_acc) % R)))
    l_acc = g1_add(l_acc, g1_mul(g1_from_affine(proof.w),
                                 (-zt_y) % R))
    # e([L] + y [W'], [1]_2) == e([W'], [tau]_2)
    lhs_pt = g1_to_affine(g1_add(l_acc, g1_mul(g1_from_affine(proof.w2),
                                               y)))
    f = miller_loop(twist(vk.g2_gen), cast_g1(lhs_pt))
    neg_w2 = g1_to_affine(bn254.g1_neg(g1_from_affine(proof.w2)))
    f = fq12_mul(f, miller_loop(twist(vk.g2_tau), cast_g1(neg_w2)))
    return fq12_pow(f, FINAL_EXP) == FQ12_ONE
