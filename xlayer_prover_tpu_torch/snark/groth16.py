"""Groth16 over BN254: setup, prover, verifier.

The port's copy of ``xlayer_prover_tpu/snark/groth16.py`` (the reference's
rapidsnark stage, src/rapidsnark/groth16.hpp:37-40; invoked at
prover.cpp:926-980 to wrap the RecursiveF STARK into the on-chain SNARK).
Its group and field work runs on the card:

  * ``setup`` draws tau, alpha, beta, gamma, delta from `rng` exactly as
    the JAX package does, evaluates every wire's A, B, C polynomials at
    tau on the host (``_wire_polys_at_tau``, as written there), and builds
    the G1 queries (a, b1, c, h and the verifier's ic) with one
    ``fixed_base_g1`` over all their scalars and b2 with ``fixed_base_g2``.
  * ``ProvingKey`` holds its five queries on the device as (n, 8) / (n, 16)
    int64 affine words (``ops/bn254_msm.py``; zero words are infinity, so
    the public wires' c entries are zero rows); its five single points,
    the ``VerifyingKey`` and the ``Proof`` are host Python ints, as in the
    JAX package.
  * ``prove`` draws r then s before any MSM, evaluates each constraint's
    A, B, C rows at the witness on the host, runs h's seven Fr NTTs and
    the pointwise a b - c on the card (``ops/ntt_fr.py``), checks the
    division by x^m - 1 as one tensor compare, feeds h straight into its
    MSM, runs the MSMs (``msm_g1`` over a, b1, c, h; ``msm_g2`` over b2)
    and combines the blinding on the host.
  * ``verify`` is the JAX package's three-pairing check.
  * ``keys_from_host`` / ``keys_to_host`` carry the JAX package's key
    objects (Python ints, None for infinity) into the port's and back.

On a CPU device every kernel wrapper runs its plain PyTorch version.
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
                                  fq12_mul, fq12_pow, g2_add, g2_mul,
                                  miller_loop, twist)
from ..ops import bn254_msm, ntt_fr
from ..ops.bn254_mont import to_words
from ..ops.ntt_fr import root_of_unity as _fr_root_of_unity
from .r1cs import R1CS

G1_GEN = bn254.G1_GEN


@dataclasses.dataclass
class ProvingKey:
    n_public: int
    n_wires: int
    domain_bits: int
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: torch.Tensor   # (n_wires, 8) G1 affine words
    b1_query: torch.Tensor  # (n_wires, 8) G1
    b2_query: torch.Tensor  # (n_wires, 16) G2
    c_query: torch.Tensor   # (n_wires, 8) G1 (zero rows for public wires)
    h_query: torch.Tensor   # (domain - 1, 8) G1


@dataclasses.dataclass
class HostProvingKey:
    """The JAX package's ProvingKey layout: lists of affine points."""
    n_public: int
    n_wires: int
    domain_bits: int
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: list          # [n_wires] G1
    b1_query: list         # [n_wires] G1
    b2_query: list         # [n_wires] G2
    c_query: list          # [n_wires] G1 (None for public wires)
    h_query: list          # [domain-1] G1


@dataclasses.dataclass
class VerifyingKey:
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: list               # [n_public + 1] G1


@dataclasses.dataclass
class Proof:
    a: tuple               # G1 affine
    b: tuple               # G2 affine (pair of Fq2)
    c: tuple               # G1 affine


_SINGLE = ("n_public", "n_wires", "domain_bits", "alpha1", "beta1", "beta2",
           "delta1", "delta2")


def _g1(k: int):
    return g1_to_affine(g1_mul(g1_from_affine(G1_GEN), k % R))


def _g2(k: int):
    return g2_mul(G2_GEN, k % R)


def _scalars(values, device) -> torch.Tensor:
    """Python ints -> (n, 4) int64 words of their values mod r."""
    return torch.from_numpy(to_words(v % R for v in values)).to(device)


def _wire_polys_at_tau(r1cs: R1CS, tau: int, domain_bits: int):
    """A_j(tau), B_j(tau), C_j(tau) for every wire j via Lagrange weights."""
    m = 1 << domain_bits
    w = _fr_root_of_unity(domain_bits)
    # L_k(tau) = (tau^m - 1) * w^k / (m * (tau - w^k))
    tm = (pow(tau, m, R) - 1) % R
    minv = pow(m, R - 2, R)
    # batch inversion of the m denominators (Montgomery trick)
    pows = []
    cur = 1
    for _k in range(m):
        pows.append(cur)
        cur = cur * w % R
    denoms = [(tau - c) % R for c in pows]
    prefix = [1] * (m + 1)
    for k in range(m):
        prefix[k + 1] = prefix[k] * denoms[k] % R
    inv_all = pow(prefix[m], R - 2, R)
    invs = [0] * m
    for k in range(m - 1, -1, -1):
        invs[k] = inv_all * prefix[k] % R
        inv_all = inv_all * denoms[k] % R
    lk = [tm * pows[k] % R * minv % R * invs[k] % R for k in range(m)]
    a_t = [0] * r1cs.n_wires
    b_t = [0] * r1cs.n_wires
    c_t = [0] * r1cs.n_wires
    for k, (a, b, c) in enumerate(r1cs.constraints):
        for wj, coef in a.items():
            a_t[wj] = (a_t[wj] + coef * lk[k]) % R
        for wj, coef in b.items():
            b_t[wj] = (b_t[wj] + coef * lk[k]) % R
        for wj, coef in c.items():
            c_t[wj] = (c_t[wj] + coef * lk[k]) % R
    return a_t, b_t, c_t


def setup(r1cs: R1CS, rng: Optional[object] = None, device=None,
          timings: Optional[dict] = None):
    """Test-environment trusted setup (snarkjs zkey equivalent) with its
    queries on `device` (None: the card).  `timings` receives
    ``g16_wire_polys_s``, the host evaluation at tau."""
    dev = devices.resolve(device)
    timings = {} if timings is None else timings
    rand = (lambda: secrets.randbelow(R - 1) + 1) if rng is None \
        else (lambda: rng.randrange(1, R))
    tau, alpha, beta, gamma, delta = (rand() for _ in range(5))
    m = max(2, len(r1cs.constraints))
    domain_bits = (m - 1).bit_length()
    m = 1 << domain_bits

    t0 = time.perf_counter()
    a_t, b_t, c_t = _wire_polys_at_tau(r1cs, tau, domain_bits)
    timings["g16_wire_polys_s"] = time.perf_counter() - t0
    ginv = pow(gamma, R - 2, R)
    dinv = pow(delta, R - 2, R)
    n_wires, n_ic = r1cs.n_wires, r1cs.n_public + 1
    l_scalars = [(beta * a_t[j] + alpha * b_t[j] + c_t[j]) % R
                 for j in range(n_wires)]
    h_scalars = []
    cur = (pow(tau, m, R) - 1) % R * dinv % R
    for _i in range(m - 1):
        h_scalars.append(cur)
        cur = cur * tau % R
    # every G1 query in one batch: a | b1 | ic | c (private wires) | h
    g1 = bn254_msm.fixed_base_g1(G1_GEN, _scalars(
        a_t + b_t + [v * ginv % R for v in l_scalars[:n_ic]]
        + [v * dinv % R for v in l_scalars[n_ic:]] + h_scalars, dev))
    a_query, b1_query, ic, c_pts, h_query = torch.split(
        g1, [n_wires, n_wires, n_ic, n_wires - n_ic, m - 1])
    c_query = torch.cat([torch.zeros_like(ic), c_pts])
    b2_query = bn254_msm.fixed_base_g2(G2_GEN, _scalars(b_t, dev))

    pk = ProvingKey(n_public=r1cs.n_public, n_wires=n_wires,
                    domain_bits=domain_bits,
                    alpha1=_g1(alpha), beta1=_g1(beta), beta2=_g2(beta),
                    delta1=_g1(delta), delta2=_g2(delta),
                    a_query=a_query.contiguous(),
                    b1_query=b1_query.contiguous(), b2_query=b2_query,
                    c_query=c_query, h_query=h_query.contiguous())
    vk = VerifyingKey(alpha1=_g1(alpha), beta2=_g2(beta), gamma2=_g2(gamma),
                      delta2=_g2(delta), ic=bn254_msm.g1_points(ic))
    return pk, vk


def _h_coefficients(r1cs: R1CS, witness: List[int], domain_bits: int,
                    device) -> torch.Tensor:
    """h(x) = (A(x)B(x) - C(x)) / t(x) coefficient vector, (m - 1, 4)
    words on `device`.  Raises AssertionError if the witness does not
    satisfy the R1CS (the division leaves a remainder)."""
    m = 1 << domain_bits
    a_e = [0] * m
    b_e = [0] * m
    c_e = [0] * m
    for k, (a, b, c) in enumerate(r1cs.constraints):
        a_e[k] = sum(witness[w] * v for w, v in a.items()) % R
        b_e[k] = sum(witness[w] * v for w, v in b.items()) % R
        c_e[k] = sum(witness[w] * v for w, v in c.items()) % R

    def coset2(vals):       # evaluations on the 2m domain
        coeffs = ntt_fr.ntt(_scalars(vals, device), inverse=True)
        return ntt_fr.ntt(torch.cat([coeffs, torch.zeros_like(coeffs)]))

    d = ntt_fr.ntt(ntt_fr.mul_sub(coset2(a_e), coset2(b_e), coset2(c_e)),
                   inverse=True)                  # degree <= 2m - 2
    # divide by t(x) = x^m - 1: d_k = h_{k-m} - h_k, so h_j = d_{j+m};
    # the low coefficients must close the division: d_k = -d_{k+m}
    zero = torch.zeros_like(d[:m])
    if not torch.equal(ntt_fr.mul_sub(zero, zero, d[:m]), d[m:]):
        raise AssertionError("witness does not satisfy the R1CS")
    return d[m:2 * m - 1]


def prove(pk: ProvingKey, r1cs: R1CS, witness: List[int],
          rng: Optional[object] = None,
          timings: Optional[dict] = None) -> Proof:
    """A proof on the key's device.  `timings` receives ``g16_h_s``, the
    seconds of h (the host evaluations and the NTTs)."""
    assert len(witness) == pk.n_wires and witness[0] == 1
    timings = {} if timings is None else timings
    rand = (lambda: secrets.randbelow(R)) if rng is None \
        else (lambda: rng.randrange(R))
    r_blind = rand()
    s_blind = rand()
    dev = pk.a_query.device

    t0 = time.perf_counter()
    h = _h_coefficients(r1cs, witness, pk.domain_bits, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timings["g16_h_s"] = time.perf_counter() - t0
    wit = _scalars(witness, dev)
    npub = pk.n_public + 1
    a_acc = bn254_msm.to_affine_g1(bn254_msm.msm_g1(pk.a_query, wit))
    b1_acc = bn254_msm.to_affine_g1(bn254_msm.msm_g1(pk.b1_query, wit))
    h_acc = bn254_msm.to_affine_g1(bn254_msm.msm_g1(pk.h_query, h))
    c_acc = bn254_msm.to_affine_g1(bn254_msm.msm_g1(pk.c_query[npub:],
                                                    wit[npub:]))
    b2_acc = bn254_msm.to_affine_g2(bn254_msm.msm_g2(pk.b2_query, wit))

    def g1p(aff):
        return g1_from_affine(aff)

    a_pt = g1_add(g1p(a_acc) if a_acc else bn254.INF,
                  g1_add(g1p(pk.alpha1), g1_mul(g1p(pk.delta1), r_blind)))
    a_aff = g1_to_affine(a_pt)

    # B in G2
    b_pt = g2_add(b2_acc, g2_add(pk.beta2, g2_mul(pk.delta2, s_blind)))

    # B in G1 (for C)
    b1_pt = g1_add(g1p(b1_acc) if b1_acc else bn254.INF,
                   g1_add(g1p(pk.beta1), g1_mul(g1p(pk.delta1), s_blind)))

    c_pt = bn254.INF
    if c_acc:
        c_pt = g1_add(c_pt, g1p(c_acc))
    if h_acc:
        c_pt = g1_add(c_pt, g1p(h_acc))
    c_pt = g1_add(c_pt, g1_mul(a_pt, s_blind))
    c_pt = g1_add(c_pt, g1_mul(b1_pt, r_blind))
    c_pt = g1_add(c_pt, g1_mul(g1p(pk.delta1), (-r_blind * s_blind) % R))
    return Proof(a=a_aff, b=b_pt, c=g1_to_affine(c_pt))


def verify(vk: VerifyingKey, proof: Proof, public_inputs: List[int]) -> bool:
    """e(A,B) == e(alpha,beta) * e(IC(pub), gamma) * e(C, delta)."""
    assert len(public_inputs) == len(vk.ic) - 1
    acc = g1_from_affine(vk.ic[0])
    for ptv, v in zip(vk.ic[1:], public_inputs):
        acc = g1_add(acc, g1_mul(g1_from_affine(ptv), v % R))
    ic_aff = g1_to_affine(acc)

    neg_a = g1_to_affine(bn254.g1_neg(g1_from_affine(proof.a)))
    f = miller_loop(twist(proof.b), cast_g1(neg_a))
    f = fq12_mul(f, miller_loop(twist(vk.beta2), cast_g1(vk.alpha1)))
    f = fq12_mul(f, miller_loop(twist(vk.gamma2), cast_g1(ic_aff)))
    f = fq12_mul(f, miller_loop(twist(vk.delta2), cast_g1(proof.c)))
    return fq12_pow(f, FINAL_EXP) == FQ12_ONE


def keys_from_host(pk, vk, device=None):
    """Key objects with Python-int queries (the JAX package's, or a
    ``HostProvingKey``; None for infinity) -> the port's (ProvingKey,
    VerifyingKey), the queries on `device` (None: the card)."""
    dev = devices.resolve(device)

    def t(words):
        return torch.from_numpy(words).to(dev)

    host = ProvingKey(
        **{k: getattr(pk, k) for k in _SINGLE},
        a_query=t(bn254_msm.g1_words(pk.a_query)),
        b1_query=t(bn254_msm.g1_words(pk.b1_query)),
        b2_query=t(bn254_msm.g2_words(pk.b2_query)),
        c_query=t(bn254_msm.g1_words(pk.c_query)),
        h_query=t(bn254_msm.g1_words(pk.h_query)))
    return host, VerifyingKey(alpha1=vk.alpha1, beta2=vk.beta2,
                              gamma2=vk.gamma2, delta2=vk.delta2,
                              ic=list(vk.ic))


def keys_to_host(pk: ProvingKey, vk: VerifyingKey):
    """The port's keys -> (HostProvingKey, VerifyingKey): every query as
    a list of affine points of Python ints (None for infinity), the JAX
    package's layout."""
    return HostProvingKey(
        **{k: getattr(pk, k) for k in _SINGLE},
        a_query=bn254_msm.g1_points(pk.a_query),
        b1_query=bn254_msm.g1_points(pk.b1_query),
        b2_query=bn254_msm.g2_points(pk.b2_query),
        c_query=bn254_msm.g1_points(pk.c_query),
        h_query=bn254_msm.g1_points(pk.h_query)), vk
