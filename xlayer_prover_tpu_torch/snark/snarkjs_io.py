"""snarkjs-format JSON artifacts + an independent from-file verifier.

The port's copy of ``xlayer_prover_tpu/snark/snarkjs_io.py``.  The
reference CI verifies the final SNARK with `snarkjs groth16 verify
verification_key.json public.json proof.json`
(.github/workflows/prover_e2e.yml:36-38).  snarkjs/node are not in this
image, so this module provides the other half of that contract:

  * export_vk / export_proof / export_publics write byte-compatible
    snarkjs JSON (decimal strings; G1 as projective [x, y, "1"], G2 as
    [[c0, c1], ...] Fq2 pairs; protocol/curve/nPublic headers);
  * verify_files() re-implements `snarkjs groth16 verify`: it parses
    ONLY the JSON files (no shared in-memory objects) and checks
    e(-A, B) * e(alpha, beta) * e(IC(pub), gamma) * e(C, delta) == 1,
    exactly the pairing product snarkjs evaluates.

A proof exported here verifies under snarkjs unchanged, and vice versa —
the formats are the documented snarkjs 0.7 layouts.
"""

from __future__ import annotations

import json
from typing import List

from ..fields import bn254
from ..fields.bn254 import (g1_add, g1_from_affine, g1_mul, g1_to_affine)
from .groth16 import (FINAL_EXP, FQ12_ONE, Proof, R, VerifyingKey, cast_g1,
                      fq12_mul, fq12_pow, miller_loop, twist)


def _g1_json(pt) -> list:
    return [str(int(pt[0])), str(int(pt[1])), "1"]


def _g2_json(pt) -> list:
    (x0, x1), (y0, y1) = pt
    return [[str(int(x0)), str(int(x1))],
            [str(int(y0)), str(int(y1))],
            ["1", "0"]]


def _g1_parse(j) -> tuple:
    x, y, z = (int(v) for v in j)
    assert z == 1, "expected affine projective z=1"
    return (x, y)


def _g2_parse(j) -> tuple:
    (x0, x1), (y0, y1), (z0, z1) = ((int(a), int(b)) for (a, b) in j)
    assert (z0, z1) == (1, 0), "expected affine projective z=(1,0)"
    return ((x0, x1), (y0, y1))


def export_vk(vk: VerifyingKey, path: str):
    """verification_key.json (snarkjs zkey export verificationkey)."""
    doc = {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": len(vk.ic) - 1,
        "vk_alpha_1": _g1_json(vk.alpha1),
        "vk_beta_2": _g2_json(vk.beta2),
        "vk_gamma_2": _g2_json(vk.gamma2),
        "vk_delta_2": _g2_json(vk.delta2),
        "IC": [_g1_json(pt) for pt in vk.ic],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def export_proof(proof: Proof, path: str):
    doc = {
        "pi_a": _g1_json(proof.a),
        "pi_b": _g2_json(proof.b),
        "pi_c": _g1_json(proof.c),
        "protocol": "groth16",
        "curve": "bn128",
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def export_publics(publics: List[int], path: str):
    with open(path, "w") as f:
        json.dump([str(int(p) % R) for p in publics], f, indent=1)


def verify_files(vk_path: str, public_path: str, proof_path: str) -> bool:
    """`snarkjs groth16 verify` from the JSON artifacts alone."""
    with open(vk_path) as f:
        vk = json.load(f)
    with open(public_path) as f:
        publics = [int(v) for v in json.load(f)]
    with open(proof_path) as f:
        pr = json.load(f)
    if vk.get("protocol") != "groth16" or pr.get("protocol") != "groth16":
        return False
    if vk.get("curve") != "bn128" or len(publics) != vk.get("nPublic"):
        return False

    ic = [_g1_parse(p) for p in vk["IC"]]
    alpha1 = _g1_parse(vk["vk_alpha_1"])
    beta2 = _g2_parse(vk["vk_beta_2"])
    gamma2 = _g2_parse(vk["vk_gamma_2"])
    delta2 = _g2_parse(vk["vk_delta_2"])
    a = _g1_parse(pr["pi_a"])
    b = _g2_parse(pr["pi_b"])
    c = _g1_parse(pr["pi_c"])

    acc = g1_from_affine(ic[0])
    for pt, v in zip(ic[1:], publics):
        acc = g1_add(acc, g1_mul(g1_from_affine(pt), v % R))
    ic_aff = g1_to_affine(acc)

    neg_a = g1_to_affine(bn254.g1_neg(g1_from_affine(a)))
    f = miller_loop(twist(b), cast_g1(neg_a))
    f = fq12_mul(f, miller_loop(twist(beta2), cast_g1(alpha1)))
    f = fq12_mul(f, miller_loop(twist(gamma2), cast_g1(ic_aff)))
    f = fq12_mul(f, miller_loop(twist(delta2), cast_g1(c)))
    return fq12_pow(f, FINAL_EXP) == FQ12_ONE
