"""BN254 (alt_bn128) scalar field Fr: the circuit field of the final
SNARK stage's R1CS.

Counterpart of the Fr part of ``xlayer_prover_tpu/fields/bn254.py`` (the
curve, the MSM and the pairing come with Groth16).  Fr's modulus r is the
Poseidon-BN254 modulus (``ops/poseidon_bn254.P``).
"""

from __future__ import annotations

# scalar field modulus (Fr)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def fr_inv(a: int) -> int:
    return pow(a, R - 2, R)
