"""SMT key derivation (reference: src/utils/key_utils.cpp + main SM usage).

The port's own copy of ``xlayer_prover_tpu/state/keys.py``; the Poseidon
permutation is the port's host one (``ops/poseidon_gl.host_permute``).
The zkEVM state tree keys leaves by
key = Poseidon(address8 || [0,0,type,0] -> limb6, capacity = Poseidon(storageKey8))
with leaf types: 0=balance, 1=nonce, 2=code, 3=storage slot, 4=code length
(witness.cpp:225-303 spells out the exact construction).
"""

from __future__ import annotations

from ..ops.poseidon_gl import host_permute

LEAF_BALANCE = 0
LEAF_NONCE = 1
LEAF_CODE = 2
LEAF_STORAGE = 3
LEAF_CODE_LENGTH = 4


def _scalar_to_fea8(v: int):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def key_for(address: int, leaf_type: int, storage_key: int = 0):
    """Returns the 4-element SMT key."""
    kin0 = _scalar_to_fea8(storage_key) + [0, 0, 0, 0]
    kin0_hash = host_permute(kin0)[:4]
    kin1 = _scalar_to_fea8(address)
    assert kin1[5] == 0 and kin1[6] == 0 and kin1[7] == 0, \
        "address must fit 160 bits"
    kin1[6] = leaf_type
    kin1 = kin1 + list(kin0_hash)
    return tuple(host_permute(kin1)[:4])


def balance_key(address: int):
    return key_for(address, LEAF_BALANCE)


def nonce_key(address: int):
    return key_for(address, LEAF_NONCE)


def code_key(address: int):
    return key_for(address, LEAF_CODE)


def storage_key(address: int, slot: int):
    return key_for(address, LEAF_STORAGE, slot)
