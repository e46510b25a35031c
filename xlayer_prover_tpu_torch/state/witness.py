"""Erigon block-witness decoder (stateless proving input).

The port's own copy of ``xlayer_prover_tpu/state/witness.py``; node and
bytecode hashes use the port's host Poseidon.

Equivalent of the reference witness2db (src/prover/witness.cpp:502-547 with
calculateWitnessHash :42-500 and the CBOR reader src/prover/cbor.cpp): a
byte stream of tree opcodes — 0x02 BRANCH(mask) recursing left/right, 0x03
HASH (opaque 32-byte subtree hash), 0x04 CODE (contract bytecode,
linear-hashed into the program store), 0x07 SMT_LEAF (nodeType, address,
optional storageKey, value) — is replayed bottom-up into Poseidon node
hashes, filling a node map + program map so a prover needs no database; the
final hash is the state root.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..models.zkevm.padding_pg_sm import linear_hash_bytes
from ..ops.poseidon_gl import host_permute
from ..utils.zkresult import ZkError, ZkResult
from .keys import key_for
from .smt import remove_key_bits, value_to_fea8

Key = Tuple[int, int, int, int]


class CborReader:
    """Minimal CBOR subset used by witnesses: unsigned ints + byte strings."""

    def __init__(self, data: bytes, p: int = 0):
        self.data = data
        self.p = p

    def _byte(self) -> int:
        if self.p >= len(self.data):
            raise ZkError(ZkResult.INVALID_INPUT, "cbor: out of data")
        b = self.data[self.p]
        self.p += 1
        return b

    def _count(self, first: int) -> int:
        short = first & 0x1F
        if short <= 23:
            return short
        n_bytes = {24: 1, 25: 2, 26: 4, 27: 8}.get(short)
        if n_bytes is None:
            raise ZkError(ZkResult.INVALID_INPUT, f"cbor: bad count {short}")
        v = 0
        for _ in range(n_bytes):
            v = (v << 8) | self._byte()
        return v

    def read_u64(self) -> int:
        first = self._byte()
        if first < 24:
            return first
        major = first >> 5
        if major != 0:
            raise ZkError(ZkResult.INVALID_INPUT,
                          f"cbor: expected uint, major={major}")
        return self._count(first)

    def read_bytes(self) -> bytes:
        first = self._byte()
        major = first >> 5
        if major != 2:
            raise ZkError(ZkResult.INVALID_INPUT,
                          f"cbor: expected bytes, major={major}")
        n = self._count(first)
        if self.p + n > len(self.data):
            raise ZkError(ZkResult.INVALID_INPUT, "cbor: bytes overrun")
        out = self.data[self.p:self.p + n]
        self.p += n
        return out

    def read_scalar(self) -> int:
        """uint OR big-endian byte-string number (the witness encodes large
        values as byte strings)."""
        first = self.data[self.p]
        if (first >> 5) == 2:
            return int.from_bytes(self.read_bytes(), "big")
        return self.read_u64()


class WitnessResult:
    def __init__(self):
        self.db: Dict[Key, list] = {}
        self.programs: Dict[Key, bytes] = {}
        self.state_root: int = 0
        self.root4: Key = (0, 0, 0, 0)


def _hash_store(db, data8, capacity4):
    h = tuple(host_permute(list(data8) + list(capacity4))[:4])
    db[h] = list(data8) + list(capacity4)
    return h


def _linear_hash_bytes(data: bytes):
    """Poseidon linear hash of a byte stream: pad with 0b1000...0001 to
    56*N bytes, pack 7 bytes/element little-endian, absorb in 8-element
    chunks with the previous digest as capacity (the reference's
    poseidonLinearHash, utils.cpp:677-712; used for hashP digests and
    contract bytecode hashes)."""
    return tuple(linear_hash_bytes(bytes(data)))


def witness2db(witness: bytes) -> WitnessResult:
    if not witness:
        raise ZkError(ZkResult.INVALID_INPUT, "empty witness")
    if witness[0] != 1:
        raise ZkError(ZkResult.INVALID_INPUT,
                      f"witness header version {witness[0]} != 1")
    res = WitnessResult()
    rd = CborReader(witness, 1)
    root = _parse_node(rd, res, level=0)
    res.root4 = root
    # fea2scalar over the 4x64 quad
    res.state_root = (root[0] | (root[1] << 64) | (root[2] << 128)
                      | (root[3] << 192))
    if rd.p != len(witness):
        raise ZkError(ZkResult.INVALID_INPUT,
                      f"witness: {len(witness) - rd.p} trailing bytes")
    return res


def _parse_node(rd: CborReader, res: WitnessResult, level: int) -> Key:
    if level > 255:
        raise ZkError(ZkResult.INVALID_INPUT, "witness: level > 255")
    n_opcodes = 0
    n_code = 0
    while True:
        opcode = rd._byte()
        if opcode == 0x02:  # BRANCH(mask)
            mask = rd.read_u64()
            if mask not in (1, 2, 3):
                raise ZkError(ZkResult.INVALID_INPUT,
                              f"witness: invalid branch mask {mask}")
            left = _parse_node(rd, res, level + 1) if mask & 1 else (0, 0, 0, 0)
            right = _parse_node(rd, res, level + 1) if mask & 2 else (0, 0, 0, 0)
            return _hash_store(res.db, list(left) + list(right), (0, 0, 0, 0))
        if opcode == 0x03:  # HASH (opaque 32-byte subtree)
            raw = rd.data[rd.p:rd.p + 32]
            if len(raw) != 32:
                raise ZkError(ZkResult.INVALID_INPUT, "witness: short hash")
            rd.p += 32
            scalar = int.from_bytes(raw, "big")
            return tuple((scalar >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                         for i in range(4))
        if opcode == 0x04:  # CODE
            if n_code >= 1:
                raise ZkError(ZkResult.INVALID_INPUT,
                              "witness: consecutive CODE opcodes")
            code = rd.read_bytes()
            if not code:
                raise ZkError(ZkResult.INVALID_INPUT, "witness: empty code")
            h = _linear_hash_bytes(code)
            res.programs[h] = code
            n_code += 1
            n_opcodes += 1
            continue  # the SMT_LEAF for this account follows
        if opcode == 0x07:  # SMT_LEAF
            node_type = rd._byte()
            address = rd.read_scalar()
            storage_key = rd.read_scalar() if node_type == 0x03 else 0
            value = rd.read_scalar()
            if node_type > 4:
                raise ZkError(ZkResult.INVALID_INPUT,
                              f"witness: nodeType {node_type}")
            key = key_for(address, node_type, storage_key)
            value_hash = _hash_store(res.db, value_to_fea8(value),
                                     (0, 0, 0, 0))
            rkey = remove_key_bits(key, level)
            return _hash_store(res.db, list(rkey) + list(value_hash),
                               (1, 0, 0, 0))
        raise ZkError(ZkResult.INVALID_INPUT,
                      f"witness: unsupported opcode {opcode:#x} at "
                      f"offset {rd.p - 1}")
