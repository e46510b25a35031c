"""Sparse Merkle tree over Goldilocks quads (reference: src/hashdb/smt.cpp).

The port's own copy of ``xlayer_prover_tpu/state/smt.py``; node hashes use
the port's host Poseidon (``ops/poseidon_gl.host_permute``).

Semantics mirror the reference exactly:
  * keys are 4 Goldilocks elements; the 256 path bits interleave the limbs
    (bit i of the path = bit (i>>2) of limb (i&3)), per
    src/utils/key_utils.cpp splitKey.
  * a leaf stores (rkey, valueHash) hashed with capacity 1; valueHash =
    H0(value split into 8 x 32-bit limbs); branch nodes hash
    (left||right) with capacity 0 (smt.hpp:42-80).
  * the node store maps hash -> the 12 hashed elements, so node type is
    recoverable from the capacity part.
  * set() follows the reference's imperative structure (smt.cpp:44-810):
    walk down recording ``siblings[level]``, mutate the recorded path nodes
    in place per mode, erase entries beyond the final level, then rehash
    upward — so ``SmtSetResult.siblings`` is byte-identical to the
    reference's (the Storage SM micro-ROM replay consumes it directly).
  * modes: update, insertFound/insertNotFound, deleteFound/deleteNotFound,
    zeroToZero.  Deleting the root leaf yields "deleteNotFound" with a zero
    new root, exactly like the reference (smt.cpp:719-729) — the ROM's
    "deleteLast" branch is legacy and never taken.
  * proof_hash_counter matches the reference bookkeeping (consumed by the
    Main SM's cntPoseidonG: incCounter = proofHashCounter + 2).

Host-side by design: state access is pointer-chasing + DB I/O (SURVEY §5);
the heavy Poseidon work for *proving* storage ops happens in the Storage SM
trace on device, not here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

from ..fields import gl
from ..ops.poseidon_gl import host_permute as _permute

P = gl.P
ZERO4 = (0, 0, 0, 0)


@functools.lru_cache(maxsize=8192)
def _split_key_cached(k0: int, k1: int, k2: int, k3: int):
    bits = []
    for i in range(64):
        bits.append((k0 >> i) & 1)
        bits.append((k1 >> i) & 1)
        bits.append((k2 >> i) & 1)
        bits.append((k3 >> i) & 1)
    return tuple(bits)


def split_key(key) -> List[int]:
    """256 path bits in SMT order (interleaved limbs).  Storage slots
    repeat heavily within a batch, so the decomposition is memoized."""
    return list(_split_key_cached(int(key[0]), int(key[1]),
                                  int(key[2]), int(key[3])))


def join_key(used_bits: List[int], rkey) -> Tuple[int, int, int, int]:
    """Prepend used_bits (in SMT order) back onto a remaining key."""
    n = [0, 0, 0, 0]
    accs = [0, 0, 0, 0]
    for i, b in enumerate(used_bits):
        if b:
            accs[i % 4] |= 1 << (i // 4)
        n[i % 4] += 1
    out = []
    for j in range(4):
        out.append(((int(rkey[j]) << n[j]) | accs[j]) & ((1 << 64) - 1))
        assert out[j] < P
    return tuple(out)


def remove_key_bits(key, n_bits: int) -> Tuple[int, int, int, int]:
    """Drop the first n_bits (SMT order) from the key."""
    full = n_bits // 4
    out = []
    for j in range(4):
        n = full + (1 if j < n_bits % 4 else 0)
        out.append(int(key[j]) >> n)
    return tuple(out)


def value_to_fea8(value: int) -> List[int]:
    """256-bit scalar -> 8 x 32-bit field elements (scalar2fea)."""
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def fea8_to_value(fea) -> int:
    v = 0
    for i in range(8):
        v |= int(fea[i]) << (32 * i)
    return v


def hash_node(data8, capacity4) -> Tuple[int, int, int, int]:
    return tuple(_permute(list(data8) + list(capacity4))[:4])


def _unique_sibling(node12) -> int:
    """Index of the only non-zero child quad, or -1 (smt.cpp:1132-1149)."""
    n_found = 0
    fnd = -1
    for i in range(0, len(node12), 4):
        if any(int(v) != 0 for v in node12[i:i + 4]):
            n_found += 1
            fnd = i // 4
    return fnd if n_found == 1 else -1


@dataclasses.dataclass
class SmtSetResult:
    old_root: tuple
    new_root: tuple
    key: tuple
    siblings: dict          # level -> the 12 node elements, post-mutation
    ins_key: Optional[tuple]
    ins_value: int
    is_old0: bool
    old_value: int
    new_value: int
    mode: str
    proof_hash_counter: int = 0
    # children of the sibling branch examined in deleteNotFound (reference
    # smt.cpp:695-715 siblingLeftChild/siblingRightChild); consumed by the
    # Storage SM replay (GetSiblingLeftChildHash/GetSiblingRightChildHash)
    sibling_left_child: tuple = ZERO4
    sibling_right_child: tuple = ZERO4


@dataclasses.dataclass
class SmtGetResult:
    root: tuple
    key: tuple
    value: int
    found: bool
    siblings: dict
    ins_key: Optional[tuple]
    ins_value: int
    is_old0: bool
    proof_hash_counter: int = 0


class Smt:
    """Reference-semantics SMT over a database.py-style node store."""

    def __init__(self, db):
        self.db = db

    # -- internals -------------------------------------------------------
    def _read(self, hash4):
        node = self.db.read(tuple(hash4))
        if node is None:
            raise KeyError(f"SMT node not found: {hash4}")
        return node

    def _is_leaf(self, node12) -> bool:
        return node12[8] == 1

    def _save(self, data8, capacity4):
        h = hash_node(data8, capacity4)
        self.db.write(h, list(data8) + list(capacity4))
        return h

    def _save_leaf(self, rkey, value: int):
        value_hash = self._save(value_to_fea8(value), ZERO4)
        return self._save(list(rkey) + list(value_hash), (1, 0, 0, 0))

    def _save_leaf_vh(self, rkey, value_hash):
        return self._save(list(rkey) + list(value_hash), (1, 0, 0, 0))

    def _save_branch(self, left4, right4):
        return self._save(list(left4) + list(right4), ZERO4)

    # -- public API ------------------------------------------------------
    def get(self, root, key) -> SmtGetResult:
        root = tuple(int(v) for v in root)
        key = tuple(int(v) for v in key)
        bits = split_key(key)
        siblings = {}
        r = root
        level = 0
        # walk down while intermediate; the leaf node itself is NOT kept in
        # siblings (the reference erases it, smt.cpp:1029-1032)
        while r != ZERO4:
            node = self._read(r)
            if self._is_leaf(node):
                leaf_rkey = tuple(node[0:4])
                value_hash = tuple(node[4:8])
                value = fea8_to_value(self._read(value_hash)[0:8])
                rem_key = remove_key_bits(key, level)
                # reference smt.cpp:1052-1056: siblings + 2 whenever a
                # leaf was reached (isOld0 == false), found or not — the
                # +2 is the leaf's value hash + node hash in the replay
                phc = len(siblings) + 2
                if leaf_rkey == rem_key:
                    return SmtGetResult(root=root, key=key, value=value,
                                        found=True, siblings=siblings,
                                        ins_key=None, ins_value=0,
                                        is_old0=False,
                                        proof_hash_counter=phc)
                ins_key = join_key(bits[:level], leaf_rkey)
                return SmtGetResult(root=root, key=key, value=0, found=False,
                                    siblings=siblings, ins_key=ins_key,
                                    ins_value=value, is_old0=False,
                                    proof_hash_counter=phc)
            siblings[level] = node
            r = tuple(node[4:8]) if bits[level] else tuple(node[0:4])
            level += 1
        return SmtGetResult(root=root, key=key, value=0, found=False,
                            siblings=siblings, ins_key=None, ins_value=0,
                            is_old0=True,
                            proof_hash_counter=len(siblings) if root != ZERO4
                            else 0)

    def read_tree(self, root, keys):
        """Bulk state-sync read (reference HashDB::readTree,
        hashdb_interface.hpp:37 / hashdb64_tools): walk every key from
        `root`, returning ([(key, value)], {node_hash: node12}) — the
        values plus every tree node touched, so a stateless client can
        rebuild the relevant sub-trie."""
        root = tuple(int(v) for v in root)
        key_values = []
        hash_nodes = {}
        for key in keys:
            key = tuple(int(v) for v in key)
            bits = split_key(key)
            r = root
            level = 0
            value = 0
            while r != ZERO4:
                node = self._read(r)
                hash_nodes[r] = list(node)
                if self._is_leaf(node):
                    leaf_rkey = tuple(node[0:4])
                    value_hash = tuple(node[4:8])
                    vnode = self._read(value_hash)
                    hash_nodes[value_hash] = list(vnode)
                    if leaf_rkey == remove_key_bits(key, level):
                        value = fea8_to_value(vnode[0:8])
                    break
                r = tuple(node[4:8]) if bits[level] else tuple(node[0:4])
                level += 1
            key_values.append((key, value))
        return key_values, hash_nodes

    def set(self, old_root, key, value: int) -> SmtSetResult:
        old_root = tuple(int(v) for v in old_root)
        key = tuple(int(v) for v in key)
        value = int(value)
        keys = split_key(key)

        # -- walk down recording siblings[level] (incl. the leaf) ---------
        siblings: dict = {}
        acc_key: List[int] = []
        r = old_root
        level = 0
        found = False
        found_rkey = ZERO4
        found_value_hash = ZERO4
        found_value = 0
        found_key = None
        while r != ZERO4 and not found:
            node = self._read(r)
            siblings[level] = list(node)
            if self._is_leaf(node):
                found = True
                found_rkey = tuple(node[0:4])
                found_value_hash = tuple(node[4:8])
                found_value = fea8_to_value(self._read(found_value_hash)[0:8])
                found_key = join_key(acc_key, found_rkey)
            else:
                side = keys[level]
                r = tuple(node[side * 4: side * 4 + 4])
                acc_key.append(side)
                level += 1
        # one step back (smt.cpp:172-174)
        level -= 1
        if acc_key:
            acc_key.pop()

        mode = ""
        old_value = 0
        ins_key = None
        ins_value = 0
        is_old0 = True
        new_root = old_root
        sib_left = ZERO4
        sib_right = ZERO4
        phc = 0
        if old_root != ZERO4:
            phc = min(len(siblings), level + 1)
            if found_value != 0:
                phc += 2

        def put_child(lvl, side, quad):
            for j in range(4):
                siblings[lvl][side * 4 + j] = int(quad[j])

        if value != 0:
            if found and found_key == key:
                mode = "update"
                old_value = found_value
                is_old0 = False
                new_leaf = self._save_leaf(found_rkey, value)
                phc += 2
                if level >= 0:
                    put_child(level, keys[level], new_leaf)
                else:
                    new_root = new_leaf
            elif found:
                mode = "insertFound"
                found_keys = split_key(found_key)
                level2 = level + 1
                while keys[level2] == found_keys[level2]:
                    level2 += 1
                old_leaf = self._save_leaf_vh(
                    remove_key_bits(found_key, level2 + 1), found_value_hash)
                ins_key = found_key
                ins_value = found_value
                is_old0 = False
                new_leaf = self._save_leaf(remove_key_bits(key, level2 + 1),
                                           value)
                node8 = [0] * 8
                for j in range(4):
                    node8[keys[level2] * 4 + j] = new_leaf[j]
                    node8[found_keys[level2] * 4 + j] = old_leaf[j]
                r2 = self._save_branch(node8[0:4], node8[4:8])
                phc += 4
                level2 -= 1
                # chain of single-child branches up to the common prefix
                while level2 != level:
                    node8 = [0] * 8
                    for j in range(4):
                        node8[keys[level2] * 4 + j] = r2[j]
                    r2 = self._save_branch(node8[0:4], node8[4:8])
                    phc += 1
                    level2 -= 1
                if level >= 0:
                    put_child(level, keys[level], r2)
                else:
                    new_root = r2
            else:
                mode = "insertNotFound"
                new_leaf = self._save_leaf(remove_key_bits(key, level + 1),
                                           value)
                phc += 2
                if level >= 0:
                    put_child(level, keys[level], new_leaf)
                else:
                    new_root = new_leaf
        else:
            if found and found_key == key:
                old_value = found_value
                is_old0 = False
                if level >= 0:
                    put_child(level, keys[level], ZERO4)
                    u_key = _unique_sibling(siblings[level])
                    if u_key >= 0:
                        sib_hash = tuple(
                            siblings[level][u_key * 4: u_key * 4 + 4])
                        sib_node = list(self._read(sib_hash))
                        siblings[level + 1] = sib_node
                        if self._is_leaf(sib_node):
                            mode = "deleteFound"
                            val_h = tuple(sib_node[4:8])
                            val = fea8_to_value(self._read(val_h)[0:8])
                            phc += 2
                            ins_key = join_key(acc_key + [u_key],
                                               tuple(sib_node[0:4]))
                            ins_value = val
                            # climb while the branch has a lone child
                            while u_key >= 0 and level >= 0:
                                level -= 1
                                if level >= 0:
                                    u_key = _unique_sibling(siblings[level])
                            old_leaf = self._save_leaf_vh(
                                remove_key_bits(ins_key, level + 1), val_h)
                            phc += 1
                            if level >= 0:
                                put_child(level, keys[level], old_leaf)
                            else:
                                new_root = old_leaf
                        else:
                            mode = "deleteNotFound"
                    else:
                        mode = "deleteNotFound"
                    if mode == "deleteNotFound":
                        sibling_side = 0 if keys[level] else 1
                        sib_hash = tuple(siblings[level][sibling_side * 4:
                                                         sibling_side * 4 + 4])
                        sn = self._read(sib_hash)
                        sib_left = tuple(sn[0:4])
                        sib_right = tuple(sn[4:8])
                        phc += 1
                else:
                    # deleting the root leaf empties the tree; the
                    # reference labels this deleteNotFound (smt.cpp:719-729)
                    mode = "deleteNotFound"
                    new_root = ZERO4
            else:
                mode = "zeroToZero"
                if found:
                    ins_key = found_key
                    ins_value = found_value
                    is_old0 = False

        # -- delete the extra siblings (smt.cpp:753-755) ------------------
        for lvl in [l for l in siblings if l > level]:
            del siblings[lvl]

        # -- go up the tree re-creating intermediate nodes ----------------
        while level >= 0:
            new_root = self._save(siblings[level][0:8], siblings[level][8:12])
            if mode != "zeroToZero":
                phc += 1
            level -= 1
            if level >= 0:
                put_child(level, keys[level], new_root)

        siblings = {lvl: tuple(node) for lvl, node in siblings.items()}
        return SmtSetResult(old_root=old_root, new_root=tuple(new_root),
                            key=key, siblings=siblings, ins_key=ins_key,
                            ins_value=ins_value, is_old0=is_old0,
                            old_value=old_value, new_value=value, mode=mode,
                            proof_hash_counter=phc,
                            sibling_left_child=sib_left,
                            sibling_right_child=sib_right)
