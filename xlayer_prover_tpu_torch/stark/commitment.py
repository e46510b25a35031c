"""Commitment schemes: Poseidon-Goldilocks binary trees vs Poseidon-BN254
arity-16 trees, each with its transcript.

Counterpart of ``xlayer_prover_tpu/stark/commitment.py``.  The prover,
FRI and the verifier route every commitment through a scheme; an AIR
carries ``scheme`` ("gl", the default, or "bn128").  The reference's
recursiveF stage re-instantiates the whole STARK with MerkleTreeBN128 and
TranscriptBN128 (starkRecursiveF.cpp:151-242) so that its proof is cheap
to verify inside a BN254 circuit (``snark/final_circuit.py``).

BN128 packing follows merkleTreeBN128.cpp:90-154: three Goldilocks words
per Fr element (g0 + g1 2^64 + g2 2^128), leaves chained through t <= 17
Poseidon-BN254 permutations with the running digest first, arity-16
internal nodes over [0] + 16 children (zero-padded); a row of width <= 4
packs into one Fr.  The trees are built and opened on the tensors'
device (``ops/poseidon_bn254``: one leaf-hash launch for the leaves and one
permutation launch a level on the GPU); ``verify`` and the transcript run
on the host with ``host_permute``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..fields import gl
from ..ops import merkle, ntt
from ..ops.bn254_mont import from_words
from ..ops import poseidon_bn254 as pbn
from ..ops.poseidon_gl import host_linear_hash, host_permute
from .transcript import Transcript

FR_P = pbn.P
ARITY = pbn.ARITY


class GLScheme:
    name = "gl"

    def transcript(self):
        return Transcript()

    def merkelize(self, rows, width: int):
        return merkle.merkelize(rows, width)

    def extend_and_commit(self, section, nbits_ext: int, block_cols: int,
                          device):
        """A section's LDE kept in host memory, and its tree on `device`:
        column blocks of `block_cols` (a multiple of RATE) extended on
        the device (``ntt.extend_pol_blocks``), each absorbed into the
        leaf digests while it is there.  -> (host tensor, tree)"""
        leaves = merkle.LeafDigests(section.shape[1])
        ext = ntt.extend_pol_blocks(section, nbits_ext, block_cols, device,
                                    on_block=lambda c0, blk:
                                    leaves.absorb(blk))
        return ext, leaves.tree(1 << nbits_ext, device)

    def root(self, tree) -> List[int]:
        return [int(v) for v in tree.root_np()]

    def open_many(self, tree, source, idxs):
        """All openings of one tree: one row gather (on the device, or in
        host memory for a host-resident source) and one sibling-path
        gather on the device, one host pull each."""
        rows = merkle.gather_rows(source, idxs)
        paths = merkle.get_proofs_batch(tree, idxs)
        return [([int(v) for v in rows[k]],
                 [[int(x) for x in lvl] for lvl in paths[k]])
                for k in range(len(idxs))]

    def verify(self, root, idx: int, leaf_values, siblings) -> bool:
        digest = host_linear_hash([v % gl.P for v in leaf_values])
        for sib in siblings:
            if idx & 1:
                state = list(sib) + digest + [0, 0, 0, 0]
            else:
                state = digest + list(sib) + [0, 0, 0, 0]
            digest = host_permute(state)[:4]
            idx >>= 1
        return digest == [v % gl.P for v in root]


# ---------------------------------------------------------------------------
# BN128 scheme (Poseidon-BN254 arity-16 trees)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BN128Tree:
    """levels[0] = the leaf digests (height, 4) ... levels[-1] = the root
    (1, 4): int64 tensors of 64-bit limbs on the rows' device."""
    levels: List[torch.Tensor]
    width: int

    def root(self) -> int:
        return from_words(self.levels[-1])[0]


def build_tree_bn128(rows, width: int) -> BN128Tree:
    """The arity-16 tree of (height, width) Goldilocks rows: leaf digests,
    then levels of [0] + 16 children (the last group zero-padded)."""
    cur = pbn.leaf_hash(rows, width)
    levels = [cur]
    while cur.shape[0] > 1:
        n_groups = -(-cur.shape[0] // ARITY)
        states = torch.zeros((n_groups * (ARITY + 1), 4), dtype=torch.int64,
                             device=cur.device)
        # child k of group g sits at row g (ARITY + 1) + 1 + k
        pos = torch.arange(cur.shape[0], device=cur.device)
        states[pos + pos // ARITY + 1] = cur
        cur = pbn.permute(states.view(n_groups, ARITY + 1, 4),
                          ARITY + 1)[:, 0].contiguous()
        levels.append(cur)
    return BN128Tree(levels=levels, width=width)


class BN128Scheme:
    name = "bn128"

    def transcript(self):
        return TranscriptBN128()

    def merkelize(self, rows, width: int) -> BN128Tree:
        return build_tree_bn128(rows, width)

    def root(self, tree: BN128Tree) -> List[int]:
        return [tree.root()]

    def open_many(self, tree: BN128Tree, source, idxs):
        """All openings of one tree: the query rows and, per level below
        the root, each query's group of 16 siblings (zero-padded past the
        level's end), gathered on the device and pulled to the host once.
        -> [(row values, [[16 Fr] per level])]"""
        dev = source.device
        q = len(idxs)
        idx = torch.as_tensor(np.asarray(list(idxs), dtype=np.int64),
                              device=dev)
        parts = [source.index_select(0, idx).reshape(-1)]
        cur = idx
        lanes = torch.arange(ARITY, device=dev)
        for level in tree.levels[:-1]:
            pos = ((cur // ARITY) * ARITY).unsqueeze(1) + lanes   # (q, 16)
            inside = pos < level.shape[0]
            group = level.index_select(
                0, torch.where(inside, pos, 0).reshape(-1)).reshape(q, ARITY,
                                                                    4)
            parts.append((group * inside.unsqueeze(2)).reshape(-1))
            cur = cur // ARITY
        flat = gl.to_u64_np(torch.cat(parts))
        width = source.shape[1]
        rows = flat[:q * width].reshape(q, width)
        sibs = from_words(flat[q * width:])
        n_levels = len(tree.levels) - 1
        out = []
        for k in range(q):
            path = [sibs[(lv * q + k) * ARITY:(lv * q + k + 1) * ARITY]
                    for lv in range(n_levels)]
            out.append(([int(v) for v in rows[k]], path))
        return out

    def verify(self, root, idx: int, leaf_values, siblings) -> bool:
        digest = pbn.leaf_hash_host([v % gl.P for v in leaf_values])
        cur = idx
        for group in siblings:
            if group[cur % ARITY] != digest:
                return False
            digest = pbn.host_permute([0] + list(group))[0]
            cur //= ARITY
        return digest == root[0] % FR_P


# ---------------------------------------------------------------------------
# TranscriptBN128 (transcriptBN128.cpp semantics, host-exact)
# ---------------------------------------------------------------------------

class TranscriptBN128:
    """A t = 17 sponge over Fr: 16 pending inputs and a one-Fr state; a
    draw takes the permutation's outputs front to back.  ``get_fields1``
    splits an output into three 64-bit Goldilocks draws; ``out`` starts as
    [0] (the reference's quirk: the first draw before any input is 0)."""

    def __init__(self):
        self.state = [0]
        self.pending: List[int] = []
        self.out: List[int] = [0]
        self.out3: List[int] = []

    def put(self, values):
        for v in values:
            self.pending.append(int(v) % FR_P)
            self.out = []
            self.out3 = []
            if len(self.pending) == ARITY:
                self._update()

    def _update(self):
        while len(self.pending) < ARITY:
            self.pending.append(0)
        out = pbn.host_permute(self.state + self.pending)
        self.out = list(out)
        self.state = [out[0]]
        self.out3 = []
        self.pending = []

    def get_fields253(self) -> int:
        if not self.out:
            self._update()
        return self.out.pop(0)

    def get_fields1(self) -> int:
        if not self.out3:
            if not self.out:
                self._update()
            v = self.out.pop(0)
            self.out3 = [(v >> (64 * k)) & pbn.MASK64 for k in range(3)]
        return self.out3.pop(0)

    def get_field(self):
        return [self.get_fields1() for _ in range(3)]

    def get_permutations(self, n: int, n_bits: int):
        """n indices of n_bits bits each, from 253 bits a field."""
        n_fields = (n * n_bits - 1) // 253 + 1
        fields = [self.get_fields253() for _ in range(n_fields)]
        res = []
        cur_field = 0
        cur_bit = 0
        for _ in range(n):
            a = 0
            for j in range(n_bits):
                if (fields[cur_field] >> cur_bit) & 1:
                    a += 1 << j
                cur_bit += 1
                if cur_bit == 253:
                    cur_bit = 0
                    cur_field += 1
            res.append(a)
        return res


SCHEMES = {"gl": GLScheme, "bn128": BN128Scheme}


def get_scheme(air):
    scheme = getattr(air, "scheme", "gl")
    if scheme not in SCHEMES:
        raise ValueError(f"unknown commitment scheme {scheme!r}")
    return SCHEMES[scheme]()
