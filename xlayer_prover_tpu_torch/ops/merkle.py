"""Poseidon-Goldilocks binary Merkle tree over row-major sources.

Counterpart of ``xlayer_prover_tpu/ops/merkle.py``: leaves are
``linear_hash`` digests of (height x width) rows; internal levels pair-hash
with zero capacity.  A node is the linear hash of the width-8 row
left || right, so a level of n contiguous digests is ``linear_hash`` of
its free (n/2, 8) view: on the GPU one ``poseidon_linear_hash`` launch
for the leaves and one a level.  The query openings gather their rows and
sibling digests on the device and pull them to the host once per tree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields import gl
from . import poseidon_gl as poseidon


class MerkleTree(NamedTuple):
    """levels[0] = leaf digests (n, 4) ... levels[-1] = root (1, 4)."""
    levels: tuple
    width: int

    @property
    def root(self):
        return self.levels[-1][0]

    def root_np(self) -> np.ndarray:
        return gl.to_u64_np(self.root)


def merkelize(rows, width: int) -> MerkleTree:
    """rows: (height, width) int64 tensor, height a power of two."""
    n = rows.shape[0]
    if n & (n - 1):
        raise ValueError("merkelize: height must be a power of two")
    cur = poseidon.linear_hash(rows, width)
    levels = [cur]
    while cur.shape[0] > 1:
        pairs = cur.view(cur.shape[0] // 2, 2 * poseidon.HASH_SIZE)
        cur = poseidon.linear_hash(pairs, 2 * poseidon.HASH_SIZE)
        levels.append(cur)
    return MerkleTree(levels=tuple(levels), width=width)


def get_proof(tree: MerkleTree, idx: int):
    """Sibling path for leaf `idx`: list of 4-element digests (bottom-up)."""
    path = []
    for level in tree.levels[:-1]:
        path.append(gl.to_u64_np(level[idx ^ 1]))
        idx >>= 1
    return path


def get_proofs_batch(tree: MerkleTree, indices) -> np.ndarray:
    """Sibling paths of many leaves, one device gather per level and one
    host pull in all: (len(indices), n_levels, 4) uint64."""
    idx = np.asarray(list(indices), dtype=np.int64)
    if len(tree.levels) < 2:
        return np.zeros((len(idx), 0, 4), dtype=np.uint64)
    dev = tree.levels[0].device
    cur = torch.from_numpy(idx).to(dev)
    parts = []
    for level in tree.levels[:-1]:
        parts.append(level.index_select(0, cur ^ 1))
        cur = cur >> 1
    return gl.to_u64_np(torch.stack(parts, dim=1))


def gather_rows(source, indices) -> np.ndarray:
    """Query rows of a source: (len(indices), width) uint64, one pull."""
    idx = torch.as_tensor(np.asarray(list(indices), dtype=np.int64),
                          device=source.device)
    return gl.to_u64_np(source.index_select(0, idx))


def verify_proof(root_np, idx: int, leaf_row_np, path) -> bool:
    """Host-exact check: recompute the leaf digest, then walk the path."""
    digest = poseidon.host_linear_hash([int(v) for v in leaf_row_np])
    for sib in path:
        sib = [int(v) for v in sib]
        if idx & 1:
            state = sib + digest + [0, 0, 0, 0]
        else:
            state = digest + sib + [0, 0, 0, 0]
        digest = poseidon.host_permute(state)[:4]
        idx >>= 1
    return digest == [int(v) for v in root_np]
