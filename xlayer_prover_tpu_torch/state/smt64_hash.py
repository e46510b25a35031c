"""The level hasher: every chunk of one ``Smt64.set_many``, hashed a tree
level at a time.

The JAX ``Smt64._build`` (``xlayer_prover_tpu/state/hashdb64.py:397-421``)
builds the chunk forest recursively and hashes each chunk through
``TreeChunk.calculate_hash`` / ``_calc_child`` (``:126-169``), one
Poseidon permutation at a time: about three a leaf (its value hash, its
leaf hash and one node).  The hashes of one tree level do not depend on
each other, so here they are gathered and computed a level at a time by
``ops/poseidon_gl.permute`` (the ``poseidon_permute`` kernel on the card,
its plain version ``_permute_plain`` on the CPU).  The roots, the chunk
bytes and the order in which the chunks are written are the JAX
package's; only the order in which independent hashes are computed
changes.

Two passes:

  * **A host pass over the types** (numpy, every chunk of a depth at
    once).  Top-down, the leaves are grouped into chunks by their 6 path
    bits a chunk (``key_bits6``): a slot of one leaf is a LEAF child, of
    several an INTERMEDIATE child whose chunk is one deeper.  Bottom-up,
    each chunk's six reductions (sibling ``i`` with ``i + half``) are
    walked over ZERO, LEAF and INTERMEDIATE as ``_calc_child`` does: a
    leaf that meets a ZERO bubbles up unhashed; where it meets a non-ZERO
    sibling it is hashed at ``level + 1`` of that pair; INTERMEDIATE with
    ZERO hashes against (0, 0, 0, 0).  This fixes which leaf is hashed at
    which level, and every node hash with its absolute level and its two
    operands (zero, a leaf hash or a deeper node).  A node takes its
    operands from exactly one level deeper, and the nodes are numbered as
    they are made, deepest level first, so each level is one slice.
  * **The device pass**: one launch for the value hashes (``v8 ++ 0^4``),
    one for the leaf hashes (``remove_key_bits(key, level) ++ vhash ++
    (1, 0, 0, 0)``), then one launch per absolute level, deepest first,
    over that level's nodes, gathering their operands by index from the
    table of hashes on the device.  One copy brings the table back: the
    chunks' INTERMEDIATE children and their keys need it.

Key limbs and hashes are uint64 on the host and their int64 bit patterns
on the device; a value is eight 32-bit limbs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import device as dev
from ..ops import poseidon_gl

CHUNK_LEVELS = 6
WIDTH = 64
ZERO, LEAF, INTERMEDIATE = 1, 2, 3      # child.hpp ChildType values
_UNIT = 16                  # the chunk codec's sizes, in 16-byte units:
_UNITS = {LEAF: 4, INTERMEDIATE: 2}    # a header 1, a leaf 4, a hash 2


def slots6(keys: np.ndarray, level: int) -> np.ndarray:
    """``key_bits6`` of every row of (n, 4) uint64 keys at chunk level
    `level`: bit i is path bit level + i, key[(level + i) % 4] bit
    (level + i) // 4."""
    out = np.zeros(len(keys), dtype=np.int64)
    for i in range(CHUNK_LEVELS):
        b = level + i
        if b // 4 < 64:
            bit = (keys[:, b % 4] >> np.uint64(b // 4)) & np.uint64(1)
            out |= bit.astype(np.int64) << i
    return out


def remove_key_bits_np(keys: np.ndarray, n_bits: np.ndarray) -> np.ndarray:
    """``remove_key_bits`` of every row: limb j loses n // 4 + (j < n % 4)
    of its low bits, n the row's own count."""
    out = np.empty_like(keys)
    for j in range(4):
        used = (n_bits // 4 + (j < n_bits % 4)).astype(np.uint64)
        out[:, j] = np.where(used < 64, keys[:, j] >> np.minimum(
            used, np.uint64(63)), np.uint64(0))
    return out


def _structure(keys: np.ndarray) -> list:
    """Top-down grouping: per depth d, the chunks' child types (C, 64), the
    children's references (a leaf's index, or an INTERMEDIATE's chunk at
    depth d + 1), each chunk's parent at depth d - 1 and its first leaf
    (the least index of its leaves: the JAX recursion meets its slots in
    that order)."""
    n = len(keys)
    idx = np.arange(n)
    cid = np.zeros(n, dtype=np.int64)
    depths = []
    parent = np.full(1, -1, dtype=np.int64)
    first = np.zeros(1, dtype=np.int64)
    while idx.size:
        n_chunks = len(parent)
        g = cid * WIDTH + slots6(keys[idx], CHUNK_LEVELS * len(depths))
        counts = np.bincount(g, minlength=n_chunks * WIDTH)
        types = np.full(n_chunks * WIDTH, ZERO, dtype=np.int8)
        types[counts == 1] = LEAF
        types[counts >= 2] = INTERMEDIATE
        ref = np.full(n_chunks * WIDTH, -1, dtype=np.int64)
        single = counts[g] == 1
        ref[g[single]] = idx[single]
        multi = ~single
        sub_g, first_pos, inv = np.unique(g[multi], return_index=True,
                                          return_inverse=True)
        ref[sub_g] = np.arange(len(sub_g))
        depths.append({"types": types.reshape(n_chunks, WIDTH),
                       "ref": ref.reshape(n_chunks, WIDTH),
                       "parent": parent, "first": first})
        idx = idx[multi]
        cid = inv.reshape(-1)
        parent = sub_g // WIDTH
        first = idx[first_pos]
    return depths


def _reduce(depths: list, n: int):
    """Bottom-up: walk each depth's chunks through their six reductions
    (``_calc_child``).  Node ids count from 0 in the order made, deepest
    absolute level first.  -> (leaf_level (n,), left (m,), right (m,),
    level_of_node (m,), top node id per depth (or the lone leaf at the
    root as ~leaf)); an operand is 0 for zero, 1 + leaf for a leaf hash,
    1 + n + node for a node."""
    leaf_level = np.full(n, -1, dtype=np.int64)
    lefts, rights, node_levels = [], [], []
    tops: List[np.ndarray] = [None] * len(depths)
    n_nodes = 0
    for d in range(len(depths) - 1, -1, -1):
        t = depths[d]["types"].copy()
        v = depths[d]["ref"].copy()
        inter = t == INTERMEDIATE
        if inter.any():
            v[inter] = tops[d + 1][v[inter]]
        size = WIDTH
        for rel in range(CHUNK_LEVELS - 1, -1, -1):
            level = CHUNK_LEVELS * d + rel
            half = size // 2
            lt, rt = t[:, :half], t[:, half:size]
            lv, rv = v[:, :half], v[:, half:size]
            node = ((lt == LEAF) & (rt == LEAF)) | (lt == INTERMEDIATE) \
                | (rt == INTERMEDIATE)
            operands = []
            for ty, val in ((lt[node], lv[node]), (rt[node], rv[node])):
                leaf = ty == LEAF
                leaf_level[val[leaf]] = level + 1
                operands.append(np.where(
                    ty == ZERO, 0, np.where(leaf, 1 + val, 1 + n + val)))
            m = int(node.sum())
            lefts.append(operands[0])
            rights.append(operands[1])
            node_levels.append(np.full(m, level, dtype=np.int64))
            new_t = np.where(lt == ZERO, rt, lt)
            new_v = np.where(lt == ZERO, rv, lv)
            new_t[node] = INTERMEDIATE
            new_v[node] = n_nodes + np.arange(m)
            n_nodes += m
            t, v, size = new_t, new_v, half
        top_t, top_v = t[:, 0], v[:, 0]
        if d == 0 and top_t[0] == LEAF:          # a lone leaf: the root
            leaf_level[top_v[0]] = 0             # hashes it at level 0
            tops[0] = ~top_v
        else:
            if (top_t != INTERMEDIATE).any():
                raise AssertionError("a chunk of two or more leaves has an "
                                     "INTERMEDIATE top")
            tops[d] = top_v
    if (leaf_level < 0).any():
        raise AssertionError("every leaf is hashed once")
    return (leaf_level, np.concatenate(lefts), np.concatenate(rights),
            np.concatenate(node_levels), tops)


def _hash_table(keys, v8, leaf_level, left, right, node_level,
                device) -> np.ndarray:
    """The device pass: the table of hashes, row 0 zero, rows 1..n the
    leaf hashes, then the nodes, deepest level first.  -> (1 + n + m, 4)
    uint64 on the host."""
    n, m = len(keys), len(left)
    zeros = torch.zeros((n, 4), dtype=torch.int64, device=device)
    vals = torch.from_numpy(v8.astype(np.int64)).to(device)
    vhash = poseidon_gl.permute(torch.cat([vals, zeros], dim=1))[:, :4]
    rkey = dev.from_u64_np(remove_key_bits_np(keys, leaf_level), device)
    cap = zeros.clone()
    cap[:, 0] = 1
    table = torch.zeros((1 + n + m, 4), dtype=torch.int64, device=device)
    table[1:1 + n] = poseidon_gl.permute(
        torch.cat([rkey, vhash, cap], dim=1))[:, :4]
    if m:
        lt = torch.from_numpy(left).to(device)
        rt = torch.from_numpy(right).to(device)
        starts = np.flatnonzero(np.diff(node_level, prepend=-1))
        for a, b in zip(starts, list(starts[1:]) + [m]):
            state = torch.cat([table[lt[a:b]], table[rt[a:b]],
                               zeros[:b - a]], dim=1)
            table[1 + n + a:1 + n + b] = poseidon_gl.permute(state)[:, :4]
    return dev.to_u64_np(table)


def _encode(depths, tops, keys, v8, table, n: int):
    """Every chunk's ``TreeChunk.encode`` bytes and hash row, depth by
    depth: u64 isZero and isLeaf bitmaps, then per non-zero child in slot
    order a leaf's 4 key limbs and 32-byte LE value, or an INTERMEDIATE's
    4 hash limbs."""
    types = np.concatenate([dd["types"] for dd in depths])
    sub_rows = []
    for d, dd in enumerate(depths):
        r = dd["ref"].copy()
        inter = dd["types"] == INTERMEDIATE
        if inter.any():
            r[inter] = 1 + n + tops[d + 1][r[inter]]
        sub_rows.append(r)
    rows = np.concatenate(sub_rows)
    header = np.concatenate(
        [np.packbits(types == ZERO, axis=1, bitorder="little"),
         np.packbits(types == LEAF, axis=1, bitorder="little")], axis=1)
    chunk, slot = np.nonzero(types != ZERO)
    kind = types[chunk, slot]
    units = np.where(kind == LEAF, _UNITS[LEAF], _UNITS[INTERMEDIATE])
    n_chunks = len(types)
    chunk_units = 1 + np.bincount(chunk, weights=units,
                                  minlength=n_chunks).astype(np.int64)
    start = np.cumsum(chunk_units) - chunk_units
    within = np.cumsum(units) - units
    first = np.searchsorted(chunk, np.arange(n_chunks))
    at = start[chunk] + 1 + within - within[first[chunk]]
    buf = np.zeros((int(chunk_units.sum()), _UNIT), dtype=np.uint8)
    buf[start] = header
    ref = rows[chunk, slot]
    leaf = kind == LEAF
    lk = ref[leaf]
    rec = np.concatenate([keys[lk].astype("<u8").view(np.uint8),
                          v8[lk].astype("<u4").view(np.uint8)], axis=1)
    buf[at[leaf][:, None] + np.arange(4)] = rec.reshape(-1, 4, _UNIT)
    hashes = table[ref[~leaf]].astype("<u8").view(np.uint8)
    buf[at[~leaf][:, None] + np.arange(2)] = hashes.reshape(-1, 2, _UNIT)
    raw = buf.tobytes()
    bounds = (start * _UNIT).tolist() + [len(raw)]
    data = [raw[a:b] for a, b in zip(bounds, bounds[1:])]
    own = []
    for d in range(len(depths)):
        top = tops[d]
        own.append(1 + n + top if d or top[0] >= 0 else 1 + ~top)
    return data, np.concatenate(own)


def _write_order(depths, n: int) -> np.ndarray:
    """The JAX recursion's order of ``write_chunk``: each chunk after its
    sub-chunks, siblings in the order their slots first appear among the
    parent's items (their first leaves').  A chunk's key is the first
    leaves of its ancestors from depth 1 down to itself, padded with n:
    sorted, a sub-chunk comes before its parent."""
    n_depths = len(depths)
    counts = [len(dd["parent"]) for dd in depths]
    offsets = np.cumsum([0] + counts)
    key = np.full((offsets[-1], max(n_depths - 1, 1)), n, dtype=np.int64)
    anc = [np.arange(c) for c in counts]
    for d in range(1, n_depths):
        a = anc[d]                 # each chunk's ancestor at depth k, from
        for k in range(d, 0, -1):  # itself up to depth 1
            key[offsets[d]:offsets[d + 1], k - 1] = depths[k]["first"][a]
            a = depths[k]["parent"][a]
    return np.lexsort(key.T[::-1])


def build(keys: np.ndarray, values: Sequence[int],
          device: torch.device) -> Tuple[tuple, list]:
    """Hash and encode the chunk forest of a non-empty leaf set: `keys`
    (n, 4) uint64 in the JAX package's item order, `values` their 256-bit
    values.  -> (root hash, [(chunk hash, chunk bytes)] in the JAX
    package's write order)"""
    n = len(keys)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    v8 = np.frombuffer(b"".join(int(v).to_bytes(32, "little")
                                for v in values),
                       dtype="<u4").reshape(n, 8)
    depths = _structure(keys)
    leaf_level, left, right, node_level, tops = _reduce(depths, n)
    table = _hash_table(keys, v8, leaf_level, left, right, node_level,
                        device)
    data, own = _encode(depths, tops, keys, v8, table, n)
    hashes = table[own].tolist()
    order = _write_order(depths, n).tolist()
    chunks = [(tuple(hashes[i]), data[i]) for i in order]
    return chunks[-1][0], chunks
