"""FRI commit/fold/query phases on the device.

Counterpart of ``xlayer_prover_tpu/stark/fri.py`` (parity with
FRIProve::prove, friProve.cpp:5-190): per step the current polynomial
values (cubic extension, on the shifted coset of size 2^bits) are folded by
grouping indices with equal residue mod 2^bits_next, a size-nX INTT per
group, un-shifting coefficients by powers of (shift * w^g)^-1 and
evaluating at the step's transcript challenge; the un-folded layer is
committed transposed so one Merkle leaf holds exactly the group a verifier
needs.  Only the final polynomial and the query rows leave the device.
"""

from __future__ import annotations

import torch

from ..fields import gl, gl3
from ..ops import ntt
from .proof import FriStep, MerkleProofData


def fold(values, special_x, shift_inv: int, w_inv: int, bits: int,
         bits_next: int):
    """One FRI fold: (2^bits,)-triple -> (2^bits_next,)-triple.

    special_x: gl3 scalar (triple of 0-d tensors).  shift_inv/w_inv:
    python ints for the CURRENT domain (inverse coset shift, inverse
    2^bits root)."""
    n = 1 << bits
    n_out = 1 << bits_next
    n_x = n // n_out
    device = values[0].device
    # group g holds indices {g + j*n_out}: element [j, g] after reshape
    grouped = gl3.stack_cols(values).reshape(n_x, n_out * 3)
    coeffs = ntt.intt(grouped, bits - bits_next).reshape(n_x, n_out, 3)
    # coeff i of group g is scaled by (shift_inv * w_inv^g)^i
    base = gl.mul_const(gl.powers_device(w_inv, n_out, device), shift_inv)
    rows = [gl.ones((n_out,), device)]
    for _ in range(n_x - 1):
        rows.append(gl.mul(rows[-1], base))
    scale = torch.stack(rows, dim=0)                   # (n_x, n_out)
    coeffs3 = tuple(gl.mul(coeffs[..., k], scale) for k in range(3))
    # Horner at special_x over i (dim 0)
    acc = tuple(c[n_x - 1] for c in coeffs3)
    for i in range(n_x - 2, -1, -1):
        acc = gl3.add(gl3.mul(acc, special_x), tuple(c[i] for c in coeffs3))
    return acc


def transpose_for_tree(values, bits: int, bits_next: int):
    """Merkle source of the NEXT step's tree: leaf g = its fold group.

    values: gl3 triple of (2^bits,) tensors -> (2^bits_next, group*3),
    matching FRIProve::getTransposed + MerkleTreeGL(nGroups, groupSize*3).
    """
    n_groups = 1 << bits_next
    group = (1 << bits) // n_groups
    cols = gl3.stack_cols(values)                      # (n, 3)
    return cols.reshape(group, n_groups, 3).permute(1, 0, 2).reshape(
        n_groups, group * 3).contiguous()


def prove(transcript, fri_pol, air, trees_main, sources_main, scheme):
    """FRI commit + query phases.

    fri_pol: gl3 triple of (n_ext,) tensors.  trees_main/sources_main: the
    5 main trees and their sources (cm1..cm4, const order).  Returns
    (fri_steps_data, final_pol, ys)."""
    P = gl.P
    device = fri_pol[0].device
    steps = air.fri_steps
    shift_inv = gl.host_inv(gl.SHIFT)
    pol_bits = steps[0]

    layer = fri_pol
    fri_trees = [None]        # tree for step si >= 1
    fri_sources = [None]
    roots = [None]
    final_np = None
    for si in range(len(steps)):
        special_x = transcript.get_field()
        if si > 0:
            sx = gl3.from_ints(*special_x, device)
            w_inv = gl.host_inv(gl.host_w(pol_bits))
            layer = fold(layer, sx, shift_inv, w_inv, pol_bits, steps[si])
            for _ in range(pol_bits - steps[si]):
                shift_inv = (shift_inv * shift_inv) % P
            pol_bits = steps[si]
        if si < len(steps) - 1:
            src = transpose_for_tree(layer, steps[si], steps[si + 1])
            tree = scheme.merkelize(src, src.shape[1])
            fri_trees.append(tree)
            fri_sources.append(src)
            root = scheme.root(tree)
            roots.append(root)
            transcript.put(root)
        else:
            final_np = gl3.to_u64_np(layer)            # (2^last, 3)
            for row in final_np:
                transcript.put([int(v) for v in row])

    ys = transcript.get_permutations(air.n_queries, steps[0])

    fri_steps_data = []
    for si in range(len(steps)):
        idxs = [y % (1 << steps[si]) for y in ys]
        if si == 0:
            per_tree = [_open_many(scheme, tree, src, idxs)
                        for tree, src in zip(trees_main, sources_main)]
            queries = [[pt[qi] for pt in per_tree]
                       for qi in range(len(idxs))]
        else:
            opened = _open_many(scheme, fri_trees[si], fri_sources[si], idxs)
            queries = [[opened[qi]] for qi in range(len(idxs))]
        fri_steps_data.append(FriStep(root=roots[si] if si > 0 else None,
                                      queries=queries))
    return fri_steps_data, [[int(v) for v in row] for row in final_np], ys


def _open_many(scheme, tree, source, idxs):
    """All query openings of one tree: one row gather + one sibling-path
    gather, pulled to the host once each."""
    return [MerkleProofData(values=v, siblings=s)
            for v, s in scheme.open_many(tree, source, idxs)]
