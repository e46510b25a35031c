"""Commitment scheme: Poseidon-Goldilocks binary trees + their transcript.

Counterpart of ``GLScheme`` in ``xlayer_prover_tpu/stark/commitment.py``;
the prover, FRI and the verifier route every commitment through it.
"""

from __future__ import annotations

from typing import List

from ..fields import gl
from ..ops import merkle
from ..ops.poseidon_gl import host_linear_hash, host_permute
from .transcript import Transcript


class GLScheme:
    name = "gl"

    def transcript(self):
        return Transcript()

    def merkelize(self, rows, width: int):
        return merkle.merkelize(rows, width)

    def root(self, tree) -> List[int]:
        return [int(v) for v in tree.root_np()]

    def open_many(self, tree, source, idxs):
        """All openings of one tree: one row gather and one sibling-path
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


def get_scheme(air):
    scheme = getattr(air, "scheme", "gl")
    if scheme != "gl":
        raise NotImplementedError(f"commitment scheme {scheme!r} is not "
                                  "ported")
    return GLScheme()
