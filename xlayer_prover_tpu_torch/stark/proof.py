"""STARK proof containers + JSON serialization.

Shape mirrors the reference FRIProof (src/starkpil/fri/friProof.hpp:154-235):
roots 1..4, evals[nEv][3], fri.trees[si] = {root?, polQueries}, final pol,
publics.  polQueries[q] for step 0 opens the 5 main trees (cm1..cm4, const);
steps >= 1 open the single FRI layer tree.  JSON uses decimal strings like
the reference's proof2json.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional


@dataclasses.dataclass
class MerkleProofData:
    values: List[int]          # leaf row (width elements)
    siblings: List[List[int]]  # per level: the 4-element sibling digest
                               # (gl) or the 16-sibling group (bn128)


@dataclasses.dataclass
class FriStep:
    root: Optional[List[int]]                 # None for step 0
    queries: List[List[MerkleProofData]]      # [nQueries][nTrees]


@dataclasses.dataclass
class StarkProof:
    roots: List[List[int]]       # 4 roots x 4 elements (gl) or 1 (bn128)
    evals: List[List[int]]       # [nEv][3]
    fri_steps: List[FriStep]
    final_pol: List[List[int]]   # [pol2N][3]
    publics: List[int]

    def to_json(self) -> str:
        def mp(m):
            return {"v": [str(v) for v in m.values],
                    "mp": [[str(x) for x in level] for level in m.siblings]}

        obj = {
            "root1": [str(v) for v in self.roots[0]],
            "root2": [str(v) for v in self.roots[1]],
            "root3": [str(v) for v in self.roots[2]],
            "root4": [str(v) for v in self.roots[3]],
            "evals": [[str(x) for x in e] for e in self.evals],
            "fri": [
                {
                    **({"root": [str(v) for v in s.root]} if s.root else {}),
                    "polQueries": [[mp(m) for m in q] for q in s.queries],
                }
                for s in self.fri_steps
            ],
            "friFinalPol": [[str(x) for x in e] for e in self.final_pol],
            "publics": [str(v) for v in self.publics],
        }
        return json.dumps(obj)

    @staticmethod
    def from_json(s: str) -> "StarkProof":
        obj = json.loads(s)

        def mp(d):
            return MerkleProofData(values=[int(v) for v in d["v"]],
                                   siblings=[[int(x) for x in lv] for lv in d["mp"]])

        return StarkProof(
            roots=[[int(v) for v in obj[f"root{i}"]] for i in range(1, 5)],
            evals=[[int(x) for x in e] for e in obj["evals"]],
            fri_steps=[
                FriStep(root=[int(v) for v in st["root"]] if "root" in st else None,
                        queries=[[mp(m) for m in q] for q in st["polQueries"]])
                for st in obj["fri"]
            ],
            final_pol=[[int(x) for x in e] for e in obj["friFinalPol"]],
            publics=[int(v) for v in obj["publics"]],
        )
