"""proof -> zkin conversion + join (circom input-signal format).

The port's copy of ``xlayer_prover_tpu/stark/zkin.py``, over the port's
``stark/proof.StarkProof``.  Equivalent of the reference
proof2zkinStark/joinzkin (src/starkpil/fri/proof2zkinStark.cpp:6-83,
84-206): the STARK proof
re-keyed into the verifier circuit's input-signal names (root1..4,
evals, per-tree s0_vals*/s0_siblings*, per-FRI-step sN_root/vals/
siblings, finalPol, publics) and the two-proof merge consumed by
recursive2-shaped circuits (a_*/b_* prefixes + chained publics).  The
recursion consumes proofs natively (recursion/verifier_circuit.py), so
zkin is the interop/export format: any circom-tooling consumer of the
reference's zkin files can read these.
"""

from __future__ import annotations

from typing import Dict, List

from .proof import StarkProof


def _s(values) -> List[str]:
    return [str(int(v)) for v in values]


def proof_to_zkin(air, proof: StarkProof) -> Dict:
    """StarkProof -> ordered zkin dict (decimal strings, reference
    signal naming)."""
    zkin: Dict = {}
    for k in range(4):
        zkin[f"root{k + 1}"] = _s(proof.roots[k])
    zkin["evals"] = [_s(e) for e in proof.evals]

    n_steps = len(proof.fri_steps)
    for i in range(1, n_steps):
        st = proof.fri_steps[i]
        zkin[f"s{i}_root"] = _s(st.root)
        zkin[f"s{i}_vals"] = [_s(st.queries[q][0].values)
                              for q in range(len(st.queries))]
        zkin[f"s{i}_siblings"] = [
            [_s(level) for level in st.queries[q][0].siblings]
            for q in range(len(st.queries))]

    tree_names = ["1", "2", "3", "4", "C"]
    step0 = proof.fri_steps[0]
    widths = air.tree_widths()
    for ti, name in enumerate(tree_names):
        if widths[ti] == 0:
            continue
        zkin[f"s0_vals{name}"] = [_s(step0.queries[q][ti].values)
                                  for q in range(len(step0.queries))]
        zkin[f"s0_siblings{name}"] = [
            [_s(level) for level in step0.queries[q][ti].siblings]
            for q in range(len(step0.queries))]

    zkin["finalPol"] = [_s(row) for row in proof.final_pol]
    zkin["publics"] = _s(proof.publics)
    return zkin


def joinzkin(zkin1: Dict, zkin2: Dict, verkey, n_steps: int,
             chain_publics: bool = False) -> Dict:
    """Merge two zkins for a recursive2-shaped circuit
    (proof2zkinStark.cpp:84-206): a_*/b_* prefixed copies plus the
    aggregate publics.  ``chain_publics`` applies the zkEVM public
    layout (old* from proof 1, new* from proof 2); otherwise the publics
    concatenate."""
    out: Dict = {}
    p1, p2 = zkin1["publics"], zkin2["publics"]
    if chain_publics:
        # zkEVM layout: [oldStateRoot(8) oldAccInputHash(8) oldBatchNum
        #  chainId forkId newStateRoot(8) newAccInputHash(8)
        #  newLocalExitRoot(8) newBatchNum]
        pubs = list(p1[:19]) + list(p2[19:44])
        out["publics"] = pubs
    else:
        out["publics"] = list(p1) + list(p2)

    for prefix, z in (("a_", zkin1), ("b_", zkin2)):
        out[prefix + "publics"] = z["publics"]
        for key, val in z.items():
            if key == "publics":
                continue
            out[prefix + key] = val
    out["rootC"] = _s(verkey)
    return out
