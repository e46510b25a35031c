"""RecursionStack: the proof cascade manager.

The port's own copy of ``xlayer_prover_tpu/recursion/stack.py``:
``finalize(wrap="groth16")`` proves RecursiveF (the BN128 commitment
scheme), builds the BN254 final circuit's R1CS and, with ``snark=True``,
proves it with Groth16 on the card (``snark/groth16.py``); ``snark=False``
stops at the R1CS witness check.

Mirrors the reference cascade (prover.cpp:392-825): batch STARK ->
recursive1 (verifier-as-circuit compression) -> recursive2 aggregation.
Recursive2 is SHAPE-STABLE (engine.py): one engine aggregates recursive1
proofs, its own proofs, or a mix, so aggregation trees of any depth and
shape (incl. unbalanced ones — 3 or 5 batches) use exactly two circuits,
like the reference's recursive1/recursive2 pair
(test/service/aggregator/aggregator_service.cpp:18-240).

Soundness chain: every proof carries the verkey its non-leaf children
were verified against in publics[0:4] (0000 marks a recursive1 leaf);
``verify``/``finalize`` pin the root's carried verkey to the recursive2
engine's own key, which transitively fixes every interior node (the
reference's rootC public).
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from .. import device as devices
from ..stark.proof import StarkProof
from .engine import Recursive1, Recursive2, RecursiveF, build_recursion_pair


def zkevm_chain_spec(n_publics: int):
    """(link, out_map) for the zkEVM publics layout (prover.cpp:494-543):
    the chain rule pins p1.newStateRoot == p2.oldStateRoot in-circuit and
    the aggregate exposes old* from p1 and new* from p2 — recursive2's
    semantics for both the 27-slot (legacy) and 44-slot layouts."""
    if n_publics not in (27, 44):
        raise ValueError(f"zkEVM publics are 27 or 44 slots, not "
                         f"{n_publics}")
    link = [(19 + k, k) for k in range(8)]
    out_map = [("p1", i) for i in range(19)] + \
              [("p2", i) for i in range(19, n_publics)]
    return link, out_map


@dataclasses.dataclass
class RecursiveProof:
    level: int            # 1 = recursive1 output, 2 = aggregation output
    proof: StarkProof     # StarkProof of the standard-shape gate air

    def to_json(self):
        return {"level": self.level, "proof": self.proof.to_json()}

    @staticmethod
    def from_json(blob) -> "RecursiveProof":
        """From ``to_json()``'s dict or its JSON text (the cascade's
        stage files, ``tools/run_a7_cascade.py``)."""
        if isinstance(blob, str):
            blob = json.loads(blob)
        return RecursiveProof(level=blob["level"],
                              proof=StarkProof.from_json(blob["proof"]))


class RecursionStack:
    def __init__(self, batch_air, batch_verkey, n_queries: int = 8,
                 link=None, out_map=None, device=None):
        self.batch_air = batch_air
        self.batch_verkey = list(batch_verkey)
        self.n_queries = n_queries
        self.link = link
        self.out_map = out_map
        self.device = device
        self.timings: dict = {}    # the pair build's seconds
        self._rec1: Recursive1 = None
        self._rec2: Recursive2 = None
        self._aux: dict = {}       # ("recF", level) -> RecursiveF,
        #                            ("g16", level) -> Groth16 (pk, vk)
        self.final_circuit = None  # the last wrap's (R1CS, witness), for
        #                            a second wrap of it (fflonk)

    # -- engines ---------------------------------------------------------
    def _ensure_pair(self):
        if self._rec1 is None:
            self._rec1, self._rec2 = build_recursion_pair(
                self.batch_air, self.batch_verkey,
                n_queries=self.n_queries, link=self.link,
                out_map=self.out_map, device=self.device,
                timings=self.timings)

    def rec1(self) -> Recursive1:
        self._ensure_pair()
        return self._rec1

    def rec2(self) -> Recursive2:
        self._ensure_pair()
        return self._rec2

    # -- operations ------------------------------------------------------
    def lift(self, proof, timings: dict | None = None) -> RecursiveProof:
        """Raw batch StarkProof -> recursive1; recursive proofs pass."""
        if isinstance(proof, RecursiveProof):
            return proof
        return RecursiveProof(level=1,
                              proof=self.rec1().prove(proof, timings))

    def aggregate(self, p1: RecursiveProof, p2: RecursiveProof,
                  timings: dict | None = None) -> RecursiveProof:
        """Aggregate two recursive proofs — levels may differ (the
        shape-stable circuit dispatches per child on the leaf marker)."""
        return RecursiveProof(level=2, proof=self.rec2().prove(
            p1.proof, p2.proof, timings))

    def verify(self, rp: RecursiveProof) -> bool:
        if rp.level == 1:
            return self.rec1().verify(rp.proof)
        return self.rec2().verify(rp.proof)

    def finalize(self, proof, wrap: str = "stark", snark: bool = True,
                 rng=None, timings: dict | None = None):
        """Final-stage packaging (reference genFinalProof,
        prover.cpp:827-980).

        wrap="stark": verify (incl. the root carried-verkey pin) and
        return the terminal recursive proof.
        wrap="groth16": re-prove through RecursiveF (the same verifier
        circuit over BN254 Poseidon commitments, built once per level) and
        express ITS verifier as a BN254-Fr R1CS (snark/final_circuit.py).
        ``snark=True`` proves that R1CS with Groth16 (set up once per
        level, with `rng`, then proven with the same `rng`), verifies the
        proof and returns {"final": "groth16", "proof", "vk", "publics",
        "recf_proof"}, the on-chain object; ``snark=False`` stops after
        the R1CS witness check and returns {"final": "r1cs",
        "n_constraints", "publics", "proof", "recf_proof"}.  "recf_proof"
        is the RecursiveF proof (``snark=False``'s "proof"); the R1CS and
        its witness stay in ``final_circuit``.  `timings`
        receives the seconds of the RecursiveF build (``recF_*``, when it
        is built), its proof's rounds, the R1CS build (``r1cs_s``), and
        then its check (``check_s``) or the Groth16 setup
        (``g16_setup_s``, when it runs, with its host part
        ``g16_wire_polys_s`` and the fixed-base batches
        ``g16_fixed_base_g1_s`` / ``_g2_s``), proof (``g16_prove_s``, with h's
        ``g16_h_s``: ``g16_h_eval_s`` on the host, ``g16_h_ntt_s`` on the
        card) and verification (``g16_verify_s``)."""
        if wrap not in ("stark", "groth16"):
            raise ValueError(f"unknown wrap {wrap!r}")
        rp = self.lift(proof)
        if not self.verify(rp):
            raise ValueError("the recursive proof does not verify")
        if wrap == "stark":
            return rp

        from ..snark import final_circuit, groth16
        from ..snark.r1cs import check_witness
        timings = {} if timings is None else timings
        key = ("recF", rp.level)
        eng = self._aux.get(key)
        if eng is None:
            inner = self.rec1() if rp.level == 1 else self.rec2()
            built = {}
            eng = RecursiveF(inner.air, inner.verkey,
                             n_queries=self.n_queries, device=self.device,
                             timings=built)
            timings.update({f"recF_{k}": v for k, v in built.items()})
            self._aux[key] = eng
        bn_proof = eng.prove(rp.proof, timings)
        t0 = time.perf_counter()
        r1cs, witness, _fb = final_circuit.build_final_circuit(
            eng.air, eng.setup.verkey, bn_proof)
        timings["r1cs_s"] = time.perf_counter() - t0
        self.final_circuit = (r1cs, witness)
        publics = witness[1:1 + r1cs.n_public]
        if not snark:
            t0 = time.perf_counter()
            satisfied = check_witness(r1cs, witness)
            timings["check_s"] = time.perf_counter() - t0
            if not satisfied:
                raise ValueError("the final circuit's witness does not "
                                 "satisfy its R1CS")
            return {"final": "r1cs", "n_constraints": len(r1cs.constraints),
                    "publics": publics, "proof": bn_proof,
                    "recf_proof": bn_proof}
        g16_key = ("g16", rp.level)
        pkvk = self._aux.get(g16_key)
        if pkvk is None:
            t0 = time.perf_counter()
            pkvk = groth16.setup(r1cs, rng=rng, device=self.device,
                                 timings=timings)
            _sync(self.device)
            timings["g16_setup_s"] = time.perf_counter() - t0
            self._aux[g16_key] = pkvk
        pk, vk = pkvk
        t0 = time.perf_counter()
        g_proof = groth16.prove(pk, r1cs, witness, rng=rng, timings=timings)
        timings["g16_prove_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        accepted = groth16.verify(vk, g_proof, publics)
        timings["g16_verify_s"] = time.perf_counter() - t0
        if not accepted:
            raise ValueError("the Groth16 proof of the final circuit does "
                             "not verify")
        return {"final": "groth16", "proof": g_proof, "vk": vk,
                "publics": publics, "recf_proof": bn_proof}


def _sync(device):
    """Wait for the card's queued work (None means the card)."""
    dev = devices.resolve(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
