"""Recursion engines: recursive1 (one proof in, one proof out) and the
SHAPE-STABLE recursive2 (two proofs aggregated into one, unbounded depth).

The port's own copy of ``xlayer_prover_tpu/recursion/engine.py``: the
engines build their setups and prove on `device` (None: the GPU).

Mirrors the reference cascade (prover.cpp:392-825): a batch STARK is
compressed by proving its verifier as a gate circuit (c12a/recursive1);
two such proofs aggregate through a circuit verifying both (recursive2).

Shape stability (reference recursive2 verifies proofs of its own verkey,
prover.cpp:676-825): the gate AIR encodes a circuit ENTIRELY in its
constant polynomials, so two gate airs with the same geometry and public
count have identical shapes — they differ only by verkey.  Recursive1 and
recursive2 are therefore built at one standard geometry; recursive2 takes
the inner verkey as input WIRES and verifies two proofs of that shared
shape, so it can consume recursive1 proofs, its own proofs, or a mix:

  * publics layout (both engines): [carried_vk (4)] ++ payload;
    recursive1 pins carried_vk = 0 (the leaf marker), recursive2 exposes
    the verkey its non-leaf children were verified against;
  * per child: leaf = (child.carried_vk == 0); the child is verified
    against select(leaf, REC1_VERKEY const, vk_in wires), and non-leaf
    children must carry vk_in;
  * the root pin `proof.publics[0:4] == recursive2.verkey` (enforced by
    verify()/the final stage) then transitively fixes every interior
    node's key — aggregation trees of any depth and shape.

Setups (circuit + const tree) are built once per inner geometry and
reused for every proof.  ``RecursiveF`` is recursive1 over the BN128
commitment scheme (Poseidon-BN254 arity-16 trees and TranscriptBN128).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .. import device as dev
from ..fields import gl
from ..stark import prover as stark_prover
from ..stark import verifier as stark_verifier
from . import gate_air
from .circuit import Tracer
from .verifier_circuit import (declare_proof_wires, flatten_proof,
                               trace_verify)

P = gl.P


def _build(tracer: Tracer, n_queries: int, n_bits: Optional[int], device,
           timings: dict | None = None, scheme: str = "gl"):
    """Gate AIR (committed with `scheme`), layout and Setup of a traced
    circuit on `device`; `timings` receives the seconds of the AIR build
    with its constant columns (``air_s``) and of ``Setup.build``
    (``setup_s``)."""
    t0 = time.perf_counter()
    air, layout = gate_air.build(tracer, n_bits=n_bits, n_queries=n_queries)
    air.scheme = scheme
    const_np = np.zeros((air.n, air.const_width), dtype=np.uint64)
    gate_air.fill_fixed(layout, const_np, device)
    t1 = time.perf_counter()
    setup = stark_prover.Setup.build(air, const_np, device=device)
    if timings is not None:
        timings["air_s"] = t1 - t0
        timings["setup_s"] = time.perf_counter() - t1
    return air, layout, setup


def _shape_sig(air):
    return (air.n_bits, air.n_bits_ext, air.n_queries, tuple(air.fri_steps),
            air.cm1_width, air.cm2_width, air.cm3_width, air.cm4_width,
            air.const_width, air.n_publics, len(air.ev_map))


def _prove(engine, inputs, timings: dict | None):
    """Fill the gate AIR's witness from the circuit inputs and prove it;
    `timings` receives ``fill_witness_s`` (``Tracer.run`` included, also
    apart as ``run_s``) and gen_proof's rounds."""
    air = engine.air
    cm1 = np.zeros((air.n, air.cm1_width), dtype=np.uint64)
    t0 = time.perf_counter()
    vals = gate_air.fill_witness(engine.layout, inputs, cm1, engine.device,
                                 timings)
    if timings is not None:
        timings["fill_witness_s"] = time.perf_counter() - t0
    publics = gate_air.publics_of(engine.layout, vals)
    return stark_prover.gen_proof(engine.setup, cm1, publics,
                                  timings=timings)


class Recursive1:
    """Wrap one inner proof: prove that the inner verifier accepts it.

    Publics: [0, 0, 0, 0] (the leaf marker recursive2 dispatches on)
    followed by the inner proof's publics."""

    def __init__(self, inner_air, inner_verkey, n_queries: int = 8,
                 n_bits: Optional[int] = None, scheme: str = "gl",
                 device=None, _tracer=None, _pw=None,
                 timings: dict | None = None):
        self.inner_air = inner_air
        self.inner_verkey = list(inner_verkey)
        self.device = dev.resolve(device)
        if _tracer is None:
            t0 = time.perf_counter()
            _tracer, _pw = self.trace(inner_air, self.inner_verkey)
            if timings is not None:
                timings["trace_s"] = time.perf_counter() - t0
        self.tracer, self._pw = _tracer, _pw
        self.air, self.layout, self.setup = _build(
            _tracer, n_queries, n_bits, self.device, timings, scheme)

    @staticmethod
    def trace(inner_air, inner_verkey):
        tracer = Tracer()
        pw = trace_verify(tracer, inner_air, inner_verkey)
        for _ in range(4):
            tracer.mark_public(tracer.zero)       # leaf marker
        for p in pw.publics:
            tracer.mark_public(p)
        return tracer, pw

    @property
    def verkey(self):
        return self.setup.verkey

    def prove(self, inner_proof, timings: dict | None = None):
        return _prove(self, flatten_proof(self.inner_air, inner_proof),
                      timings)

    def verify(self, proof):
        return stark_verifier.verify(self.air, self.setup.verkey, proof) \
            and [int(v) for v in proof.publics[:4]] == [0, 0, 0, 0]


class Recursive2:
    """Shape-stable aggregation: two proofs of `shape_air` (recursive1 OR
    recursive2 proofs, in any mix) into one proof of the same shape.

    publics = [vk_in (4)] ++ payload; `out_map` maps each payload slot to
    ("p1"|"p2", payload_index) of a child (default: p1's payload), and
    `link` is a list of (i, j) pairs constraining payload1[i] ==
    payload2[j] in-circuit (the zkEVM chain rule newStateRoot_1 ==
    oldStateRoot_2)."""

    def __init__(self, shape_air, leaf_verkey, n_queries: int = 8,
                 n_bits: Optional[int] = None, link=None, out_map=None,
                 device=None, _prebuilt=None, timings: dict | None = None):
        self.shape_air = shape_air
        self.leaf_verkey = [int(v) % P for v in leaf_verkey]
        self.device = dev.resolve(device)
        n_payload = shape_air.n_publics - 4
        self.out_map = list(out_map) if out_map is not None else \
            [("p1", i) for i in range(n_payload)]
        if len(self.out_map) != n_payload:
            raise ValueError("payload must keep the standard width (shape "
                             "stability)")
        self.link = list(link or [])
        if _prebuilt is None:
            tracer = self.trace(shape_air, self.leaf_verkey, self.link,
                                self.out_map)
            _prebuilt = (tracer, n_bits)
        tracer, n_bits = _prebuilt
        self.tracer = tracer
        self.air, self.layout, self.setup = _build(
            tracer, n_queries, n_bits, self.device, timings)

    @staticmethod
    def trace(shape_air, leaf_verkey, link, out_map) -> Tracer:
        t = Tracer()
        vk_in = t.inputs(4)
        pw1 = declare_proof_wires(t, shape_air)
        pw2 = declare_proof_wires(t, shape_air)
        vk_leaf = [t.constant(v) for v in leaf_verkey]
        zero4 = [t.zero] * 4
        for pw in (pw1, pw2):
            carried = pw.publics[:4]
            t.scope = "vk-dispatch"
            leaf = t.all_eq(carried, zero4)
            not_leaf = t.sub(t.one, leaf)
            for k in range(4):
                # non-leaf children must have been verified against vk_in
                t.assert_zero(t.mul(not_leaf,
                                    t.sub(carried[k], vk_in[k])))
            vk_used = [t.select(leaf, vk_leaf[k], vk_in[k])
                       for k in range(4)]
            trace_verify(t, shape_air, vk_wires=vk_used, pw=pw)
        t.scope = "links"
        for (i, j) in link:
            t.assert_eq(pw1.publics[4 + i], pw2.publics[4 + j])
        for w in vk_in:
            t.mark_public(w)
        for (src, idx) in out_map:
            pw = pw1 if src == "p1" else pw2
            t.mark_public(pw.publics[4 + idx])
        return t

    @property
    def verkey(self):
        return self.setup.verkey

    def prove(self, proof1, proof2, timings: dict | None = None):
        vk_vals = [int(v) % P for v in self.setup.verkey]
        return _prove(self, vk_vals + flatten_proof(self.shape_air, proof1)
                      + flatten_proof(self.shape_air, proof2), timings)

    def verify(self, proof):
        """Root acceptance: STARK verifies AND the carried verkey is this
        engine's own (pins every interior node transitively)."""
        if not stark_verifier.verify(self.air, self.setup.verkey, proof):
            return False
        return [int(v) % P for v in proof.publics[:4]] == \
            [int(v) % P for v in self.setup.verkey]


def build_recursion_pair(inner_air, inner_verkey, n_queries: int = 8,
                         link=None, out_map=None, device=None,
                         timings: dict | None = None):
    """Build (recursive1, recursive2) at one standard geometry (the shape
    fixpoint): recursive2 must fit in the same domain as recursive1 so its
    proofs are self-verifiable.  Iterates the domain size up until both
    circuits fit and the shapes agree.  `timings` receives the seconds of
    each engine's trace, AIR build and Setup (``rec1_trace_s``,
    ``rec1_air_s``, ``rec1_setup_s``, and the same for rec2)."""
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    tracer1, pw1 = Recursive1.trace(inner_air, list(inner_verkey))
    timings["rec1_trace_s"] = time.perf_counter() - t0
    n_std = gate_air.plan(tracer1)["n_bits"]
    for _ in range(8):
        t1, t2 = {}, {}
        rec1 = Recursive1(inner_air, inner_verkey, n_queries=n_queries,
                          n_bits=n_std, device=device, _tracer=tracer1,
                          _pw=pw1, timings=t1)
        t0 = time.perf_counter()
        tracer2 = Recursive2.trace(rec1.air, rec1.verkey, list(link or []),
                                   out_map if out_map is not None else
                                   [("p1", i) for i in
                                    range(rec1.air.n_publics - 4)])
        timings["rec2_trace_s"] = time.perf_counter() - t0
        need2 = gate_air.plan(tracer2)["n_bits"]
        if need2 > n_std:
            n_std = need2
            continue
        rec2 = Recursive2(rec1.air, rec1.verkey, n_queries=n_queries,
                          n_bits=n_std, link=link, out_map=out_map,
                          device=device, _prebuilt=(tracer2, n_std),
                          timings=t2)
        if _shape_sig(rec1.air) != _shape_sig(rec2.air):
            raise RuntimeError(f"recursion pair shapes differ: "
                               f"{_shape_sig(rec1.air)} != "
                               f"{_shape_sig(rec2.air)}")
        for name, t in (("rec1", t1), ("rec2", t2)):
            timings.update({f"{name}_{k}": v for k, v in t.items()})
        return rec1, rec2
    raise RuntimeError("recursion pair geometry did not converge")


class RecursiveF(Recursive1):
    """Recursive1 over the BN128 commitment stack (starkRecursiveF.cpp):
    the same verifier-as-gate-circuit, committed with Poseidon-BN254
    arity-16 Merkle trees + TranscriptBN128, so the output proof is cheap
    to verify inside the BN254 final circuit (snark/final_circuit.py)."""

    def __init__(self, inner_air, inner_verkey, n_queries: int = 8,
                 n_bits: Optional[int] = None, device=None,
                 timings: dict | None = None):
        super().__init__(inner_air, inner_verkey, n_queries=n_queries,
                         n_bits=n_bits, scheme="bn128", device=device,
                         timings=timings)
