"""The port's PLONK conversion (``snark/plonk.py``) against the JAX
package's on the CPU, exactly.

The list form (``r1cs_to_plonk``, ``plonk_witness``, ``check_plonk``,
``wire_columns``) and the array form (``r1cs_to_arrays``, ``sigma``) give
the JAX package's gates, wire values and copy permutation on the circuits
of tests/test_fflonk.py, on the seeded circuit of chip_smoke.py phase 13
(b) and on hypothesis-drawn R1CS: linear combinations of one term with
coefficient 1 and not, constants on every side, empty ones, wires used
again across columns, coefficients 0, r - 1 and above r.
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from xlayer_prover_tpu.snark import plonk as jplonk
from xlayer_prover_tpu.snark.r1cs import R1CSBuilder as JBuilder
from xlayer_prover_tpu_torch.fields.bn254 import R
from xlayer_prover_tpu_torch.ops.bn254_mont import from_words
from xlayer_prover_tpu_torch.snark import plonk
from xlayer_prover_tpu_torch.snark.r1cs import R1CS, R1CSBuilder

from tests.torch_cpu import one_torch_thread  # noqa: F401


def cubic(builder, x: int):
    b = builder()
    out = b.public((x ** 3 + x + 5) % R)
    xw = b.wire(x)
    x2 = b.mul(xw, xw)
    x3 = b.mul(x2, xw)
    b.assert_eq_lc({x3: 1, xw: 1}, 5, out)
    return b


def multi(builder):
    b = builder()
    xs = [b.public(v) for v in (3, 5, 9)]
    w1 = b.mul(xs[0], xs[1])
    w2 = b.mul(w1, xs[2])
    out = b.wire((2 * 135 + 3 * 15 + 3 + 7) % R)
    b.assert_eq_lc({w2: 2, w1: 3, xs[0]: 1}, 7, out)
    b.mul(out, out)
    return b


def gate_tuples(gates):
    return [(g.qM, g.qL, g.qR, g.qO, g.qC, g.a, g.b, g.c) for g in gates]


def array_gates(arr):
    """The array form's gates as (qM, qL, qR, qO, qC, a, b, c) tuples."""
    q = {name: from_words(arr.q[name]) for name in plonk.SELECTORS}
    a, b, c = (arr.wires[j].tolist() for j in range(3))
    return [(q["qM"][i], q["qL"][i], q["qR"][i], q["qO"][i], q["qC"][i],
             a[i], b[i], c[i]) for i in range(arr.n_gates)]


def same_as_jax(r1cs, witness):
    """Every form of the port's conversion equals the JAX package's."""
    jc = jplonk.r1cs_to_plonk(r1cs)
    jv = jplonk.plonk_witness(jc, r1cs, witness)
    pc = plonk.r1cs_to_plonk(r1cs)
    pv = plonk.plonk_witness(pc, r1cs, witness)
    assert gate_tuples(pc.gates) == gate_tuples(jc.gates)
    assert (pc.n_public, pc.n_wires, pc.n) == (jc.n_public, jc.n_wires, jc.n)
    assert pv == jv
    pubs = witness[1:1 + r1cs.n_public]
    assert plonk.check_plonk(pc, pv, pubs) == jplonk.check_plonk(jc, jv, pubs)
    assert plonk.wire_columns(pc, pv) == jplonk.wire_columns(jc, jv)
    arr = plonk.r1cs_to_arrays(r1cs, witness)
    assert array_gates(arr) == gate_tuples(jc.gates)
    assert (arr.n_public, arr.n_wires, arr.n, arr.n_gates) == \
        (jc.n_public, jc.n_wires, jc.n, len(jc.gates))
    assert from_words(arr.vals) == jv
    _cols, sig = jplonk.wire_columns(jc, None)
    assert plonk.sigma(torch.from_numpy(arr.wires), arr.n).tolist() == sig
    no_wit = plonk.r1cs_to_arrays(r1cs)
    assert no_wit.vals is None
    assert np.array_equal(no_wit.wires, arr.wires)
    back = plonk.arrays_of(pc, pv)
    assert np.array_equal(back.wires, arr.wires)
    assert all(np.array_equal(back.q[k], arr.q[k]) for k in plonk.SELECTORS)
    return jc, jv


@pytest.mark.parametrize("case", ["cubic", "multi"])
def test_fflonk_circuits_equal_jax(case):
    """tests/test_fflonk.py's two circuits, built by each package's
    builder, convert alike."""
    for builder in (R1CSBuilder, JBuilder):
        b = cubic(builder, 3) if case == "cubic" else multi(builder)
        jc, jv = same_as_jax(b.build(), b.witness())
        assert jplonk.check_plonk(jc, jv, b.witness()[1:1 + jc.n_public])


def test_seeded_r1cs_of_the_fixture():
    """plonk.seeded_r1cs is satisfied, and converts as the JAX package
    converts it: the circuit of chip_smoke.py phase 13 (b) (n = 2^12)."""
    from xlayer_prover_tpu_torch.snark.r1cs import check_witness
    r1cs, witness = plonk.seeded_r1cs(20261018, 760)
    assert check_witness(r1cs, witness)
    jc, jv = same_as_jax(r1cs, witness)
    assert jc.n == 1 << 12 and len(jc.gates) == 3979
    assert jplonk.check_plonk(jc, jv, witness[1:1 + r1cs.n_public])
    # a different seed, another circuit
    other, _w = plonk.seeded_r1cs(20261019, 760)
    assert other.constraints != r1cs.constraints


def test_sigma_cycles_follow_append_order():
    """A wire in every column of several gates: its cycle runs gate by
    gate and a, b, c within a gate (not slot order), so sigma points row
    0 column 2 to row 1 column 0."""
    wires = torch.tensor([[5, 5, 0, 7], [0, 5, 7, 0], [5, 0, 5, 7]])
    n = 4
    got = plonk.sigma(wires, n).tolist()
    gates = [plonk.PlonkGate(a=int(wires[0, i]), b=int(wires[1, i]),
                             c=int(wires[2, i])) for i in range(4)]
    circ = plonk.PlonkCircuit(gates=gates, n_public=0, n_wires=8)
    assert got == plonk.wire_columns(circ, None)[1]
    assert got[2 * n + 0] == 0 * n + 1           # c of row 0 -> a of row 1
    empty = plonk.sigma(torch.zeros((3, 3), dtype=torch.int64), 4)
    assert empty.tolist() == list(range(12))


def _lc(draw, wires):
    terms = draw(st.dictionaries(
        st.sampled_from(wires),
        st.one_of(st.just(1), st.just(0), st.just(R - 1), st.just(R + 3),
                  st.integers(2, 9), st.integers(0, 2 * R)),
        max_size=4))
    return terms


@st.composite
def r1cs_cases(draw):
    """A random R1CS (not necessarily satisfied) and a witness."""
    n_public = draw(st.integers(0, 3))
    n_wires = 1 + n_public + draw(st.integers(1, 6))
    wires = list(range(n_wires))
    constraints = []
    for _ in range(draw(st.integers(1, 6))):
        constraints.append(tuple(_lc(draw, wires) for _ in range(3)))
    witness = [1] + [draw(st.integers(0, R - 1)) for _ in range(n_wires - 1)]
    return R1CS(n_public=n_public, n_wires=n_wires,
                constraints=constraints), witness


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(r1cs_cases())
def test_hypothesis_r1cs_equal_jax(case):
    r1cs, witness = case
    same_as_jax(r1cs, witness)


def test_seeded_shapes_cover_the_edges():
    """The seeded generator's draws include every kind of linear
    combination the conversion treats apart."""
    r1cs, _w = plonk.seeded_r1cs(7, 200)
    kinds = set()
    for row in r1cs.constraints:
        for lc in row:
            terms = [(w, k) for w, k in lc.items() if w]
            kinds.add("const" if 0 in lc else "no-const")
            if len(terms) == 1:
                kinds.add("one-1" if terms[0][1] == 1 else "one-k")
            elif len(terms) > 1:
                kinds.add("many")
    assert kinds >= {"const", "no-const", "one-1", "one-k", "many"}
    rng = random.Random(3)
    assert plonk.domain_size(rng.choice([0, 1, 2])) == 2
    assert plonk.domain_size(3) == 4 and plonk.domain_size(4097) == 8192
