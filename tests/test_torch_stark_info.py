"""Port parity: the StarkInfo loader, the section memory plan and the
host-resident section forms of xlayer_prover_tpu_torch against the JAX
package's, on equal inputs made from a numpy seed; exact equality.

``stark/stark_info.py`` (``StarkInfo``, ``info_from_air``,
``memory_plan``), the streamed LDE ``ops/ntt.extend_pol_blocks`` (the JAX
``extend_pol_np``), the leaf digests absorbed block by block
(``ops/merkle.LeafDigests``, ``GLScheme.extend_and_commit``; the JAX
``merkelize_np``), ``gather_rows`` from a host section and
``get_proofs_batch`` (the JAX ``gather_rows``, ``get_proofs_np``), the
plain ``poseidon_linear_hash`` with a carried
capacity, ``EvalEnv`` over row windows, and the section plan the prover
follows (``stark/prover.section_plan``, ``window_rows``).  The streamed
proofs are in ``test_torch_stream.py``."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from tests.test_stark_info import FIXTURE
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tools import torch_proof_fixtures as fixtures
from xlayer_prover_tpu.ops import merkle as jmerkle
from xlayer_prover_tpu.ops import ntt as jntt
from xlayer_prover_tpu.stark import stark_info as jsi
from xlayer_prover_tpu_torch.fields import gl, gl3
from xlayer_prover_tpu_torch.models.toy import fib
from xlayer_prover_tpu_torch.ops import merkle, ntt, poseidon_gl
from xlayer_prover_tpu_torch.stark import air as air_mod
from xlayer_prover_tpu_torch.stark import prover, stark_info
from xlayer_prover_tpu_torch.stark.eval import EvalEnv, count_refs, halo_rows
from xlayer_prover_tpu_torch.utils import devnet

P = gl.P
CPU = torch.device("cpu")
SEED = 20261018

# the reference geometry at 2^23 with the chains-bound widths of
# tests/test_stark_info.py's pod-slice case
REF_2E23 = {
    "starkStruct": {"nBits": 23, "nBitsExt": 24, "nQueries": 64,
                    "steps": [{"nBits": 24}, {"nBits": 19}, {"nBits": 14}]},
    "nConstants": 361, "nPublics": 44,
    "mapSectionsN": {"const_n": 361, "const_2ns": 361, "cm1_n": 751,
                     "cm1_2ns": 751, "cm2_n": 600, "cm2_2ns": 600,
                     "cm3_n": 999, "cm3_2ns": 999, "q_2ns": 6},
}
H100_BYTES = 85 * 10 ** 9          # ~ an H100's total_memory


@pytest.fixture
def rng():
    return np.random.default_rng(SEED)


def _field_rows(rng, n, width):
    a = rng.integers(0, P, size=(n, width), dtype=np.uint64)
    a[:3] = np.array([0, 1, P - 1], dtype=np.uint64)[:, None]
    return a


# ---------------------------------------------------------------------------
# StarkInfo and memory_plan
# ---------------------------------------------------------------------------

def test_from_json_and_load_equal_the_jax_loader(tmp_path):
    path = tmp_path / "test.starkinfo.json"
    path.write_text(json.dumps(FIXTURE))
    for got, want in ((stark_info.StarkInfo.from_json(FIXTURE),
                       jsi.StarkInfo.from_json(FIXTURE)),
                      (stark_info.StarkInfo.load(str(path)),
                       jsi.StarkInfo.load(str(path)))):
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            assert dataclasses.asdict(got)[f.name] == \
                dataclasses.asdict(want)[f.name], f.name
        assert got.fri_steps() == want.fri_steps() == [24, 19, 14, 9, 4]


def _airs():
    """(name, port air, JAX air) of the fib, Binary SM and composite AIRs."""
    from xlayer_prover_tpu.models.toy import fib as jfib
    return {
        "fib": (lambda: fib.build_air(n_bits=5, n_queries=8),
                lambda: jfib.build_air(n_bits=5, n_queries=8)),
        "binary_sm": (lambda: fixtures.binary_sm_case(
            "xlayer_prover_tpu_torch")[0],
            lambda: fixtures.binary_sm_case("xlayer_prover_tpu")[0]),
        "composite": (lambda: fixtures.composite_case(
            "xlayer_prover_tpu_torch")[0],
            lambda: fixtures.composite_case("xlayer_prover_tpu")[0]),
    }


PLAN_CASES = [("2e23", n_dev, hbm) for n_dev in (1, 64)
              for hbm in (16 << 30, H100_BYTES)] + \
    [(name, 1, hbm) for name in ("fib", "binary_sm", "composite")
     for hbm in (16 << 30, 4096)]


@pytest.mark.parametrize("case,n_devices,hbm", PLAN_CASES)
def test_memory_plan_equals_jax(case, n_devices, hbm):
    if case == "2e23":
        si, jsi_ = (stark_info.StarkInfo.from_json(REF_2E23),
                    jsi.StarkInfo.from_json(REF_2E23))
    else:
        make, jmake = _airs()[case]
        si, jsi_ = stark_info.info_from_air(make()), \
            jsi.info_from_air(jmake())
        assert dataclasses.asdict(si) == dataclasses.asdict(jsi_)
    got = stark_info.memory_plan(si, n_devices=n_devices, hbm_bytes=hbm)
    assert got == jsi.memory_plan(jsi_, n_devices=n_devices, hbm_bytes=hbm)
    assert stark_info.memory_plan(si) == jsi.memory_plan(jsi_)
    if case == "2e23":
        assert got["hbm_resident"] == (n_devices == 64)


# ---------------------------------------------------------------------------
# Host-resident sections: the streamed LDE, trees, openings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [8, 16, 64])
@pytest.mark.parametrize("width", [5, 39, 60])
def test_extend_pol_blocks_equals_jax_extend_pol_np(rng, block, width):
    a = _field_rows(rng, 1 << 6, width)
    seen = []
    got = ntt.extend_pol_blocks(a, 7, block, CPU,
                                on_block=lambda c0, b: seen.append(
                                    (c0, b.shape[1])))
    want = jntt.extend_pol_np(a, 7, block_cols=block)
    assert np.array_equal(gl.to_u64_np(got), want)
    assert seen == [(c0, min(block, width - c0))
                    for c0 in range(0, width, block)]
    # from a tensor on the device (the natural-domain sections of rounds
    # 2-3 stay there) too
    again = ntt.extend_pol_blocks(gl.from_u64_np(a, CPU), 7, block, CPU)
    assert torch.equal(again, got)


def _host_tree(section, width: int, block: int):
    """The tree of a host section whose leaves are absorbed `block`
    columns at a time (``LeafDigests``), as a streamed LDE commits."""
    leaves = merkle.LeafDigests(width)
    for c0 in range(0, width, block):
        leaves.absorb(gl.from_u64_np(section[:, c0:c0 + block], CPU))
    return leaves.tree(section.shape[0], CPU)


@pytest.mark.parametrize("width", [4, 8, 9, 39, 60])
def test_leaf_digests_equal_jax_merkelize_np(rng, width):
    section = _field_rows(rng, 1 << 7, width)
    want = jmerkle.merkelize_np(section, width, keep_levels_np=True)
    for block in (8, 16):
        tree = _host_tree(section, width, block)
        assert len(tree.levels) == len(want.levels) == 8
        for lv, jlv in zip(tree.levels, want.levels):
            assert np.array_equal(gl.to_u64_np(lv), np.asarray(jlv))
    # the leaves absorbed block by block while an LDE streams, against
    # the JAX package's LDE and tree of the same section
    for block in (8, 16):
        ext, tree = prover.get_scheme(
            types.SimpleNamespace(scheme="gl")).extend_and_commit(
            section[:64], 7, block, CPU)
        ext_np = jntt.extend_pol_np(section[:64], 7, block_cols=block)
        assert np.array_equal(gl.to_u64_np(ext), ext_np)
        jtree = jmerkle.merkelize_np(ext_np, width, keep_levels_np=True)
        assert len(tree.levels) == len(jtree.levels)
        for lv, jlv in zip(tree.levels, jtree.levels):
            assert np.array_equal(gl.to_u64_np(lv), np.asarray(jlv))


def test_gather_rows_and_get_proofs_np_equal_jax(rng):
    section = _field_rows(rng, 1 << 7, 39)
    idx = [0, 1, 17, 64, 127, 17]
    tree = _host_tree(section, 39, 16)
    jtree = jmerkle.merkelize_np(section, 39, keep_levels_np=True)
    want = jmerkle.gather_rows(section, idx)
    assert np.array_equal(
        merkle.gather_rows(gl.from_u64_np(section, CPU), idx), want)
    jgot = jmerkle.get_proofs_np(jtree, idx)
    batch = merkle.get_proofs_batch(tree, idx)
    assert batch.shape == (len(idx), 7, 4) and len(jgot) == len(idx)
    for path, jpath in zip(batch, jgot):
        assert len(jpath) == 7
        for a, b in zip(path, jpath):
            assert np.array_equal(a, np.asarray(b))
    for k, i in enumerate(idx):
        assert merkle.verify_proof(tree.root_np(), i, want[k], list(batch[k]))


@pytest.mark.parametrize("width,block", [(5, 8), (8, 8), (39, 8), (39, 16),
                                         (60, 24), (669, 64)])
def test_plain_linear_hash_with_carried_capacity(rng, width, block):
    rows = gl.from_u64_np(_field_rows(rng, 33, width), CPU)
    one = poseidon_gl.linear_hash(rows, width)
    dig = None
    for c0 in range(0, width, block):
        w = min(block, width - c0)
        dig = poseidon_gl.linear_hash(rows[:, c0:c0 + w], w, dig)
    assert torch.equal(dig, one)
    assert [int(v) for v in gl.to_u64_np(one[5])] == \
        poseidon_gl.host_linear_hash([int(v) for v in
                                      gl.to_u64_np(rows[5])])
    # a zero capacity is the one-shot start; a short tail block is hashed
    zero = gl.zeros((33, 4), CPU)
    assert torch.equal(poseidon_gl._linear_hash_plain(rows, width, zero),
                       poseidon_gl._linear_hash_plain(rows, width))
    with pytest.raises(ValueError):
        poseidon_gl.linear_hash(rows, width, zero[:5])


def test_leaf_digests_refuse_misaligned_blocks(rng):
    rows = gl.from_u64_np(_field_rows(rng, 8, 20), CPU)
    leaves = merkle.LeafDigests(20)
    leaves.absorb(rows[:, :5])
    with pytest.raises(ValueError):
        leaves.absorb(rows[:, 5:])
    with pytest.raises(ValueError):
        leaves.tree(8, CPU)


# ---------------------------------------------------------------------------
# EvalEnv over row windows
# ---------------------------------------------------------------------------

def test_eval_env_windows_equal_whole_columns(rng):
    """The quotient's constraints of the composite AIR (plookups, a
    permutation, shifted columns) over the smallest window, a window whose
    halo wraps at n_ext and the whole domain, against the unwindowed
    env, on seeded sections."""
    air = fixtures.composite_case("xlayer_prover_tpu_torch")[0]
    n_ext, blowup = air.n_ext, air.n_ext // air.n
    secs = {name: gl.from_u64_np(_field_rows(rng, n_ext, w), CPU)
            for name, w in (("const", air.const_width),
                            ("cm1", air.cm1_width), ("cm2", air.cm2_width),
                            ("cm3", air.cm3_width))}
    ch = {s: gl3.from_ints(*[int(v) for v in rng.integers(
        0, P, size=3, dtype=np.uint64)], CPU) for s in range(8)}
    pubs = [gl.from_u64_np(np.array(v, dtype=np.uint64), CPU)
            for v in rng.integers(0, P, size=air.n_publics, dtype=np.uint64)]
    x = gl.from_u64_np(rng.integers(0, P, size=n_ext, dtype=np.uint64), CPU)
    l1 = gl.from_u64_np(rng.integers(0, P, size=n_ext, dtype=np.uint64), CPU)
    constraints = air_mod.all_constraints(air)
    refs = count_refs(constraints)
    halo = halo_rows(constraints, blowup)
    assert halo == blowup           # shifts of one row
    whole = EvalEnv(secs, ch, pubs, x, l1, blowup, refcounts=refs)
    want = [gl3.stack_cols(tuple(t.expand(n_ext) for t in
                                 whole.eval_ext(c))) for c in constraints]
    for r0, rows in ((0, blowup), (n_ext - 64, 64), (0, n_ext)):
        win = {k: prover._rows_on(v, r0, rows + halo, CPU)
               for k, v in secs.items()}
        env = EvalEnv(win, ch, pubs, x[r0:r0 + rows], l1[r0:r0 + rows],
                      blowup, refcounts=refs, window=rows)
        for c, w in zip(constraints, want):
            got = gl3.stack_cols(tuple(t.expand(rows) for t in
                                       env.eval_ext(c)))
            assert torch.equal(got, w[r0:r0 + rows])
    short = {k: v[:64] for k, v in secs.items()}
    env = EvalEnv(short, ch, pubs, x[:64], l1[:64], blowup, window=64)
    with pytest.raises(ValueError):
        for c in constraints:
            env.eval_ext(c)


# ---------------------------------------------------------------------------
# The section plan the prover follows
# ---------------------------------------------------------------------------

def _chains_air(n_bits):
    """The widths of devnet batch 0 with the chains (669 / 600 / 999 /
    361, q_deg 2) at `n_bits`, as window_rows reads them."""
    return types.SimpleNamespace(
        n_bits=n_bits, n_bits_ext=n_bits + 1, n=1 << n_bits,
        n_ext=1 << (n_bits + 1), const_width=361, cm1_width=669,
        cm2_width=600, cm3_width=999, cm4_width=6, n_publics=44,
        n_queries=4, scheme="gl")


@pytest.mark.parametrize("n_bits,budget,stream,windows", [
    (18, H100_BYTES, False, 1), (18, 16 << 30, True, 2),
    (19, H100_BYTES, False, 1), (20, H100_BYTES, True, 1)])
def test_section_plan_and_windows(n_bits, budget, stream, windows):
    """The chains widths under an H100's memory and 16 GiB: resident or
    streamed, the quotient's windows, and round 5 in one window."""
    air = _chains_air(n_bits)
    sp = prover.section_plan(air, CPU, budget)
    assert sp.stream == stream
    assert sp.plan == stark_info.memory_plan(stark_info.info_from_air(air),
                                             1, budget)
    if stream:
        assert sp.block_cols == 64 and sp.plan["stream_block_cols"] > 64
    rows, rows5 = prover.window_rows(air, sp)
    assert (air.n_ext // rows, rows5) == (windows, air.n_ext)


def test_section_plan_default_budget_and_bn128():
    air = fib.build_air(n_bits=5, n_queries=8)
    assert prover.section_plan(air, CPU).budget == 16 << 30
    assert not prover.section_plan(air, CPU).stream
    air.scheme = "bn128"
    with pytest.raises(ValueError, match="12b"):
        prover.section_plan(air, CPU, 4096)
    const_np, _cm1, _pubs = fib.gen_trace(air)
    with pytest.raises(ValueError, match="12b"):
        prover.Setup.build(air, const_np, device="cpu", hbm_bytes=4096)


def test_devnet_geometry_follows_the_cascade_tool():
    for n_bits in (16, 18, 20):
        g = devnet.devnet_geometry(n_bits)
        assert g == {"n_bits": n_bits, "chunk_bits": 4, "limb_bits": 16,
                     "n_queries": 4, "max_steps": 1 << (n_bits - 1)}
    assert devnet.devnet_geometry(16) == devnet.DEVNET_GEOMETRY
    assert devnet.devnet_geometry(18) == devnet.DEVNET_CHAINS_GEOMETRY
