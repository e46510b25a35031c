"""Port parity: the zkEVM composite AIR (Main + Binary, Memory, Arith,
PoseidonG, PaddingPG, MemAlign and ArithEC, and Storage and ClimbKey with a
storage ROM) built by xlayer_prover_tpu_torch from the mini-ROM equals the
JAX package's, at the mini-ROM test geometry (n_bits 13, chunk_bits 2,
limb_bits 8) and at the devnet geometry (n_bits 16, chunk_bits 4,
limb_bits 16): column names and indices, section widths, every
constraint, plookup and permutation, the im columns and the evaluation
map.  Exact equality."""

import hashlib

import numpy as np
import pytest

from xlayer_prover_tpu.executor.storage_rom import StorageRom as JStorageRom
from xlayer_prover_tpu.models.zkevm import zkevm_air as jzkevm_air
from xlayer_prover_tpu_torch.executor.storage_rom import StorageRom
from xlayer_prover_tpu_torch.models.zkevm import zkevm_air
from xlayer_prover_tpu_torch.models.zkevm.mini_rom import mini_rom

from tests.test_zkevm_proof import mini_rom as jmini_rom
from tests.torch_cpu import one_torch_thread  # noqa: F401

GEOMETRIES = [(13, 2, 8), (16, 4, 16)]


def _digest(e, memo):
    """A content digest of an expression DAG (node class, fields and the
    children's digests), memoized by node so shared subtrees cost once."""
    hit = memo.get(id(e))
    if hit is not None:
        return hit[1]
    kind = type(e).__name__
    if kind == "BinOp":
        body = (e.op, _digest(e.a, memo), _digest(e.b, memo))
    elif kind == "Col":
        body = (e.section, e.index, e.dim, int(e.shift), e.name)
    elif kind == "Const":
        body = (e.value,)
    elif kind in ("Challenge", "Public"):
        body = (e.index,)
    else:
        body = ()
    d = hashlib.sha256(repr((kind, body)).encode()).hexdigest()
    memo[id(e)] = (e, d)
    return d


def air_ir(air, groups):
    """The IR of `air` with the fixed and witness columns of each layout
    in `groups` (name -> layout), as comparable values."""
    memo = {}

    def dg(e):
        return _digest(e, memo)

    cols = {name: {part: {k: (c.section, c.index, c.name)
                          for k, c in getattr(g, part).items()}
                   for part in ("fixed", "witness")}
            for name, g in groups.items()}
    return {
        "geometry": (air.n_bits, air.n_bits_ext, air.n_queries,
                     air.fri_steps, air.q_deg, air.n_publics,
                     air.publics_map),
        "widths": (air.const_width, air.cm1_width, air.cm2_width,
                   air.cm3_width),
        "columns": cols,
        "constraints": [dg(c) for c in air.constraints],
        "plookups": [(dg(p.f_exp), dg(p.t_exp), dg(p.h1_col), dg(p.h2_col),
                      dg(p.z_col)) for p in air.plookups],
        "permutations": [(dg(p.f_exp), dg(p.t_exp), dg(p.z_col))
                         for p in air.permutations],
        "connections": len(air.connections),
        "im_defs": [(dg(c), dg(e)) for c, e in air.im_defs],
        "ev_map": [(e.section, e.index, e.dim, e.shift) for e in air.ev_map],
    }


GROUPS = ("main", "binary", "memory", "arith", "poseidon", "padding_pg",
          "mem_align", "arith_ec", "storage", "climb_key")


def _ir(air, layout):
    return air_ir(air, {name: getattr(layout, name) for name in GROUPS
                        if getattr(layout, name, None) is not None})


@pytest.mark.parametrize("n_bits,chunk_bits,limb_bits", GEOMETRIES)
def test_composite_air_matches_jax(n_bits, chunk_bits, limb_bits):
    air, layout = zkevm_air.build(mini_rom(), n_bits=n_bits,
                                  chunk_bits=chunk_bits, limb_bits=limb_bits,
                                  n_queries=4)
    jair, jlayout = jzkevm_air.build(jmini_rom(), n_bits=n_bits,
                                     chunk_bits=chunk_bits,
                                     limb_bits=limb_bits, n_queries=4)
    ir, jir = _ir(air, layout), _ir(jair, jlayout)
    for key in ir:
        assert ir[key] == jir[key], key
    # the circuit's size at both geometries
    assert ir["widths"] == (181, 412, 300, 414)
    assert (len(air.plookups), len(air.permutations)) == (50, 1)


@pytest.mark.parametrize("n_bits,chunk_bits,limb_bits", GEOMETRIES)
def test_fixed_columns_match_jax(n_bits, chunk_bits, limb_bits):
    """fill_fixed gives the JAX package's constant polynomials."""
    air, layout = zkevm_air.build(mini_rom(), n_bits=n_bits,
                                  chunk_bits=chunk_bits, limb_bits=limb_bits,
                                  n_queries=4)
    jair, jlayout = jzkevm_air.build(jmini_rom(), n_bits=n_bits,
                                     chunk_bits=chunk_bits,
                                     limb_bits=limb_bits, n_queries=4)
    assert np.array_equal(zkevm_air.fill_fixed(air, layout),
                          jzkevm_air.fill_fixed(jair, jlayout))


def test_storage_air_matches_jax():
    """With a storage_rom, the mini-ROM's composite gains the Storage and
    ClimbKey SMs, their bindings and the Main sRD/sWR latch lookups: equal
    to the JAX package's at (13, 2, 8), constant polynomials included."""
    kw = dict(n_bits=13, chunk_bits=2, limb_bits=8, n_queries=4)
    air, layout = zkevm_air.build(
        mini_rom(), storage_rom=StorageRom.load_default(), **kw)
    jair, jlayout = jzkevm_air.build(
        jmini_rom(), storage_rom=JStorageRom.load_default(), **kw)
    ir, jir = _ir(air, layout), _ir(jair, jlayout)
    for key in ir:
        assert ir[key] == jir[key], key
    assert ir["widths"][1] > 412 and len(air.plookups) > 50
    assert np.array_equal(zkevm_air.fill_fixed(air, layout),
                          jzkevm_air.fill_fixed(jair, jlayout))


def chains_groups(layout):
    """Group name -> layout of ``GROUPS`` and of the Keccak and SHA-256
    chains: each chain's bit region, its padding SM and its gate SM."""
    groups = {name: getattr(layout, name) for name in GROUPS
              if getattr(layout, name, None) is not None}
    for name, pad in (("keccak", "kk"), ("sha", "ps")):
        chain = getattr(layout, name, None)
        if chain is not None:
            groups.update({name: chain, f"{name}.{pad}": getattr(chain, pad),
                           f"{name}.gate": chain.gate})
    return groups


def chains_ir(air, layout):
    """``_ir`` with the chains' column groups (``chains_groups``)."""
    return air_ir(air, chains_groups(layout))


@pytest.mark.parametrize("kw", [{"n_bits": 18},
                                {"n_bits": 13, "with_keccak": True},
                                {"n_bits": 13, "with_sha": True}],
                         ids=["n_bits18", "keccak", "sha"])
def test_unported_state_machines_raise(kw):
    """The Keccak-F and SHA-256-F chains, on by default from n_bits 18:
    there the mini-ROM's composite IR equals the JAX package's; below it
    a chain's gate slot does not fit, and the port raises the JAX
    package's AssertionError with its message."""
    if kw["n_bits"] == 18:
        air, layout = zkevm_air.build(mini_rom(), n_queries=4, **kw)
        jair, jlayout = jzkevm_air.build(jmini_rom(), n_queries=4, **kw)
        assert layout.keccak.n_slots == layout.sha.n_slots == 1
        ir, jir = chains_ir(air, layout), chains_ir(jair, jlayout)
        for key in ir:
            assert ir[key] == jir[key], key
        return
    with pytest.raises(AssertionError) as err:
        zkevm_air.build(mini_rom(), **kw)
    with pytest.raises(AssertionError) as jerr:
        jzkevm_air.build(jmini_rom(), **kw)
    assert str(err.value) == str(jerr.value)
    assert "needs 2^13" in str(err.value)
