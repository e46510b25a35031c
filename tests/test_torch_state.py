"""Port parity: the state layer of xlayer_prover_tpu_torch (``state/``:
SMT keys, the sparse Merkle tree, the witness and datastream decoders) and
the devnet encoders (``utils/devnet.py``) against the JAX package's, on
inputs made from a seed with numpy.  Exact equality."""

import numpy as np
import pytest

from xlayer_prover_tpu.state import database as jdatabase
from xlayer_prover_tpu.state import datastream as jdatastream
from xlayer_prover_tpu.state import keys as jkeys
from xlayer_prover_tpu.state import smt as jsmt
from xlayer_prover_tpu.state import witness as jwitness
from xlayer_prover_tpu.utils import devnet as jdevnet
from xlayer_prover_tpu_torch.state import (database, datastream, hashdb,
                                           keys, smt, witness)
from xlayer_prover_tpu_torch.utils import devnet

from tests.torch_cpu import one_torch_thread  # noqa: F401

P = smt.P
SET_FIELDS = ("old_root", "new_root", "key", "siblings", "ins_key",
              "ins_value", "is_old0", "old_value", "new_value", "mode",
              "proof_hash_counter", "sibling_left_child",
              "sibling_right_child")
GET_FIELDS = ("root", "key", "value", "found", "siblings", "ins_key",
              "ins_value", "is_old0", "proof_hash_counter")
# the modes Smt.set gives; the ROM's seventh, deleteLast, is a legacy
# label that the reference never produces: deleting the root leaf gives
# deleteNotFound and an empty tree (smt.cpp:719-729)
MODES = {"insertNotFound", "insertFound", "update", "zeroToZero",
         "deleteFound", "deleteNotFound"}


def _fields(res, names):
    return {n: getattr(res, n) for n in names}


@pytest.mark.parametrize("seed", [1, 2])
def test_key_for_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        addr = int.from_bytes(rng.bytes(20), "big")
        slot = int.from_bytes(rng.bytes(32), "big")
        for leaf in range(5):
            assert keys.key_for(addr, leaf, slot) == \
                jkeys.key_for(addr, leaf, slot)
    assert keys.balance_key(addr) == jkeys.balance_key(addr)
    assert keys.storage_key(addr, slot) == jkeys.storage_key(addr, slot)


def test_key_helpers_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        key = tuple(int(v) for v in rng.integers(0, P, 4, dtype=np.uint64))
        n = int(rng.integers(0, 256))
        assert smt.split_key(key) == jsmt.split_key(key)
        assert smt.remove_key_bits(key, n) == jsmt.remove_key_bits(key, n)
        value = int.from_bytes(rng.bytes(32), "big")
        assert smt.value_to_fea8(value) == jsmt.value_to_fea8(value)
        assert smt.fea8_to_value(smt.value_to_fea8(value)) == value


@pytest.mark.parametrize("seed", [11, 12])
def test_smt_sequences_match_jax(seed):
    """A seeded random get/set sequence over a pool of 12 keys (values 0
    a third of the time): every result, siblings included, and every
    root equal the JAX package's; the sequence reaches every mode, and
    the last key's deletion empties the tree in both."""
    rng = np.random.default_rng(seed)
    pool = [tuple(int(v) for v in rng.integers(0, P, 4, dtype=np.uint64))
            for _ in range(12)]
    tree, jtree = smt.Smt(database.MemoryDB()), jsmt.Smt(jdatabase.MemoryDB())
    root = jroot = (0, 0, 0, 0)
    modes = set()
    for step in range(150):
        key = pool[int(rng.integers(0, len(pool)))]
        if rng.random() < 0.2:
            got, want = tree.get(root, key), jtree.get(jroot, key)
            assert _fields(got, GET_FIELDS) == _fields(want, GET_FIELDS)
            continue
        value = 0 if rng.random() < 0.33 else \
            int.from_bytes(rng.bytes(int(rng.integers(1, 33))), "big")
        got, want = tree.set(root, key, value), jtree.set(jroot, key, value)
        assert _fields(got, SET_FIELDS) == _fields(want, SET_FIELDS), step
        root, jroot = got.new_root, want.new_root
        modes.add(got.mode)
    assert modes == MODES
    # delete what is left: the last deletion leaves the empty tree
    for key in pool:
        got, want = tree.set(root, key, 0), jtree.set(jroot, key, 0)
        assert _fields(got, SET_FIELDS) == _fields(want, SET_FIELDS)
        root, jroot = got.new_root, want.new_root
    assert root == (0, 0, 0, 0) and got.mode in MODES


def test_hashdb_overlay():
    """Writes of a batch stay in its overlay, over the base store: a
    second batch and the base do not see them."""
    db = hashdb.HashDB()
    key = keys.balance_key(0xABC)
    base = db.set(None, (0, 0, 0, 0), key, 5).new_root
    nodes = dict(db.db.nodes)
    res = db.set("b", base, key, 7)
    assert db.get("b", res.new_root, key).value == 7
    assert db.get("b", base, key).value == 5
    assert db.db.nodes == nodes and db.batches["b"].overlay
    with pytest.raises(KeyError):
        db.get("c", res.new_root, key)
    assert db.get(None, base, key).value == 5


def _genesis(pkg):
    code = bytes(range(1, 64))
    return pkg.build_genesis([
        pkg.Account(address=pkg.address_of(0xA11CE), balance=10 ** 18),
        pkg.Account(address=pkg.address_of(0xB0B), balance=5),
        pkg.Account(address=pkg.address_of(0xC0DE), balance=7, nonce=3,
                    code=code, storage={0x01: 0xBEEF, 0x02: 0})])


def test_witness2db_matches_jax():
    """The genesis of both packages' devnet encoders gives the same witness
    bytes, and witness2db decodes them into the same nodes, programs and
    state root."""
    g, jg = _genesis(devnet), _genesis(jdevnet)
    assert g.root == jg.root and g.db.nodes == jg.db.nodes
    w = devnet.encode_witness(g)
    assert w == jdevnet.encode_witness(jg)
    res, jres = witness.witness2db(w), jwitness.witness2db(w)
    assert res.root4 == jres.root4 == g.root
    assert res.state_root == jres.state_root
    assert res.db == jres.db
    assert res.programs == jres.programs and len(res.programs) == 1


def test_datastream2batch_matches_jax():
    """A signed EIP-155 transfer in a two-block datastream: the same tx
    bytes, stream bytes, decoded batch and batchL2Data."""
    a2 = devnet.address_of(0xB0B)
    blocks, jblocks = [], []
    for k, mod in enumerate((devnet, jdevnet)):
        txs = [mod.sign_legacy_tx(nonce=n, gas_price=10 ** 9, gas=21000,
                                  to=a2, value=1000 + n, data=b"\x01" * n,
                                  chain_id=1001, priv=0xA11CE)
               for n in range(3)]
        (blocks if k == 0 else jblocks).append(txs)
    assert blocks == jblocks
    spec = [{"block_number": 1, "timestamp": 100, "delta_timestamp": 100,
             "l1_info_tree_index": 0, "txs": blocks[0][:2]},
            {"block_number": 2, "timestamp": 200, "delta_timestamp": 100,
             "l1_info_tree_index": 3, "txs": [(blocks[0][2], 128)]}]
    ds = devnet.encode_datastream(batch_number=4, chain_id=1001, fork_id=9,
                                  coinbase=a2, blocks=spec)
    assert ds == jdevnet.encode_datastream(batch_number=4, chain_id=1001,
                                           fork_id=9, coinbase=a2,
                                           blocks=spec)
    batch, jbatch = datastream.datastream2batch(ds), \
        jdatastream.datastream2batch(ds)
    assert batch.total_txs() == 3
    assert (batch.batch_number, batch.fork_id, batch.chain_id) == \
        (jbatch.batch_number, jbatch.fork_id, jbatch.chain_id)
    for blk, jblk in zip(batch.blocks, jbatch.blocks, strict=True):
        assert vars(blk).keys() == vars(jblk).keys()
        for name in vars(blk):
            if name != "txs":
                assert getattr(blk, name) == getattr(jblk, name)
        assert [vars(t) for t in blk.txs] == [vars(t) for t in jblk.txs]
    assert datastream.batch_to_l2_data(batch) == \
        jdatastream.batch_to_l2_data(jbatch)
