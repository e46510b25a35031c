"""Synthetic devnet: genesis builder, tx signer, witness + datastream
encoders, and the devnet batches built from them.

The port's own copy of ``xlayer_prover_tpu/utils/devnet.py`` (Keccak and
Poseidon are the port's host functions), with ``build_devnet_inputs``, the
port's copy of the builder in ``tools/run_a7_cascade.py``.

The reference consumes these artifacts but never produces them (the node
side does); producing them locally closes the loop for self-contained
end-to-end tests: build a genesis SMT with known accounts, sign real
EIP-155 transfers, encode the Erigon-style witness
(src/prover/witness.cpp opcode format) and the sequencer datastream
(src/prover/data_stream.cpp framing), then drive the FULL stateless path
(witness2db + dataStream2batch -> executor -> proof) without any
reference testvector.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

from ..state.database import MemoryDB
from ..state.datastream import _rlp_encode_list
from ..state.keys import (LEAF_BALANCE, LEAF_CODE, LEAF_CODE_LENGTH,
                          LEAF_NONCE, LEAF_STORAGE, key_for)
from ..state.smt import Smt, split_key
from .keccak import keccak256

Key = Tuple[int, int, int, int]

# secp256k1 domain
_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


# ---------------------------------------------------------------------------
# secp256k1 signing (host ints; the prover side verifies via the ROM's
# ecrecover semantics, so the signer is test-harness math, not a hot path)
# ---------------------------------------------------------------------------

def _ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % _P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, _P - 2, _P) % _P
    else:
        lam = (y2 - y1) * pow(x2 - x1, _P - 2, _P) % _P
    x3 = (lam * lam - x1 - x2) % _P
    return (x3, (lam * (x1 - x3) - y1) % _P)


def _ec_mul(k: int, point=( _GX, _GY)):
    acc = None
    add = point
    while k:
        if k & 1:
            acc = _ec_add(acc, add)
        add = _ec_add(add, add)
        k >>= 1
    return acc


def address_of(priv: int) -> int:
    """Ethereum address of a private key."""
    x, y = _ec_mul(priv % _N)
    pub = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return int.from_bytes(keccak256(pub)[12:], "big")


def _sign(digest32: bytes, priv: int, k: int):
    """ECDSA over secp256k1 with caller-provided nonce k (deterministic
    tests); returns (r, s, y_parity) with low-s normalization."""
    z = int.from_bytes(digest32, "big")
    while True:
        k = k % _N or 1
        pt = _ec_mul(k)
        r = pt[0] % _N
        s = pow(k, _N - 2, _N) * (z + r * priv) % _N
        if r == 0 or s == 0:
            k += 1
            continue
        parity = pt[1] & 1
        if s > _N // 2:
            s = _N - s
            parity ^= 1
        return r, s, parity


def _int_rlp(v: int) -> bytes:
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def sign_legacy_tx(*, nonce: int, gas_price: int, gas: int,
                   to: Optional[int], value: int, data: bytes,
                   chain_id: int, priv: int, k: int = 0x1234) -> bytes:
    """EIP-155 signed legacy transaction RLP (the 9-field encoding the
    datastream carries and transcode_tx re-encodes for the ROM)."""
    to_b = b"" if to is None else int(to).to_bytes(20, "big")
    unsigned = [_int_rlp(nonce), _int_rlp(gas_price), _int_rlp(gas),
                to_b, _int_rlp(value), bytes(data),
                _int_rlp(chain_id), b"", b""]
    digest = keccak256(_rlp_encode_list(unsigned))
    r, s, parity = _sign(digest, priv, k)
    v = chain_id * 2 + 35 + parity
    signed = [_int_rlp(nonce), _int_rlp(gas_price), _int_rlp(gas),
              to_b, _int_rlp(value), bytes(data),
              _int_rlp(v), _int_rlp(r), _int_rlp(s)]
    return _rlp_encode_list(signed)


# ---------------------------------------------------------------------------
# Genesis SMT with recorded leaf preimages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Account:
    address: int
    balance: int = 0
    nonce: int = 0
    code: bytes = b""
    storage: Dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Genesis:
    root: Key
    db: MemoryDB
    # leaf node hash -> (node_type, address, storage_key, value, code)
    preimages: Dict[Key, tuple]
    programs: Dict[Key, bytes]


def build_genesis(accounts: List[Account]) -> Genesis:
    """Writes every account leaf into a fresh SMT, recording the
    (type, address, storageKey, value) preimage per leaf so the witness
    encoder can emit SMT_LEAF opcodes."""
    from ..state.witness import _linear_hash_bytes
    db = MemoryDB()
    smt = Smt(db)
    root = (0, 0, 0, 0)
    leaves = []          # (key, type, address, skey, value, code)
    programs: Dict[Key, bytes] = {}
    for acc in accounts:
        if acc.balance:
            leaves.append((key_for(acc.address, LEAF_BALANCE),
                           LEAF_BALANCE, acc.address, 0, acc.balance, b""))
        if acc.nonce:
            leaves.append((key_for(acc.address, LEAF_NONCE),
                           LEAF_NONCE, acc.address, 0, acc.nonce, b""))
        if acc.code:
            code_hash4 = _linear_hash_bytes(acc.code)
            code_scalar = 0
            for i, limb in enumerate(code_hash4):
                code_scalar |= int(limb) << (64 * i)
            programs[tuple(code_hash4)] = bytes(acc.code)
            leaves.append((key_for(acc.address, LEAF_CODE),
                           LEAF_CODE, acc.address, 0, code_scalar,
                           bytes(acc.code)))
            leaves.append((key_for(acc.address, LEAF_CODE_LENGTH),
                           LEAF_CODE_LENGTH, acc.address, 0, len(acc.code),
                           b""))
        for skey, sval in acc.storage.items():
            if sval:
                leaves.append((key_for(acc.address, LEAF_STORAGE, skey),
                               LEAF_STORAGE, acc.address, skey, sval, b""))
    for (key, ltype, addr, skey, value, code) in leaves:
        root = smt.set(root, key, value).new_root
    # map leaf node hashes -> preimages by walking each key
    preimages: Dict[Key, tuple] = {}
    for (key, ltype, addr, skey, value, code) in leaves:
        h = _leaf_hash_of(smt, root, key)
        preimages[h] = (ltype, addr, skey, value, code)
    return Genesis(root=tuple(root), db=db, preimages=preimages,
                   programs=programs)


def _leaf_hash_of(smt: Smt, root, key) -> Key:
    bits = split_key(key)
    r = tuple(int(v) for v in root)
    level = 0
    while True:
        node = smt._read(r)
        if node[8] == 1:
            return r
        r = tuple(node[4:8]) if bits[level] else tuple(node[0:4])
        level += 1


# ---------------------------------------------------------------------------
# Witness encoder (inverse of state/witness.witness2db)
# ---------------------------------------------------------------------------

def _cbor_uint(v: int) -> bytes:
    if v < 24:
        return bytes([v])
    if v < 256:
        return bytes([24, v])
    if v < 65536:
        return bytes([25]) + v.to_bytes(2, "big")
    if v < (1 << 32):
        return bytes([26]) + v.to_bytes(4, "big")
    return bytes([27]) + v.to_bytes(8, "big")


def _cbor_bytes(b: bytes) -> bytes:
    n = len(b)
    if n < 24:
        return bytes([0x40 + n]) + b
    if n < 256:
        return bytes([0x58, n]) + b
    return bytes([0x59]) + n.to_bytes(2, "big") + b


def _cbor_scalar(v: int) -> bytes:
    if v < 24:
        return _cbor_uint(v)
    return _cbor_bytes(v.to_bytes((v.bit_length() + 7) // 8, "big"))


def encode_witness(genesis: Genesis) -> bytes:
    """Genesis -> Erigon-style witness byte stream (version 1): BRANCH
    masks + SMT_LEAF (+CODE) opcodes, decodable by witness2db back to the
    exact node map and state root."""
    out = bytearray([1])

    def emit(node_hash: Key):
        node = genesis.db.read(node_hash)
        assert node is not None, f"dangling node {node_hash}"
        if node[8] == 1:              # leaf
            ltype, addr, skey, value, code = genesis.preimages[
                tuple(node_hash)]
            if code:
                out.append(0x04)
                out.extend(_cbor_bytes(code))
            out.append(0x07)
            out.append(ltype)
            out.extend(_cbor_scalar(addr))
            if ltype == LEAF_STORAGE:
                out.extend(_cbor_scalar(skey))
            out.extend(_cbor_scalar(value))
            return
        left = tuple(node[0:4])
        right = tuple(node[4:8])
        mask = (1 if left != (0, 0, 0, 0) else 0) \
            | (2 if right != (0, 0, 0, 0) else 0)
        out.append(0x02)
        out.extend(_cbor_uint(mask))
        if mask & 1:
            emit(left)
        if mask & 2:
            emit(right)

    emit(genesis.root)
    return bytes(out)


# ---------------------------------------------------------------------------
# Datastream encoder (inverse of state/datastream.datastream2batch)
# ---------------------------------------------------------------------------

def _entry(packet_type: int, entry_type: int, entry_num: int,
           body: bytes) -> bytes:
    return bytes([packet_type]) + struct.pack(">I", 17 + len(body)) \
        + struct.pack(">I", entry_type) + struct.pack(">Q", entry_num) \
        + body


def encode_datastream(*, batch_number: int, chain_id: int, fork_id: int,
                      coinbase: int, blocks: List[dict]) -> bytes:
    """blocks: [{"block_number", "timestamp", "delta_timestamp",
    "l1_info_tree_index", "txs": [encoded_tx bytes | (tx, gas_pct)]}]
    -> sequencer datastream bytes (start-block / tx / end-block entries)."""
    out = bytearray()
    entry_num = 1
    for blk in blocks:
        body = struct.pack(">QQQ", batch_number, blk["block_number"],
                           blk["timestamp"])
        body += struct.pack(">II", blk.get("delta_timestamp", 0),
                            blk.get("l1_info_tree_index", 0))
        body += blk.get("l1_block_hash", b"\x00" * 32)
        body += blk.get("global_exit_root", b"\x00" * 32)
        body += int(coinbase).to_bytes(20, "big")
        body += struct.pack(">H", fork_id)
        body += struct.pack(">I", chain_id)
        assert len(body) == 122
        out += _entry(2, 1, entry_num, body)
        entry_num += 1
        for tx in blk["txs"]:
            gas_pct = 255
            if isinstance(tx, tuple):
                tx, gas_pct = tx
            body = bytes([gas_pct, 1]) + b"\x00" * 32 \
                + struct.pack(">I", len(tx)) + tx
            out += _entry(2, 2, entry_num, body)
            entry_num += 1
        body = struct.pack(">Q", blk["block_number"]) \
            + blk.get("l2_block_hash", b"\x00" * 32) \
            + blk.get("state_root", b"\x00" * 32)
        out += _entry(2, 3, entry_num, body)
        entry_num += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# Devnet batches (the port's copy of tools/run_a7_cascade.py
# build_devnet_inputs)
# ---------------------------------------------------------------------------

DEVNET_CHAIN_ID = 1001
DEVNET_PRIV1, DEVNET_PRIV2 = 0xA11CE, 0xB0B
def devnet_geometry(n_bits: int, n_queries: int = 4) -> dict:
    """The devnet BatchProver's geometry at `n_bits`, as
    tools/run_a7_cascade.py:236-239 makes it: chunk_bits 4, limb_bits 16,
    max_steps 2^(n_bits - 1)."""
    return {"n_bits": n_bits, "chunk_bits": 4, "limb_bits": 16,
            "n_queries": n_queries, "max_steps": 1 << (n_bits - 1)}


# the JAX package's devnet geometry (the tool with --n-bits 16
# --n-queries 4)
DEVNET_GEOMETRY = devnet_geometry(16)
# the same tool with --n-bits 18 --n-queries 4: the smallest geometry at
# which the Keccak-F and SHA-256-F chains are on (one gate slot each)
DEVNET_CHAINS_GEOMETRY = devnet_geometry(18)


def devnet_prover(device=None, geometry=None):
    """The BatchProver of the devnet batches: the fork_9 ROM with the
    Storage SM at `geometry` (None: ``DEVNET_GEOMETRY``), proving on
    `device` (None: the GPU)."""
    from ..executor.rom import Rom
    from ..executor.storage_rom import StorageRom
    from ..prover_service import BatchProver
    return BatchProver(Rom.load_fork(9), **(geometry or DEVNET_GEOMETRY),
                       storage_rom=StorageRom.load_default(), device=device)


def _devnet_genesis() -> Genesis:
    """The devnet's genesis: account 1 with 10^18 wei, account 2 with 5."""
    return build_genesis([Account(address=address_of(DEVNET_PRIV1),
                                  balance=10 ** 18),
                          Account(address=address_of(DEVNET_PRIV2),
                                  balance=5)])


def _devnet_datastream(k: int, chain_id: int) -> bytes:
    """The sequencer datastream of devnet batch k: one block holding one
    signed legacy transfer of 1000 + k wei from account 1 to account 2 at
    nonce k, coinbase account 2."""
    a2 = address_of(DEVNET_PRIV2)
    tx = sign_legacy_tx(nonce=k, gas_price=10 ** 9, gas=21000, to=a2,
                        value=1000 + k, data=b"", chain_id=chain_id,
                        priv=DEVNET_PRIV1)
    return encode_datastream(
        batch_number=k + 1, chain_id=chain_id, fork_id=9, coinbase=a2,
        blocks=[{"block_number": k + 1, "timestamp": 100 * (k + 1),
                 "delta_timestamp": 100, "l1_info_tree_index": 0,
                 "txs": [tx]}])


def devnet_stateless_batch0(chain_id: int = DEVNET_CHAIN_ID) -> dict:
    """Devnet batch 0 as a stateless request carries it (the public inputs
    of GenStatelessBatchProof / ProcessStatelessBatchV2): the genesis
    witness blob, the datastream, the sequencer address (hex) and the
    timestamp limit.  Decoded, it is ``build_devnet_inputs(...)[0]``."""
    return {"witness": encode_witness(_devnet_genesis()),
            "data_stream": _devnet_datastream(0, chain_id),
            "sequencer_addr": f"0x{address_of(DEVNET_PRIV2):040x}",
            "timestamp_limit": 200}


# the context ids (batch UUIDs) of devnet batch 0's executor requests
DEVNET0_CONTEXT_IDS = ("devnet0-stateless", "devnet0-batch")


def devnet0_executor_requests():
    """Devnet batch 0 as the executor service takes it: a
    ProcessStatelessBatchV2 request (the genesis witness and the
    datastream) and a ProcessBatchV2 request of the same batch, whose
    pre-state the service's HashDB holds once the stateless request has
    run.  -> (stateless request, ProcessBatchV2 request)"""
    from ..services.gen import executor_pb2 as pb
    sb = devnet_stateless_batch0()
    inp = build_devnet_inputs(None, 1)[0]
    stateless = pb.ProcessStatelessBatchRequestV2(
        witness=sb["witness"], data_stream=sb["data_stream"],
        coinbase=sb["sequencer_addr"],
        timestamp_limit=sb["timestamp_limit"],
        context_id=DEVNET0_CONTEXT_IDS[0])
    batch = pb.ProcessBatchRequestV2(
        old_state_root=inp.old_state_root.to_bytes(32, "big"),
        old_acc_input_hash=inp.old_acc_input_hash.to_bytes(32, "big"),
        old_batch_num=inp.old_batch_num, chain_id=inp.chain_id,
        fork_id=inp.fork_id, batch_l2_data=inp.batch_l2_data,
        coinbase=sb["sequencer_addr"], timestamp_limit=inp.timestamp_limit,
        context_id=DEVNET0_CONTEXT_IDS[1])
    return stateless, batch


def input_json(inp) -> dict:
    """A ``BatchInput`` in the reference's input-file format (the one
    ``BatchInput.load`` reads): hex scalars, the pre-state nodes under
    "db" (key: the 64-hex node hash, limb j at bits [64j, 64j + 64);
    value: 12 limbs of 16 hex digits) and the bytecode under
    "contractsBytecode"."""
    def hexkey(quad):
        return "".join(f"{int(v):016x}" for v in reversed(quad))

    db = {hexkey(k): [f"{int(x):016x}" for x in v]
          for k, v in inp.db_raw.items()}
    db.update(inp.db)
    code = {hexkey(k): "0x" + bytes(v).hex()
            for k, v in inp.programs_raw.items()}
    code.update(inp.contracts_bytecode)
    return {"oldStateRoot": f"0x{inp.old_state_root:064x}",
            "oldAccInputHash": f"0x{inp.old_acc_input_hash:064x}",
            "oldNumBatch": inp.old_batch_num,
            "chainID": inp.chain_id,
            "forkID": inp.fork_id,
            "batchL2Data": "0x" + inp.batch_l2_data.hex(),
            "sequencerAddr": f"0x{inp.sequencer_addr:040x}",
            "timestampLimit": str(inp.timestamp_limit),
            "l1InfoRoot": f"0x{inp.l1_info_root:064x}",
            "forcedBlockHashL1": f"0x{inp.forced_blockhash_l1:064x}",
            "db": db,
            "contractsBytecode": code}


def build_devnet_inputs(engine, n_batches: int,
                        chain_id: int = DEVNET_CHAIN_ID):
    """n chained batches through the fork_9 ROM: batch k carries one
    signed legacy transfer of 1000 + k wei from account 1 to account 2 at
    nonce k, and each input's pre-state is the post-state of batch k-1
    (so newStateRoot_k == oldStateRoot_{k+1}).  Batch k-1 is executed by
    `engine` (a ``BatchProver``) to chain batch k; batch 0 needs no
    execution.  Deterministic.  -> [BatchInput]"""
    from ..executor.input import BatchInput
    from ..state.datastream import batch_to_l2_data, datastream2batch
    from ..state.witness import witness2db

    a2 = address_of(DEVNET_PRIV2)
    wres = witness2db(encode_witness(_devnet_genesis()))
    nodes = {k: list(v) for k, v in wres.db.items()}
    programs = {k: bytes(v) for k, v in wres.programs.items()}
    state_root = wres.state_root
    acc_hash = 0
    inputs = []
    for k in range(n_batches):
        batch = datastream2batch(_devnet_datastream(k, chain_id))
        inp = BatchInput(old_state_root=state_root,
                         old_acc_input_hash=acc_hash, old_batch_num=k,
                         chain_id=chain_id, fork_id=9,
                         batch_l2_data=batch_to_l2_data(batch),
                         sequencer_addr=a2,
                         timestamp_limit=200 * (k + 1))
        inp.db_raw = dict(nodes)
        inp.programs_raw = dict(programs)
        inputs.append(inp)
        # execute batch k to chain batch k+1's pre-state
        if k + 1 < n_batches:
            res = engine.execute_only(inp, batch_uuid=f"plan-{k}")
            pub = [int(p) for p in res.publics]
            state_root = 0
            acc_hash = 0
            for i in range(8):
                state_root |= pub[19 + i] << (32 * i)
                acc_hash |= pub[27 + i] << (32 * i)
            store = res.ctx.hashdb.batches.get(f"plan-{k}")
            if store is not None:
                for kq, v in store.overlay.items():
                    nodes[kq] = list(v)
                for kq, d in store.programs.items():
                    programs[kq] = bytes(d)
    return inputs
