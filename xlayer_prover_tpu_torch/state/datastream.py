"""Sequencer datastream decoder (stateless proving input).

The port's own copy of ``xlayer_prover_tpu/state/datastream.py``.

Equivalent of the reference dataStream2batch (src/prover/data_stream.cpp):
the stream is a sequence of FileEntry packets
  u8 packetType (2 = data, 0 = padding) | u32 length | u32 entryType |
  u64 number | u8[length-17] data
with entry types 0xb0 bookmark (skipped), 1 start-L2-block (batchNum,
blockNum, timestamp, deltaTimestamp, l1InfoTreeIndex, l1BlockHash,
globalExitRoot, coinbase, forkId, chainId — 122 bytes), 2 L2-tx
(gasPricePercentage, isValid, stateRoot, length-prefixed RLP tx) and
3 end-L2-block (blockNum, l2BlockHash, stateRoot — 72 bytes).
The result feeds batchL2Data re-encoding for stateless batch proving.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

from ..utils.zkresult import ZkError, ZkResult


@dataclasses.dataclass
class DataStreamTx:
    gas_price_percentage: int
    is_valid: int
    state_root: bytes
    encoded_tx: bytes


@dataclasses.dataclass
class DataStreamBlock:
    block_number: int
    timestamp: int
    delta_timestamp: int
    l1_info_tree_index: int
    l1_block_hash: bytes
    global_exit_root: bytes
    coinbase: bytes
    txs: List[DataStreamTx] = dataclasses.field(default_factory=list)
    l2_block_hash: bytes = b""
    state_root: bytes = b""


@dataclasses.dataclass
class DataStreamBatch:
    batch_number: int = 0
    fork_id: int = 0
    chain_id: int = 0
    blocks: List[DataStreamBlock] = dataclasses.field(default_factory=list)

    def total_txs(self):
        return sum(len(b.txs) for b in self.blocks)


def _err(msg):
    raise ZkError(ZkResult.INVALID_INPUT, f"datastream: {msg}")


def datastream2batch(data: bytes) -> DataStreamBatch:
    batch = DataStreamBatch()
    p = 0
    n = len(data)
    while p < n:
        packet_type = data[p]
        p += 1
        if p + 4 > n:
            _err("truncated length")
        (length,) = struct.unpack_from(">I", data, p)
        p += 4
        if length < 17:
            _err(f"length {length} < 17")
        if p + 4 > n:
            _err("truncated entry type")
        (entry_type,) = struct.unpack_from(">I", data, p)
        p += 4
        if p + 8 > n:
            _err("truncated entry number")
        p += 8  # entry number (sequential, unused here)
        data_len = length - 17
        if p + data_len > n:
            _err("truncated entry data")
        body = data[p:p + data_len]
        p += data_len

        if packet_type == 0:
            continue
        if packet_type != 2:
            _err(f"unsupported packet type {packet_type}")
        if entry_type == 0xB0:      # bookmark
            continue
        if entry_type == 1:         # start L2 block
            if data_len != 122:
                _err(f"start-block data length {data_len} != 122")
            (batch_num, block_num, timestamp) = struct.unpack_from(
                ">QQQ", body, 0)
            (delta_ts, l1_index) = struct.unpack_from(">II", body, 24)
            l1_block_hash = body[32:64]
            ger = body[64:96]
            coinbase = body[96:116]
            (fork_id,) = struct.unpack_from(">H", body, 116)
            (chain_id,) = struct.unpack_from(">I", body, 118)
            if batch_num == 0:
                _err("batchNumber == 0")
            if batch.batch_number == 0:
                batch.batch_number = batch_num
                batch.fork_id = fork_id
                batch.chain_id = chain_id
            else:
                if batch_num != batch.batch_number:
                    _err("batch number mismatch")
                if fork_id != batch.fork_id:
                    _err("fork id mismatch")
                if chain_id != batch.chain_id:
                    _err("chain id mismatch")
            if batch.blocks and not batch.blocks[-1].l2_block_hash:
                _err("start block while previous block open")
            batch.blocks.append(DataStreamBlock(
                block_number=block_num, timestamp=timestamp,
                delta_timestamp=delta_ts, l1_info_tree_index=l1_index,
                l1_block_hash=l1_block_hash, global_exit_root=ger,
                coinbase=coinbase))
            continue
        if entry_type == 2:         # L2 tx
            if data_len < 38:
                _err("tx entry too short")
            if not batch.blocks or batch.blocks[-1].l2_block_hash:
                _err("tx outside an open block")
            gas_pct = body[0]
            is_valid = body[1]
            state_root = body[2:34]
            (tx_len,) = struct.unpack_from(">I", body, 34)
            if 38 + tx_len > data_len:
                _err("tx encoded length overruns entry")
            batch.blocks[-1].txs.append(DataStreamTx(
                gas_price_percentage=gas_pct, is_valid=is_valid,
                state_root=state_root, encoded_tx=body[38:38 + tx_len]))
            continue
        if entry_type == 3:         # end L2 block
            if data_len != 72:
                _err(f"end-block data length {data_len} != 72")
            (block_num,) = struct.unpack_from(">Q", body, 0)
            if not batch.blocks:
                _err("end block without start")
            blk = batch.blocks[-1]
            if blk.l2_block_hash:
                _err("block already closed")
            if block_num != blk.block_number:
                _err("end-block number mismatch")
            blk.l2_block_hash = body[8:40]
            blk.state_root = body[40:72]
            continue
        # unknown data entry types are tolerated (forward compat), like the
        # reference's default branch logging-and-continuing
    return batch


# ---------------------------------------------------------------------------
# batchL2Data re-encoding (reference dataStreamBatch2batchL2Data,
# data_stream.cpp:515-556, and transcodeTx :558-668)
# ---------------------------------------------------------------------------

def _rlp_decode_list(data: bytes):
    """Minimal RLP list-of-strings decoder."""
    if not data or data[0] < 0xC0:
        raise ZkError(ZkResult.INVALID_INPUT, "not an RLP list")
    if data[0] <= 0xF7:
        plen = data[0] - 0xC0
        pos = 1
    else:
        lsize = data[0] - 0xF7
        plen = int.from_bytes(data[1:1 + lsize], "big")
        pos = 1 + lsize
    end = pos + plen
    fields = []
    while pos < end:
        b0 = data[pos]
        if b0 <= 0x7F:
            fields.append(data[pos:pos + 1])
            pos += 1
        elif b0 <= 0xB7:
            n = b0 - 0x80
            fields.append(data[pos + 1:pos + 1 + n])
            pos += 1 + n
        elif b0 <= 0xBF:
            lsize = b0 - 0xB7
            n = int.from_bytes(data[pos + 1:pos + 1 + lsize], "big")
            fields.append(data[pos + 1 + lsize:pos + 1 + lsize + n])
            pos += 1 + lsize + n
        else:
            raise ZkError(ZkResult.INVALID_INPUT, "nested RLP list in tx")
    return fields


def _rlp_encode_str(b: bytes) -> bytes:
    if len(b) == 1 and b[0] <= 0x7F:
        return b
    if len(b) <= 55:
        return bytes([0x80 + len(b)]) + b
    lb = len(b).to_bytes((len(b).bit_length() + 7) // 8, "big")
    return bytes([0xB7 + len(lb)]) + lb + b


def _rlp_encode_list(fields) -> bytes:
    payload = b"".join(_rlp_encode_str(f) for f in fields)
    if len(payload) <= 55:
        return bytes([0xC0 + len(payload)]) + payload
    lb = len(payload).to_bytes((len(payload).bit_length() + 7) // 8, "big")
    return bytes([0xF7 + len(lb)]) + lb + payload


def transcode_tx(encoded_tx: bytes, batch_chain_id: int) -> bytes:
    """Signed legacy tx RLP -> the ROM's batch encoding: RLP with
    (chainId, "", "") in the signature slots, then r(32) s(32) v(1)."""
    fields = _rlp_decode_list(encoded_tx)
    if len(fields) != 9:
        raise ZkError(ZkResult.INVALID_INPUT,
                      f"tx RLP has {len(fields)} fields, expected 9")
    txv = int.from_bytes(fields[6], "big")
    chain_id = (txv - 35) // 2
    if chain_id != batch_chain_id:
        raise ZkError(ZkResult.INVALID_INPUT,
                      f"tx chainId {chain_id} != batch {batch_chain_id}")
    v = txv - chain_id * 2 - 35 + 27
    r = int.from_bytes(fields[7], "big")
    s = int.from_bytes(fields[8], "big")
    cid = batch_chain_id.to_bytes(4, "big").lstrip(b"\x00")
    out_fields = fields[:6] + [cid, b"", b""]
    return (_rlp_encode_list(out_fields)
            + r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v]))


def batch_to_l2_data(batch: "DataStreamBatch") -> bytes:
    """DataStreamBatch -> batchL2Data bytes (block markers + txs)."""
    out = bytearray()
    for block in batch.blocks:
        out.append(0x0B)                              # changeL2Block
        out += int(block.delta_timestamp).to_bytes(4, "big")
        out += int(block.l1_info_tree_index).to_bytes(4, "big")
        for tx in block.txs:
            out += transcode_tx(tx.encoded_tx, batch.chain_id)
            out.append(tx.gas_price_percentage & 0xFF)
    return bytes(out)
