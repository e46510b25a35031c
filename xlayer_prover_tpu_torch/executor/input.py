"""Batch input envelope + initial machine state.

The port's own copy of ``xlayer_prover_tpu/executor/input.py``.

Equivalent of the reference Input/public-inputs handling
(src/prover/input.hpp:51-130) and the Main SM's initial register file
(main_executor.cpp:5700-5715): B = oldStateRoot, C = oldAccInputHash,
SP = oldBatchNum, GAS = chainID, CTX = forkID.  Loads the reference's
input_executor JSON format directly.
"""

from __future__ import annotations

import dataclasses
import json

from .main_sm import Context, scalar_to_fea


def _as_int(v, default=0) -> int:
    if v is None:
        return default
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


@dataclasses.dataclass
class BatchInput:
    old_state_root: int = 0
    new_state_root: int = 0
    old_acc_input_hash: int = 0
    old_batch_num: int = 0
    chain_id: int = 0
    fork_id: int = 9
    batch_l2_data: bytes = b""
    sequencer_addr: int = 0
    timestamp_limit: int = 0
    l1_info_root: int = 0
    forced_blockhash_l1: int = 0
    # V1 publics (forks <= 6; reference executor.cpp:23-377 input layout)
    global_exit_root: int = 0
    timestamp: int = 0
    batch_hash_data: int = 0
    db: dict = dataclasses.field(default_factory=dict)
    contracts_bytecode: dict = dataclasses.field(default_factory=dict)
    # raw-quad variants (witness2db output: key quad -> limb list / bytes);
    # the stateless path fills these to skip hex re-encoding
    db_raw: dict = dataclasses.field(default_factory=dict)
    programs_raw: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def load(path: str) -> "BatchInput":
        with open(path) as f:
            return BatchInput.from_json(json.load(f))

    @staticmethod
    def from_json(j: dict) -> "BatchInput":
        data = j.get("batchL2Data", "")
        return BatchInput(
            old_state_root=_as_int(j.get("oldStateRoot")),
            new_state_root=_as_int(j.get("newStateRoot")),
            old_acc_input_hash=_as_int(j.get("oldAccInputHash")),
            old_batch_num=_as_int(j.get("oldNumBatch")),
            chain_id=_as_int(j.get("chainID")),
            fork_id=_as_int(j.get("forkID"), 9),
            batch_l2_data=bytes.fromhex(data.removeprefix("0x")) if data else b"",
            sequencer_addr=_as_int(j.get("sequencerAddr")),
            timestamp_limit=_as_int(j.get("timestampLimit")),
            l1_info_root=_as_int(j.get("l1InfoRoot")),
            forced_blockhash_l1=_as_int(j.get("forcedBlockHashL1")),
            global_exit_root=_as_int(j.get("globalExitRoot")),
            timestamp=_as_int(j.get("timestamp")),
            batch_hash_data=_as_int(j.get("batchHashData")),
            db=j.get("db", {}),
            contracts_bytecode=j.get("contractsBytecode", {}),
        )

    def input_vars(self) -> dict:
        return {
            "batchL2Data": self.batch_l2_data,
            "sequencerAddr": self.sequencer_addr,
            "timestampLimit": self.timestamp_limit,
            "l1InfoRoot": self.l1_info_root,
            "forcedBlockHashL1": self.forced_blockhash_l1,
            "oldStateRoot": self.old_state_root,
            "globalExitRoot": self.global_exit_root,
            "timestamp": self.timestamp,
            "batchHashData": self.batch_hash_data,
        }

    def load_db(self, hashdb):
        """Import the pre-state node map shipped with the input (the
        reference's debug db): hex node-hash -> 12 hex limbs."""
        for k, limbs in self.db.items():
            v = int(k, 16)
            quad = tuple((v >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
                         for j in range(4))
            vals = [int(x, 16) for x in limbs]
            if len(vals) == 8:      # value nodes ship without the capacity
                vals += [0, 0, 0, 0]
            hashdb.db.write(quad, vals)
        for k, code in self.contracts_bytecode.items():
            v = int(k, 16)
            quad = tuple((v >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
                         for j in range(4))
            hashdb.db.set_program(quad,
                                  bytes.fromhex(code.removeprefix("0x")))
        for quad, vals in self.db_raw.items():
            vals = [int(x) for x in vals]
            if len(vals) == 8:
                vals += [0, 0, 0, 0]
            hashdb.db.write(tuple(int(v) for v in quad), vals)
        for quad, code in self.programs_raw.items():
            hashdb.db.set_program(tuple(int(v) for v in quad), bytes(code))

    def setup_registers(self, ctx: Context):
        """Initial register file (main_executor.cpp:5700-5715)."""
        ctx.regs.B = scalar_to_fea(self.old_state_root)
        ctx.regs.C = scalar_to_fea(self.old_acc_input_hash)
        ctx.regs.SP = self.old_batch_num
        ctx.regs.GAS = self.chain_id
        ctx.regs.CTX = self.fork_id
        # SR starts at the old state root as well
        ctx.regs.SR = scalar_to_fea(self.old_state_root)
