"""Result codes (reference: src/config/zkresult.{hpp,cpp}).

The port's own copy of ``xlayer_prover_tpu/utils/zkresult.py``: an IntEnum
of stable codes with string names, grouped to match the reference's
ranges, and the exception that carries one.
"""

from __future__ import annotations

import enum


class ZkResult(enum.IntEnum):
    UNSPECIFIED = 0
    SUCCESS = 1
    # internal / db
    DB_KEY_NOT_FOUND = 10
    DB_ERROR = 11
    STATE_MANAGER = 12
    # input validation
    INVALID_INPUT = 20
    INVALID_BATCH_L2_DATA = 21
    INVALID_OLD_STATE_ROOT = 22
    INVALID_FORK_ID = 23
    INVALID_PROOF = 24
    # executor
    OUT_OF_COUNTERS_STEP = 30
    OUT_OF_COUNTERS_KECCAK = 31
    OUT_OF_COUNTERS_BINARY = 32
    OUT_OF_COUNTERS_MEM = 33
    OUT_OF_COUNTERS_ARITH = 34
    OUT_OF_COUNTERS_PADDING = 35
    OUT_OF_COUNTERS_POSEIDON = 36
    OUT_OF_GAS = 37
    # prover
    PROVER_ERROR = 40
    STARK_ERROR = 41
    SNARK_ERROR = 42
    CANCELLED = 43

    def ok(self) -> bool:
        return self == ZkResult.SUCCESS


class ZkError(Exception):
    def __init__(self, code: ZkResult, msg: str = ""):
        self.code = code
        super().__init__(f"{code.name}: {msg}")
