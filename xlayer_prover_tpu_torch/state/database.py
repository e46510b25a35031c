"""Node/program store backing the SMT (reference: src/hashdb/database.cpp).

The port's own copy of ``MemoryDB`` from ``xlayer_prover_tpu/state/
database.py``: the dict-backed store that proving and the tests use.  The
JAX package's file log, caches, SQL store and write-behind thread are not
ported.  Keys are 4-tuple Goldilocks node hashes; values are lists of 12
field elements (8 data + 4 capacity), exactly the reference node layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Key = Tuple[int, int, int, int]

# Database::dbStateRootKey — the well-known node key under which the
# latest consolidated state root is persisted (database.cpp:27-28)
STATE_ROOT_KEY: Key = (0xFFFFFFFFFFFFFFFF,) * 4


class MemoryDB:
    """In-memory node/program store."""

    def __init__(self):
        self.nodes: Dict[Key, List[int]] = {}
        self.programs: Dict[Key, bytes] = {}

    def read(self, key: Key) -> Optional[List[int]]:
        return self.nodes.get(tuple(key))

    def write(self, key: Key, value: List[int]):
        assert len(value) == 12
        self.nodes[tuple(key)] = [int(v) for v in value]

    def get_program(self, key: Key) -> Optional[bytes]:
        return self.programs.get(tuple(key))

    def set_program(self, key: Key, data: bytes):
        self.programs[tuple(key)] = bytes(data)

    def flush(self):
        pass
