"""HashDB facade + per-batch StateManager overlay.

The port's own copy of the part of ``xlayer_prover_tpu/state/hashdb.py``
that the executor reads: SMT get/set through a per-batch overlay node
store (the reference's HashDBInterface, src/service/hashdb/
hashdb_interface.hpp, and the StateManager's batch substate,
src/hashdb/state_manager.hpp:16-70).  Writes of a batch stay in its
overlay; the JAX package's tx rollback, consolidation and RPC extras are
not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .database import MemoryDB
from .smt import Smt, SmtGetResult, SmtSetResult

Key = Tuple[int, int, int, int]


class _OverlayDB:
    """Node store view: reads hit the overlay first, then the base."""

    def __init__(self, base):
        self.base = base
        self.overlay: Dict[Key, List[int]] = {}
        self.programs: Dict[Key, bytes] = {}

    def read(self, key: Key):
        v = self.overlay.get(tuple(key))
        if v is not None:
            return v
        return self.base.read(key)

    def write(self, key: Key, value: List[int]):
        self.overlay[tuple(key)] = [int(v) for v in value]


class HashDB:
    """Local HashDB: SMT + database + per-batch overlays (``batches``)."""

    def __init__(self, db=None):
        self.db = db if db is not None else MemoryDB()
        self.batches: Dict[str, _OverlayDB] = {}

    def _store(self, batch_uuid: Optional[str]):
        if batch_uuid is None:
            return self.db
        if batch_uuid not in self.batches:
            self.batches[batch_uuid] = _OverlayDB(self.db)
        return self.batches[batch_uuid]

    def set(self, batch_uuid: Optional[str], old_root, key,
            value: int) -> SmtSetResult:
        return Smt(self._store(batch_uuid)).set(old_root, key, value)

    def get(self, batch_uuid: Optional[str], root, key) -> SmtGetResult:
        return Smt(self._store(batch_uuid)).get(root, key)
