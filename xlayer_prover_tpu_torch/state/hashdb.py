"""HashDB facade + per-batch StateManager overlay.

The port's own copy of ``xlayer_prover_tpu/state/hashdb.py``.  Mirrors the
reference's HashDBInterface surface (the 20-method interface at
src/service/hashdb/hashdb_interface.hpp:16-44 — set/get/setProgram/
getProgram/flush/consolidate semantics) and the StateManager's
batch -> block -> tx substate overlay with rollback on revert
(src/hashdb/state_manager.hpp:16-70): uncommitted writes live in an
overlay node store; consolidation writes through to the backing database;
reverts discard substates.  The backing store is any of ``database.py``'s
(``MemoryDB`` by default; ``CachedDB`` over ``SqlDB`` or
``postgres.PostgresDB`` where the config names a databaseURL).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .database import MemoryDB
from .smt import Smt, SmtGetResult, SmtSetResult, ZERO4

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

    def get_program(self, key: Key):
        v = self.programs.get(tuple(key))
        if v is not None:
            return v
        return self.base.get_program(key)

    def set_program(self, key: Key, data: bytes):
        self.programs[tuple(key)] = bytes(data)


@dataclasses.dataclass
class _TxSubstate:
    nodes: Dict[Key, List[int]]
    programs: Dict[Key, bytes]
    old_root: tuple


class HashDB:
    """Local HashDB: SMT + database + per-batch overlay state manager.

    Usage: begin_batch(uuid) -> set/get (writes go to the batch overlay) ->
    semi_flush/consolidate(uuid) persists, or discard(uuid) rolls back.
    """

    def __init__(self, db=None):
        self.db = db if db is not None else MemoryDB()
        self.batches: Dict[str, _OverlayDB] = {}
        self.tx_marks: Dict[str, List[_TxSubstate]] = {}
        self.latest_root: tuple = (0, 0, 0, 0)
        self._batch_roots: Dict[str, tuple] = {}
        self._block_marks: Dict[str, list] = {}

    def _store(self, batch_uuid: Optional[str]):
        if batch_uuid is None:
            return self.db
        if batch_uuid not in self.batches:
            self.batches[batch_uuid] = _OverlayDB(self.db)
            self.tx_marks[batch_uuid] = []
        return self.batches[batch_uuid]

    # -- SMT state ------------------------------------------------------
    def set(self, batch_uuid: Optional[str], old_root, key,
            value: int) -> SmtSetResult:
        store = self._store(batch_uuid)
        res = Smt(store).set(old_root, key, value)
        if batch_uuid is not None:
            self._batch_roots[batch_uuid] = tuple(res.new_root)
        else:
            self.latest_root = tuple(res.new_root)
        return res

    def get(self, batch_uuid: Optional[str], root, key) -> SmtGetResult:
        store = self._store(batch_uuid)
        return Smt(store).get(root, key)

    # -- program (bytecode) store --------------------------------------
    def set_program(self, batch_uuid: Optional[str], key, data: bytes):
        self._store(batch_uuid).set_program(tuple(int(v) for v in key), data)

    def get_program(self, batch_uuid: Optional[str], key) -> Optional[bytes]:
        return self._store(batch_uuid).get_program(tuple(int(v) for v in key))

    # -- tx/batch lifecycle --------------------------------------------
    def begin_tx(self, batch_uuid: str, current_root):
        """Mark a tx boundary for possible rollback."""
        store = self._store(batch_uuid)
        self.tx_marks[batch_uuid].append(_TxSubstate(
            nodes=dict(store.overlay), programs=dict(store.programs),
            old_root=tuple(int(v) for v in current_root)))

    def revert_tx(self, batch_uuid: str):
        """Discard writes since the last begin_tx; returns the rolled-back root."""
        store = self._store(batch_uuid)
        mark = self.tx_marks[batch_uuid].pop()
        store.overlay = mark.nodes
        store.programs = mark.programs
        return mark.old_root

    def consolidate(self, batch_uuid: str):
        """Write the batch overlay through to the backing database."""
        store = self.batches.pop(batch_uuid, None)
        self.tx_marks.pop(batch_uuid, None)
        self._block_marks.pop(batch_uuid, None)
        root = self._batch_roots.pop(batch_uuid, None)
        if root is not None:
            self.latest_root = root
        if store is None:
            return
        for k, v in store.overlay.items():
            self.db.write(k, v)
        for k, d in store.programs.items():
            self.db.set_program(k, d)
        if root is not None and any(int(v) for v in root):
            # persist the consolidated root under the dbStateRootKey
            # sentinel so loadDb2MemCache can warm-start after a restart
            # (reference Database::updateStateRoot, database.cpp:806-858)
            update = getattr(self.db, "update_state_root", None)
            if update is not None:
                update(root)
        return self.db.flush()   # CachedDB: (flush_id, stored_flush_id)

    def discard(self, batch_uuid: str):
        """Drop the whole batch overlay (cancelBatch)."""
        self.batches.pop(batch_uuid, None)
        self.tx_marks.pop(batch_uuid, None)
        self._batch_roots.pop(batch_uuid, None)
        self._block_marks.pop(batch_uuid, None)

    # -- reference HashDBInterface extras (hashdb_interface.hpp:21-40) ---
    def get_latest_state_root(self) -> tuple:
        return self.latest_root

    def start_block(self, batch_uuid: str, old_state_root, persistence=0):
        """Block boundary start (stateManager block substate)."""
        self._store(batch_uuid)
        self._block_marks.setdefault(batch_uuid, []).append(
            ("start", tuple(int(v) for v in old_state_root)
             if not isinstance(old_state_root, str) else old_state_root))

    def finish_block(self, batch_uuid: str, new_state_root, persistence=0):
        self._block_marks.setdefault(batch_uuid, []).append(
            ("finish", new_state_root))

    def finish_tx(self, batch_uuid: str, new_state_root, persistence=0):
        """Tx boundary: seal the current substate (reference finishTx);
        rollback via revert_tx returns to the previous boundary."""
        store = self._store(batch_uuid)
        self.tx_marks[batch_uuid].append(_TxSubstate(
            nodes=dict(store.overlay), programs=dict(store.programs),
            old_root=self._batch_roots.get(batch_uuid, (0, 0, 0, 0))))

    def read_tree(self, state_root, keys):
        """Bulk sub-trie read at a consolidated root (readTree RPC)."""
        return Smt(self.db).read_tree(state_root, keys)

    def write_tree(self, old_root, key_values, persistent: bool = True):
        """Bulk key-value write from old_root; returns the new root
        (HashDBInterface::writeTree, hashdb_interface.hpp:38 — the
        stateless flow's bulk state import).  key_values: iterable of
        (key4, value_int).  persistent=False stages the nodes in a batch
        overlay ("__writeTree__") instead of the backing db, mirroring
        the reference's persistence flag (database_64.cpp:298-430)."""
        store = self.db if persistent \
            else self._store("__writeTree__")
        smt = Smt(store)
        root = tuple(int(v) for v in old_root)
        for key, value in key_values:
            root = tuple(smt.set(root, key, int(value)).new_root)
        if persistent and any(root):
            self.latest_root = root
            update = getattr(self.db, "update_state_root", None)
            if update is not None:
                update(root)
        return root

    def get_flush_data(self, flush_id: int):
        """The sequencer's flush-recovery protocol (getFlushData RPC):
        returns (stored_flush_id, nodes, programs) persisted at that
        generation; empty when the backend keeps no write-behind log."""
        getter = getattr(self.db, "get_flush_data", None)
        if getter is None:
            return 0, {}, {}
        data = getter(flush_id)
        if data is None:
            return 0, {}, {}
        if isinstance(data, tuple) and len(data) == 3:
            return data
        nodes = data.get("nodes", {}) if isinstance(data, dict) else {}
        progs = data.get("programs", {}) if isinstance(data, dict) else {}
        return flush_id, nodes, progs

    def clear_cache(self):
        clear = getattr(self.db, "clear_caches", None)
        if clear is not None:
            clear()

    def reset(self):
        """Drop ALL state (resetDB RPC; reference resetDB truncates the
        node/program tables)."""
        self.batches.clear()
        self.tx_marks.clear()
        self._batch_roots.clear()
        self._block_marks.clear()
        self.latest_root = (0, 0, 0, 0)
        backend = getattr(self.db, "backend", self.db)
        for store in (self.db, backend):
            if hasattr(store, "nodes"):
                store.nodes.clear()
            if hasattr(store, "programs"):
                store.programs.clear()
        self.clear_cache()
