"""Node/program store backing the SMT (reference: src/hashdb/database.cpp).

The port's own copy of ``xlayer_prover_tpu/state/database.py``: the same
interface (read / write / get_program / set_program / flush) over
pluggable stores, and the reference's cache and write-behind stack:

  * ``MemoryDB`` — dict-backed, the default for proving and the tests;
  * ``FileDB`` — MemoryDB + an append-only JSONL log, the JAX package's
    bytes;
  * ``LRUCache``, ``AssociativeCache``, ``MultiWrite`` (write-behind
    flush generations on a sender thread) and ``CachedDB`` over any store;
  * ``SqlDB`` — state.nodes / state.program over sqlite3 (the Postgres
    store is ``postgres.PostgresDB``);
  * ``load_db_to_mem_cache`` (the boot-time warm start) and
    ``CacheSynchThread`` (a remote prover's flushes mirrored into the
    caches).

Keys are 4-tuple Goldilocks node hashes; values are lists of 12 field
elements (8 data + 4 capacity), exactly the reference node layout.  One
difference from the JAX package: ``MultiWrite.close`` (and so
``CachedDB.close``) stores the sealed generations before its sender
stops, where the JAX sender dropped them; a process that stops after a
flush keeps what it flushed.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from collections import OrderedDict
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


class FileDB(MemoryDB):
    """MemoryDB + append-only JSONL log for durability across restarts."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec["t"] == "n":
                        self.nodes[tuple(rec["k"])] = rec["v"]
                    else:
                        self.programs[tuple(rec["k"])] = bytes.fromhex(
                            rec["v"])
        self._log = open(path, "a")

    def write(self, key: Key, value: List[int]):
        super().write(key, value)
        self._log.write(json.dumps({"t": "n", "k": list(key),
                                    "v": [int(v) for v in value]}) + "\n")

    def set_program(self, key: Key, data: bytes):
        super().set_program(key, data)
        self._log.write(json.dumps({"t": "p", "k": list(key),
                                    "v": data.hex()}) + "\n")

    def flush(self):
        self._log.flush()
        os.fsync(self._log.fileno())

    def close(self):
        self.flush()
        self._log.close()


# ---------------------------------------------------------------------------
# Caches + write-behind MultiWrite (reference database_cache.hpp,
# database_associative_cache.hpp, multi_write.hpp, database.hpp:107-131)
# ---------------------------------------------------------------------------

class LRUCache:
    """Byte-bounded LRU keyed by node hash (DatabaseMTCache semantics:
    each entry costs key+value bytes against a global budget)."""

    def __init__(self, max_bytes: int = 1 << 22):
        self.max_bytes = max_bytes
        self._d: "OrderedDict[Key, object]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _cost(value) -> int:
        if isinstance(value, (bytes, bytearray)):
            return 32 + len(value)
        return 32 + 8 * len(value)

    def get(self, key: Key):
        v = self._d.get(key)
        if v is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key: Key, value):
        old = self._d.pop(key, None)
        if old is not None:
            self._bytes -= self._cost(old)
        self._d[key] = value
        self._bytes += self._cost(value)
        while self._bytes > self.max_bytes and self._d:
            _k, v = self._d.popitem(last=False)
            self._bytes -= self._cost(v)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()
        self._bytes = 0


class AssociativeCache:
    """Direct-mapped cache indexed by Goldilocks-quad key bits
    (DatabaseMTAssociativeCache: fixed footprint, overwrite on collision,
    no eviction bookkeeping)."""

    def __init__(self, index_bits: int = 16):
        self.mask = (1 << index_bits) - 1
        self._keys = [None] * (1 << index_bits)
        self._vals = [None] * (1 << index_bits)
        self.hits = 0
        self.misses = 0

    def _slot(self, key: Key) -> int:
        return (key[0] ^ (key[1] << 1) ^ (key[2] << 2) ^ (key[3] << 3)) \
            & self.mask

    def get(self, key: Key):
        s = self._slot(key)
        if self._keys[s] == key:
            self.hits += 1
            return self._vals[s]
        self.misses += 1
        return None

    def put(self, key: Key, value):
        s = self._slot(key)
        self._keys[s] = key
        self._vals[s] = value

    def clear(self):
        self._keys = [None] * len(self._keys)
        self._vals = [None] * len(self._vals)


class MultiWrite:
    """Write-behind double buffer with flush-id generations
    (multi_write.hpp + dbSenderThread, database.hpp:127-131): writes
    accumulate in the pending generation; ``flush`` seals it and the
    sender thread stores sealed generations to the backend in order."""

    HISTORY = 16            # stored generations getFlushData still serves

    def __init__(self, backend):
        self.backend = backend
        self.lock = threading.Lock()
        self.pending_nodes: Dict[Key, List[int]] = {}
        self.pending_programs: Dict[Key, bytes] = {}
        self.sealed: "OrderedDict[int, tuple]" = OrderedDict()
        self.stored_history: "OrderedDict[int, tuple]" = OrderedDict()
        self.last_flush_id = 0
        self.storing_flush_id = 0
        self.stored_flush_id = 0
        self._work = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._sender, daemon=True,
                                        name="dbSender")
        self._thread.start()

    # -- producer side ---------------------------------------------------
    def write(self, key: Key, value: List[int]):
        with self.lock:
            self.pending_nodes[key] = list(value)

    def set_program(self, key: Key, data: bytes):
        with self.lock:
            self.pending_programs[key] = bytes(data)

    def read_pending(self, key: Key):
        with self.lock:
            v = self.pending_nodes.get(key)
            if v is not None:
                return v
            for _fid, (nodes, _programs) in reversed(self.sealed.items()):
                if key in nodes:
                    return nodes[key]
        return None

    def read_pending_program(self, key: Key):
        with self.lock:
            v = self.pending_programs.get(key)
            if v is not None:
                return v
            for _fid, (_nodes, programs) in reversed(self.sealed.items()):
                if key in programs:
                    return programs[key]
        return None

    def flush(self) -> tuple:
        """Seal the pending generation; returns (flush_id, stored_id)."""
        with self.lock:
            if self.pending_nodes or self.pending_programs:
                self.last_flush_id += 1
                self.sealed[self.last_flush_id] = (self.pending_nodes,
                                                   self.pending_programs)
                self.pending_nodes = {}
                self.pending_programs = {}
            self._work.set()
            return self.last_flush_id, self.stored_flush_id

    def get_flush_data(self, flush_id: int):
        with self.lock:
            data = self.sealed.get(flush_id)
            if data is None:
                data = self.stored_history.get(flush_id)
            return data

    def status(self) -> dict:
        with self.lock:
            return {"last_flush_id": self.last_flush_id,
                    "storing_flush_id": self.storing_flush_id,
                    "stored_flush_id": self.stored_flush_id,
                    "pending_nodes": len(self.pending_nodes),
                    "pending_programs": len(self.pending_programs)}

    def wait_stored(self, flush_id: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                if self.stored_flush_id >= flush_id:
                    return True
            time.sleep(0.002)
        return False

    def close(self, timeout: float = 30.0):
        """Store the sealed generations, then stop the sender."""
        self._stop = True
        self._work.set()
        self._thread.join(timeout)

    # -- sender thread -----------------------------------------------------
    def _sender(self):
        while True:
            self._work.wait()
            self._work.clear()
            while True:
                with self.lock:
                    if not self.sealed:
                        break
                    fid, (nodes, programs) = next(iter(self.sealed.items()))
                    self.storing_flush_id = fid
                for k, v in nodes.items():
                    self.backend.write(k, v)
                for k, d in programs.items():
                    self.backend.set_program(k, d)
                self.backend.flush()
                with self.lock:
                    data = self.sealed.pop(fid, None)
                    if data is not None:
                        # keep a bounded history so getFlushData can serve
                        # the sequencer's flush-recovery protocol after the
                        # generation already hit the backend
                        self.stored_history[fid] = data
                        while len(self.stored_history) > self.HISTORY:
                            self.stored_history.pop(
                                next(iter(self.stored_history)))
                    self.stored_flush_id = fid
            if self._stop:
                return


class CachedDB:
    """Backend wrapper with the reference's cache + write-behind stack:
    associative cache -> LRU cache -> MultiWrite pending -> backend;
    writes land in the caches immediately and persist asynchronously."""

    def __init__(self, backend=None, mt_cache_bytes: int = 1 << 22,
                 assoc_bits: int = 16, program_cache_bytes: int = 1 << 22):
        self.backend = backend if backend is not None else MemoryDB()
        self.mt_cache = LRUCache(mt_cache_bytes)
        self.assoc = AssociativeCache(assoc_bits)
        self.program_cache = LRUCache(program_cache_bytes)
        self.multi_write = MultiWrite(self.backend)

    def read(self, key: Key):
        key = tuple(key)
        v = self.assoc.get(key)
        if v is not None:
            return list(v)
        v = self.mt_cache.get(key)
        if v is None:
            v = self.multi_write.read_pending(key)
        if v is None:
            v = self.backend.read(key)
        if v is not None:
            self.assoc.put(key, list(v))
            self.mt_cache.put(key, list(v))
            return list(v)
        return None

    def write(self, key: Key, value: List[int]):
        key = tuple(key)
        value = [int(v) for v in value]
        self.assoc.put(key, value)
        self.mt_cache.put(key, value)
        self.multi_write.write(key, value)

    def get_program(self, key: Key):
        key = tuple(key)
        v = self.program_cache.get(key)
        if v is None:
            v = self.multi_write.read_pending_program(key)
        if v is None:
            v = self.backend.get_program(key)
        if v is not None:
            self.program_cache.put(key, bytes(v))
        return v

    def set_program(self, key: Key, data: bytes):
        key = tuple(key)
        self.program_cache.put(key, bytes(data))
        self.multi_write.set_program(key, data)

    def flush(self):
        return self.multi_write.flush()

    def flush_status(self) -> dict:
        return self.multi_write.status()

    def get_flush_data(self, flush_id: int):
        """(stored_flush_id, nodes, programs) for a sealed generation
        (reference Database::getFlushData, database.hpp:115)."""
        sealed = self.multi_write.get_flush_data(flush_id)
        stored = self.multi_write.status()["stored_flush_id"]
        if sealed is None:
            return stored, {}, {}
        nodes, programs = sealed
        return stored, dict(nodes), dict(programs)

    def clear_caches(self):
        self.mt_cache.clear()
        self.assoc.clear()
        self.program_cache.clear()

    def close(self):
        """Store what was flushed, stop the sender, close the backend."""
        self.multi_write.close()
        close = getattr(self.backend, "close", None)
        if close is not None:
            close()

    # -- cache-only writes (dbCacheSynchThread mirrors a remote prover's
    # flushed nodes into the local caches WITHOUT re-persisting them,
    # reference database.cpp:1872-1966 write(..., persistent=false)) --
    def write_cache_only(self, key: Key, value: List[int]):
        key = tuple(key)
        value = [int(v) for v in value]
        self.assoc.put(key, value)
        self.mt_cache.put(key, value)

    def set_program_cache_only(self, key: Key, data: bytes):
        self.program_cache.put(tuple(key), bytes(data))

    # -- persisted latest-consolidated-state-root sentinel (reference
    # Database::dbStateRootKey = 64 f's, database.cpp:27-28,813) --
    def update_state_root(self, root4):
        self.write(STATE_ROOT_KEY, list(root4) + [0] * 8)

    def read_state_root(self):
        v = self.read(STATE_ROOT_KEY)
        return None if v is None else tuple(v[:4])


# ---------------------------------------------------------------------------
# SQL-backed store (reference Database + Postgres, database.cpp:
# readRemote/writeRemote with read retries and a connection pool).
# sqlite3 (stdlib) carries the SQL path; the schema and the retry /
# reconnect semantics mirror the reference's state.nodes / state.program
# tables (postgres.PostgresDB speaks the reference's own SQL).
# ---------------------------------------------------------------------------

class SqlDB:
    """state.nodes / state.program over a SQL connection with read
    retries (dbReadRetryCounter/Delay semantics, config.hpp:181-182)."""

    _DDL = (
        "CREATE TABLE IF NOT EXISTS nodes (hash TEXT PRIMARY KEY, "
        "data TEXT NOT NULL)",
        "CREATE TABLE IF NOT EXISTS program (hash TEXT PRIMARY KEY, "
        "data BLOB NOT NULL)",
    )

    def __init__(self, url: str = ":memory:", read_retries: int = 3,
                 retry_delay_s: float = 0.01):
        self.url = url
        self.read_retries = read_retries
        self.retry_delay_s = retry_delay_s
        # One shared connection guarded by a mutex: the MultiWrite sender
        # thread writes through this backend, so check_same_thread must be
        # off and every op (including commit) runs on the same connection
        # under the lock.
        self._lock = threading.RLock()
        self._conn = self._connect()
        self._init_schema()
        self.reads = 0
        self.writes = 0

    def _connect(self):
        return sqlite3.connect(self.url, check_same_thread=False)

    def _init_schema(self):
        for ddl in self._DDL:
            self._conn.execute(ddl)
        self._conn.commit()

    @staticmethod
    def _hex(key: Key) -> str:
        return "%016x%016x%016x%016x" % tuple(int(v) for v in key)

    def _retry(self, fn):
        last = None
        attempts = max(1, self.read_retries)
        for attempt in range(attempts):
            try:
                with self._lock:
                    return fn()
            except sqlite3.Error as e:
                last = e
                # ':memory:' databases live in the connection: replacing
                # it would silently drop all data, so never reconnect.
                if self.url != ":memory:" and attempt + 1 < attempts:
                    try:
                        with self._lock:
                            self._conn = self._connect()
                            self._init_schema()
                    except sqlite3.Error:
                        pass
                time.sleep(self.retry_delay_s)
        raise last

    @staticmethod
    def _parse(data: str) -> List[int]:
        if "," in data:  # legacy comma-separated payloads
            return [int(v, 16) for v in data.split(",")]
        return [int(data[i * 16:(i + 1) * 16], 16) for i in range(12)]

    def read(self, key: Key):
        self.reads += 1

        def q():
            cur = self._conn.execute(
                "SELECT data FROM nodes WHERE hash = ?", (self._hex(key),))
            row = cur.fetchone()
            return None if row is None else self._parse(row[0])
        return self._retry(q)

    def write(self, key: Key, value: List[int]):
        self.writes += 1
        assert len(value) == 12
        # fixed-width payload so read_tree can extract child hashes with
        # substr() inside the recursive CTE
        data = "".join("%016x" % int(v) for v in value)

        def q():
            self._conn.execute(
                "INSERT OR REPLACE INTO nodes (hash, data) VALUES (?, ?)",
                (self._hex(key), data))
        self._retry(q)

    def get_program(self, key: Key):
        def q():
            cur = self._conn.execute(
                "SELECT data FROM program WHERE hash = ?",
                (self._hex(key),))
            row = cur.fetchone()
            return None if row is None else bytes(row[0])
        return self._retry(q)

    def set_program(self, key: Key, data: bytes):
        def q():
            self._conn.execute(
                "INSERT OR REPLACE INTO program (hash, data) VALUES (?, ?)",
                (self._hex(key), bytes(data)))
        self._retry(q)

    def flush(self):
        self._retry(self._conn.commit)

    def close(self):
        with self._lock:
            self._conn.commit()
            self._conn.close()

    def read_tree(self, root: Key, max_level: int = 300) -> dict:
        """Bulk subtree read in ONE SQL round trip via a recursive CTE —
        the equivalent of the reference's readTreeRemote stored procedure
        (database.hpp:64, writeGetTreeFunction).  Branch nodes (capacity
        0000) recurse into both children; leaf nodes (capacity 1000) pull
        their value node.  Legacy comma-separated rows terminate recursion
        (their children aren't substr-addressable) but are still
        returned."""
        cap0 = "0" * 64
        cap1 = "%016x" % 1 + "0" * 48

        def q():
            cur = self._conn.execute(
                "WITH RECURSIVE walk(hash, data, lvl) AS ("
                "  SELECT hash, data, 0 FROM nodes WHERE hash = ?"
                "  UNION"
                "  SELECT n.hash, n.data, w.lvl + 1 FROM walk w"
                "  JOIN nodes n ON ("
                "    (substr(w.data, 129, 64) = ? AND"
                "     n.hash IN (substr(w.data, 1, 64),"
                "                substr(w.data, 65, 64)))"
                "    OR (substr(w.data, 129, 64) = ? AND"
                "        n.hash = substr(w.data, 65, 64)))"
                "  WHERE w.lvl < ? AND length(w.data) = 192"
                ") SELECT hash, data FROM walk",
                (self._hex(root), cap0, cap1, max_level))
            return cur.fetchall()

        out = {}
        for hash_hex, data in self._retry(q):
            key = tuple(int(hash_hex[i * 16:(i + 1) * 16], 16)
                        for i in range(4))
            out[key] = self._parse(data)
        return out


# ---------------------------------------------------------------------------
# Boot-time warm start (reference main.cpp:404-440 + database.cpp:1968-2126)
# ---------------------------------------------------------------------------

def load_db_to_mem_cache(db: "CachedDB", root4: Optional[Key] = None,
                         timeout_s: float = 10.0,
                         max_fill: float = 0.9) -> int:
    """Warm the MT cache by walking the SMT breadth-first from the latest
    consolidated state root (loadDb2MemCache, database.cpp:1968-2126):
    branch nodes (capacity 0000) enqueue both children, leaf nodes
    (capacity 1000) pull their value node.  Bounded by wall-clock and by
    cache fill exactly like the reference (10 s / 90 % defaults).  When
    the backend supports read_tree (SqlDB/PostgresDB recursive CTE — the
    readTreeRemote equivalent) the whole subtree is fetched in one SQL
    round trip instead.  Returns the number of nodes cached."""
    t0 = time.monotonic()
    if root4 is None:
        root4 = db.read_state_root()
    if root4 is None or not any(int(v) for v in root4):
        return 0
    root4 = tuple(int(v) for v in root4)

    bulk = getattr(db.backend, "read_tree", None)
    if bulk is not None:
        count = 0
        for key, value in bulk(root4).items():
            db.write_cache_only(key, value)
            count += 1
            if db.mt_cache._bytes > max_fill * db.mt_cache.max_bytes:
                break
        return count

    level = [root4]
    count = 0
    while level:
        nxt = []
        for h in level:
            if time.monotonic() - t0 > timeout_s:
                return count
            if db.mt_cache._bytes > max_fill * db.mt_cache.max_bytes:
                return count
            v = db.read(h)  # read() populates the caches
            if v is None or len(v) < 12:
                continue
            count += 1
            if any(int(x) for x in v[9:12]):
                continue
            if int(v[8]) == 0:  # branch
                left, right = tuple(v[0:4]), tuple(v[4:8])
                if any(left):
                    nxt.append(left)
                if any(right):
                    nxt.append(right)
            elif int(v[8]) == 1:  # leaf -> value node
                vh = tuple(v[4:8])
                if any(vh) and db.read(vh) is not None:
                    count += 1
        level = nxt
    return count


class CacheSynchThread:
    """Mirror a remote prover's flushed nodes/programs into the local
    caches (dbCacheSynchThread, database.cpp:1872-1966; started when
    config.dbCacheSynchURL is set, database.cpp:96).  The remote object
    needs get_flush_data(flush_id) -> (stored_flush_id, nodes, programs)
    — services.hashdb_service.HashDBRemote provides it over gRPC."""

    def __init__(self, db: "CachedDB", remote, poll_s: float = 0.25):
        self.db = db
        self.remote = remote
        self.poll_s = poll_s
        self.synced_nodes = 0
        self.synced_programs = 0
        self.errors = 0
        self._next = 1
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dbCacheSynch")
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                stored, nodes, programs = \
                    self.remote.get_flush_data(self._next)
            except Exception:  # noqa: BLE001 - remote down: retry slowly
                self.errors += 1
                self._stop.wait(max(1.0, 4 * self.poll_s))
                continue
            if not nodes and not programs:
                if stored < self._next:  # nothing sealed yet
                    self._stop.wait(self.poll_s)
                    continue
            for k, v in nodes.items():
                self.db.write_cache_only(k, v)
            for k, v in programs.items():
                self.db.set_program_cache_only(k, v)
            self.synced_nodes += len(nodes)
            self.synced_programs += len(programs)
            self._next += 1

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        self._thread.join(timeout)
