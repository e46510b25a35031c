"""Postgres-backed node/program store (reference src/hashdb/database.cpp).

The port's own copy of ``xlayer_prover_tpu/state/postgres.py``.  Wire
shape matches the reference exactly:
  * tables  state.nodes / state.program (hash BYTEA PRIMARY KEY, data
    BYTEA) — config dbNodesTableName/dbProgramTableName defaults
    (config.cpp:282-283);
  * reads   SELECT * FROM <table> WHERE hash = E'\\x<key>'
    (database.cpp:564), 0 rows -> not-found, >1 rows -> fatal;
  * writes  INSERT INTO <table> ( hash, data ) VALUES ( E'\\x..',
    E'\\x..' ) ON CONFLICT (hash) DO NOTHING (database.cpp:757);
  * node payloads are the 12 GL limbs hex-concatenated (16 chars each),
    program payloads raw bytes;
  * a connection pool with dispose-on-error + read retries
    (dbReadRetryCounter/Delay semantics, config.hpp:181-182;
    database.hpp:44-49 connection pool).

The driver is injectable: psycopg2 when installed, or any DBAPI
connection factory.  Without either, construction fails with psycopg2's
ImportError, as in the JAX package.  The tests run the same statements
against a wire-faithful sqlite-backed fake that enforces the query shapes
above.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, List, Optional, Tuple

Key = Tuple[int, int, int, int]


def _key_hex(key: Key) -> str:
    return "%016x%016x%016x%016x" % tuple(int(v) for v in key)


def _nodes_payload(value: List[int]) -> str:
    assert len(value) == 12
    return "".join("%016x" % int(v) for v in value)


def _parse_nodes_payload(hexdata: str) -> List[int]:
    assert len(hexdata) == 12 * 16, len(hexdata)
    return [int(hexdata[i * 16:(i + 1) * 16], 16) for i in range(12)]


class ConnectionPool:
    """getConnection/disposeConnection semantics (database.hpp:44-49):
    a bounded pool; failed connections are dropped and rebuilt."""

    def __init__(self, factory: Callable, size: int = 4):
        self.factory = factory
        self.size = size
        self._free: list = []
        self._lock = threading.Lock()
        self._count = 0

    def acquire(self):
        with self._lock:
            if self._free:
                return self._free.pop()
            self._count += 1
        return self.factory()

    def release(self, conn, broken: bool = False):
        if broken:
            with self._lock:
                self._count -= 1
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
            return
        with self._lock:
            if len(self._free) < self.size:
                self._free.append(conn)
                return
            self._count -= 1
        conn.close()


class PostgresDB:
    """Drop-in for MemoryDB/SqlDB behind CachedDB: read/write/
    get_program/set_program/flush over the reference's SQL surface."""

    def __init__(self, dsn: str = "", connection_factory: Callable = None,
                 nodes_table: str = "state.nodes",
                 program_table: str = "state.program",
                 pool_size: int = 4, read_retries: int = 3,
                 retry_delay_s: float = 0.01):
        if connection_factory is None:
            import psycopg2  # not bundled here; injectable for tests

            def connection_factory():
                conn = psycopg2.connect(dsn)
                conn.autocommit = True
                return conn
        self.pool = ConnectionPool(connection_factory, pool_size)
        self.nodes_table = nodes_table
        self.program_table = program_table
        self.read_retries = read_retries
        self.retry_delay_s = retry_delay_s
        self.reads = 0
        self.writes = 0

    # -- low-level query with retry + pool dispose -----------------------
    def _exec(self, query: str, fetch: bool):
        last = None
        for attempt in range(max(1, self.read_retries)):
            conn = self.pool.acquire()
            try:
                cur = conn.cursor()
                cur.execute(query)
                rows = cur.fetchall() if fetch else None
                cur.close()
                self.pool.release(conn)
                return rows
            except Exception as e:  # noqa: BLE001 - retry on a fresh conn
                last = e
                self.pool.release(conn, broken=True)
                time.sleep(self.retry_delay_s)
        raise last

    def _read_remote(self, table: str, key_hex: str) -> Optional[str]:
        rows = self._exec(
            f"SELECT * FROM {table} WHERE hash = E'\\\\x{key_hex}';",
            fetch=True)
        if not rows:
            return None
        assert len(rows) == 1, "duplicate key in nodes table"
        row = rows[0]
        assert len(row) == 2, "unexpected column count"
        data = row[1]
        if isinstance(data, memoryview):
            data = bytes(data)
        if isinstance(data, (bytes, bytearray)):
            return bytes(data).hex()
        return re.sub(r"^\\\\x", "", str(data))

    def _write_remote(self, table: str, key_hex: str, value_hex: str):
        self._exec(
            f"INSERT INTO {table} ( hash, data ) VALUES "
            f"( E'\\\\x{key_hex}', E'\\\\x{value_hex}' ) "
            f"ON CONFLICT (hash) DO NOTHING;", fetch=False)

    # -- Database interface ----------------------------------------------
    def read(self, key: Key) -> Optional[List[int]]:
        self.reads += 1
        data = self._read_remote(self.nodes_table, _key_hex(key))
        return None if data is None else _parse_nodes_payload(data)

    def write(self, key: Key, value: List[int]):
        self.writes += 1
        self._write_remote(self.nodes_table, _key_hex(key),
                           _nodes_payload(value))

    def get_program(self, key: Key) -> Optional[bytes]:
        data = self._read_remote(self.program_table, _key_hex(key))
        return None if data is None else bytes.fromhex(data)

    def set_program(self, key: Key, data: bytes):
        self._write_remote(self.program_table, _key_hex(key),
                           bytes(data).hex())

    def flush(self):
        pass        # autocommit connections (reference nontransaction)
