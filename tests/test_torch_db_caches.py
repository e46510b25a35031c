"""Port parity: the node stores of xlayer_prover_tpu_torch
(``state/database.py``: FileDB, the LRU and associative caches,
MultiWrite's flush generations, CachedDB, SqlDB, the warm start and the
cache synch thread; ``state/postgres.py``) against the JAX package's, on
the CPU.

The same seeded node writes go through both packages: FileDB's logs are
byte-equal; the caches evict and overwrite the same entries; MultiWrite
seals and stores the same generations; SqlDB's rows and its recursive
read_tree are equal; the warm start caches the same nodes;
CacheSynchThread mirrors a loopback HashDB service's flushes; PostgresDB
speaks the reference's SQL to a fake driver (the fake of
tests/test_postgres.py, copied here).  Every thread is stopped and every
wait has a time limit."""

import importlib
import re
import sqlite3

import numpy as np
import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401
from xlayer_prover_tpu_torch.state import database as T
from xlayer_prover_tpu_torch.state import postgres as TP
from xlayer_prover_tpu.state import database as J
from xlayer_prover_tpu.state import postgres as JP

PKGS = ("xlayer_prover_tpu_torch", "xlayer_prover_tpu")
WAIT_S = 30.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _key(i):
    return (i, i + 1, i + 2, i + 3)


def seeded_nodes(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {tuple(int(x) for x in rng.integers(0, 1 << 63, 4)):
            [int(x) for x in rng.integers(0, 1 << 63, 12)]
            for _ in range(n)}


class Counting(T.MemoryDB):
    """A MemoryDB that counts reads (the port's MemoryDB keeps none)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def read(self, key):
        self.reads += 1
        return super().read(key)


# ---------------------------------------------------------------------------
# FileDB and the caches
# ---------------------------------------------------------------------------

def test_file_db_logs_equal(tmp_path):
    nodes = seeded_nodes(20, 1)
    paths = {}
    for pkg, db_mod in zip(PKGS, (T, J)):
        path = str(tmp_path / f"{pkg}.jsonl")
        db = db_mod.FileDB(path)
        for k, v in nodes.items():
            db.write(k, v)
        db.set_program(_key(5), b"\x60\x80\x01")
        db.flush()
        paths[pkg] = path
    with open(paths[PKGS[0]], "rb") as a, open(paths[PKGS[1]], "rb") as b:
        assert a.read() == b.read()
    # each reopens the other's log
    for opener, path in ((T, paths[PKGS[1]]), (J, paths[PKGS[0]])):
        db = opener.FileDB(path)
        assert all(db.read(k) == v for k, v in nodes.items())
        assert db.get_program(_key(5)) == b"\x60\x80\x01"


def test_lru_eviction_by_bytes():
    caches = [m.LRUCache(max_bytes=3 * (32 + 8 * 12)) for m in (T, J)]
    seen = []
    for c in caches:
        for i in range(5):
            c.put(_key(i), [i] * 12)
        got = [len(c), c.get(_key(0)), c.get(_key(4))]
        c.get(_key(2))                     # touching 2 keeps it over 3
        c.put(_key(9), [9] * 12)
        got += [c.get(_key(2)), c.get(_key(3)), c._bytes, c.hits, c.misses]
        c.put(_key(7), b"\x00" * 100)      # a program's cost: 32 + bytes
        got += [len(c), c._bytes]
        seen.append(got)
    assert seen[0] == seen[1]
    assert seen[0][:3] == [3, None, [4] * 12] and seen[0][4] is None


def test_associative_overwrite():
    seen = []
    for m in (T, J):
        c = m.AssociativeCache(index_bits=2)
        for i in range(16):
            c.put(_key(i), [i])
        seen.append([c.get(_key(i)) for i in range(16)])
    assert seen[0] == seen[1]
    assert 1 <= sum(v is not None for v in seen[0]) <= 4


def test_cached_db_read_through():
    backend = Counting()
    db = T.CachedDB(backend, mt_cache_bytes=1 << 16)
    try:
        backend.write(_key(1), list(range(12)))
        assert db.read(_key(1)) == list(range(12))
        assert backend.reads == 1
        for _ in range(5):
            assert db.read(_key(1)) == list(range(12))
        assert backend.reads == 1           # served from the caches
        db.clear_caches()
        assert db.read(_key(1)) == list(range(12)) and backend.reads == 2
        assert db.read(_key(2)) is None
    finally:
        db.close()


def flush_script(db) -> list:
    """Pending reads, two generations, an empty flush, flush data."""
    out = []
    db.write(_key(7), [7] * 12)
    out.append(db.read(_key(7)))
    fid, _stored = db.flush()
    assert db.multi_write.wait_stored(fid, timeout=WAIT_S)
    st = db.flush_status()
    out.append((fid, st["stored_flush_id"], st["pending_nodes"]))
    db.set_program(_key(8), b"\x01\x02")
    out.append(db.get_program(_key(8)))
    fid2, _ = db.flush()
    assert db.multi_write.wait_stored(fid2, timeout=WAIT_S)
    out.append((fid2, db.flush(), db.get_flush_data(1), db.get_flush_data(2),
                db.get_flush_data(9)))
    return out


def test_multiwrite_flush_generations():
    got = []
    for m in (T, J):
        backend = m.MemoryDB()
        db = m.CachedDB(backend)
        got.append((flush_script(db), backend.read(_key(7)),
                    backend.get_program(_key(8))))
        db.multi_write.close()
    assert got[0] == got[1]
    assert got[0][0][1] == (1, 1, 0) and got[0][1] == [7] * 12


def test_multiwrite_close_stores_what_was_flushed():
    """The port's close stores the sealed generations before the sender
    stops (the JAX sender dropped them)."""
    backend = T.MemoryDB()
    db = T.CachedDB(backend)
    nodes = seeded_nodes(50, 2)
    for k, v in nodes.items():
        db.write(k, v)
    db.flush()
    db.write(_key(1), [1] * 12)            # pending, never flushed
    db.close()
    assert not db.multi_write._thread.is_alive()
    assert backend.nodes == nodes


# ---------------------------------------------------------------------------
# SqlDB, the warm start, HashDB over the cached stack
# ---------------------------------------------------------------------------

def smt_over(pkg: str, db, n: int = 12):
    """A classic-SMT batch through HashDB over `db`: sets, consolidate."""
    hdb = mod(pkg, "state.hashdb").HashDB(db)
    root = (0, 0, 0, 0)
    rng = np.random.default_rng(5)
    keys = [tuple(int(x) for x in rng.integers(1, 1 << 62, 4))
            for _ in range(n)]
    for i, k in enumerate(keys):
        root = tuple(hdb.set("b1", root, k, 1000 + i).new_root)
    fid = hdb.consolidate("b1")
    return hdb, root, keys, fid


def test_sql_db_rows_and_read_tree_equal(tmp_path):
    got = []
    for pkg, m in zip(PKGS, (T, J)):
        path = str(tmp_path / f"{pkg}.sqlite")
        sql = m.SqlDB(path)
        db = m.CachedDB(sql)
        hdb, root, keys, (fid, _stored) = smt_over(pkg, db)
        assert db.multi_write.wait_stored(fid, timeout=WAIT_S)
        db.multi_write.close()
        sql.set_program(_key(3), b"\xde\xad")
        sql.flush()
        again = m.SqlDB(path)
        rows = again._conn.execute(
            "SELECT hash, data FROM nodes ORDER BY hash").fetchall()
        programs = again._conn.execute("SELECT * FROM program").fetchall()
        tree = again.read_tree(root)
        got.append((root, rows, programs, sorted(tree.items()),
                    db.read_state_root(),
                    [hdb.get(None, root, k).value for k in keys]))
    assert got[0] == got[1]
    root, rows, _p, tree = got[0][:4]
    # the tree under the root, beside the nodes of the batch's earlier
    # roots and the state-root sentinel
    assert len(tree) > 12 and len(rows) > len(tree)
    assert root in dict(tree)
    assert got[0][4] == root


def test_sql_db_legacy_rows_and_retries(tmp_path):
    path = str(tmp_path / "s.sqlite")
    for m in (T, J):
        db = m.SqlDB(path)
        db._conn.execute("INSERT OR REPLACE INTO nodes VALUES (?, ?)",
                         (db._hex(_key(4)), ",".join("%x" % i
                                                     for i in range(12))))
        db.flush()
        assert db.read(_key(4)) == list(range(12))
    mem = T.SqlDB()
    mem.write(_key(1), [3] * 12)
    mem.flush()
    assert mem.read(_key(1)) == [3] * 12
    mem.close()


def test_load_db_to_mem_cache_equal(tmp_path):
    """The warm start from the persisted state root: through read_tree
    (SqlDB) and breadth first over a store without it; both packages
    cache the same nodes."""
    got = []
    for pkg, m in zip(PKGS, (T, J)):
        sql = m.SqlDB(str(tmp_path / f"{pkg}.sqlite"))
        db = m.CachedDB(sql)
        _hdb, root, _keys, (fid, _s) = smt_over(pkg, db)
        assert db.multi_write.wait_stored(fid, timeout=WAIT_S)
        db.multi_write.close()
        warm = m.CachedDB(m.SqlDB(str(tmp_path / f"{pkg}.sqlite")))
        n_bulk = m.load_db_to_mem_cache(warm)
        bulk_keys = sorted(warm.mt_cache._d)
        mem = m.MemoryDB()
        for k in bulk_keys:
            mem.write(k, sql.read(k))
        walk = m.CachedDB(mem)
        n_walk = m.load_db_to_mem_cache(walk, root4=root)
        got.append((n_bulk, bulk_keys, n_walk, sorted(walk.mt_cache._d),
                    m.load_db_to_mem_cache(m.CachedDB(m.MemoryDB()))))
        warm.multi_write.close()
        walk.multi_write.close()
    assert got[0] == got[1]
    assert got[0][0] > 12 and got[0][4] == 0


def test_cache_synch_thread_between_loopback_services():
    """A CacheSynchThread of each package polls a loopback HashDB service
    (its backend a CachedDB): the nodes of its two flush generations land
    in the local caches, and nothing persists locally."""
    from tests.test_torch_entry_services import served
    for pkg, m in zip(PKGS, (T, J)):
        svc = mod(pkg, "services.hashdb_service")
        remote_db = m.CachedDB(m.MemoryDB())
        hdb = mod(pkg, "state.hashdb").HashDB(remote_db)
        with served(svc.HashDBServer(svc.HashDBServiceImpl(hdb))) \
                as (server, _ch):
            nodes = seeded_nodes(10, 7)
            for i, (k, v) in enumerate(nodes.items()):
                remote_db.write(k, v)
                if i in (4, 9):
                    remote_db.flush()
            remote_db.set_program(_key(2), b"\x99")
            remote_db.flush()
            local_backend = m.MemoryDB()
            local = m.CachedDB(local_backend)
            client = svc.HashDBRemote("127.0.0.1", server.port)
            synch = m.CacheSynchThread(local, client, poll_s=0.01)
            try:
                import time
                deadline = time.monotonic() + WAIT_S
                while synch.synced_programs < 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.01)
            finally:
                synch.stop(timeout=WAIT_S)
                client._channel.close()
                local.multi_write.close()
                remote_db.multi_write.close()
            assert not synch._thread.is_alive()
            assert synch.synced_nodes == 10 and synch.synced_programs == 1
            assert all(local.read(k) == v for k, v in nodes.items())
            assert local.get_program(_key(2)) == b"\x99"
            assert local_backend.nodes == {}


# ---------------------------------------------------------------------------
# PostgresDB over a fake driver (tests/test_postgres.py's, copied)
# ---------------------------------------------------------------------------

_SELECT = re.compile(
    r"^SELECT \* FROM (state\.\w+) WHERE hash = E'\\\\x([0-9a-f]+)';$")
_INSERT = re.compile(
    r"^INSERT INTO (state\.\w+) \( hash, data \) VALUES "
    r"\( E'\\\\x([0-9a-f]+)', E'\\\\x([0-9a-f]+)' \) "
    r"ON CONFLICT \(hash\) DO NOTHING;$")


class FakeCursor:
    def __init__(self, conn):
        self.conn = conn
        self._rows = None

    def execute(self, query):
        self.conn.fail_hook()
        self.conn.queries.append(query)
        m = _SELECT.match(query)
        if m:
            table, key = m.groups()
            cur = self.conn.sql.execute(
                "SELECT hash, data FROM t WHERE tbl = ? AND hash = ?",
                (table, key))
            self._rows = [(bytes.fromhex(h), bytes.fromhex(d))
                          for (h, d) in cur.fetchall()]
            return
        m = _INSERT.match(query)
        if m:
            table, key, data = m.groups()
            self.conn.sql.execute(
                "INSERT OR IGNORE INTO t (tbl, hash, data) VALUES (?,?,?)",
                (table, key, data))
            self._rows = None
            return
        raise AssertionError(f"query shape not reference-compatible: "
                             f"{query!r}")

    def fetchall(self):
        return self._rows

    def close(self):
        pass


class FakeConn:
    """DBAPI-ish connection over one shared sqlite store."""

    def __init__(self, store, queries, fail_hook=lambda: None):
        self.sql = store
        self.queries = queries
        self.fail_hook = fail_hook
        self.closed = False

    def cursor(self):
        return FakeCursor(self)

    def close(self):
        self.closed = True


def fake_store():
    sql = sqlite3.connect(":memory:", check_same_thread=False)
    sql.execute("CREATE TABLE t (tbl TEXT, hash TEXT, data TEXT, "
                "PRIMARY KEY (tbl, hash))")
    return sql


def postgres_script(pg_mod, db_mod, fails: int = 0):
    store, queries = fake_store(), []
    left = {"n": fails}

    def hook():
        if left["n"] > 0:
            left["n"] -= 1
            raise ConnectionError("connection dropped")

    db = pg_mod.PostgresDB(
        connection_factory=lambda: FakeConn(store, queries, hook),
        read_retries=3, retry_delay_s=0)
    out = [db.read((1, 2, 3, 4))]
    db.write((1, 2, 3, 4), list(range(12)))
    db.write((1, 2, 3, 4), [9] * 12)       # ON CONFLICT DO NOTHING
    out.append(db.read((1, 2, 3, 4)))
    db.set_program((5, 6, 7, 8), b"\x60\x80\x60\x40")
    out += [db.get_program((5, 6, 7, 8)), db.get_program((0, 0, 0, 9))]
    cached = db_mod.CachedDB(backend=db)
    cached.write((7, 7, 7, 7), list(range(12)))
    fid, _ = cached.flush()
    assert cached.multi_write.wait_stored(fid, timeout=WAIT_S)
    reads = db.reads
    out += [db.read((7, 7, 7, 7)), cached.read((7, 7, 7, 7)),
            db.reads - reads]
    cached.multi_write.close()
    return out, queries


@pytest.mark.parametrize("fails", [0, 2])
def test_postgres_over_the_fake_driver_equal(fails):
    port, port_q = postgres_script(TP, T, fails)
    jax, jax_q = postgres_script(JP, J, fails)
    assert port == jax and port_q == jax_q
    assert port[1] == list(range(12)) and port[-1] == 1


def test_postgres_pool_reuses_and_disposes():
    store, made = fake_store(), {"n": 0}

    def factory():
        made["n"] += 1
        return FakeConn(store, [])

    pool = TP.ConnectionPool(factory, size=2)
    a = pool.acquire()
    pool.release(a)
    b = pool.acquire()
    assert b is a and made["n"] == 1
    pool.release(b, broken=True)
    assert b.closed
    pool.acquire()
    assert made["n"] == 2


def test_postgres_without_a_driver_fails_as_the_jax_package():
    """No psycopg2 and no connection factory: both packages raise the
    same ImportError at construction."""
    errors = []
    for m in (TP, JP):
        try:
            m.PostgresDB(dsn="postgresql://db/state")
        except ImportError as e:
            errors.append((type(e), str(e)))
    if not errors:
        pytest.skip("psycopg2 is installed")
    assert len(errors) == 2 and errors[0] == errors[1]
