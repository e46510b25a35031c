"""Port parity: the hashdb64 state backend of xlayer_prover_tpu_torch
(``state/page_manager.py``, ``kv_tree.py``, ``hashdb64.py`` and its level
hasher ``smt64_hash.py``) against the JAX package's, on the CPU.

The same seeded operations (keys and values made with numpy) go through
both packages: the page pool, the KV tree and the PagedStore files are
byte-equal; each package opens the other's files and reads the same
values; ``TreeChunk``'s codec and per-chunk hash agree; the level hasher
(over the plain Poseidon permutation, as a CPU tensor takes it) gives the
JAX ``Smt64``'s root and every stored chunk, byte for byte and in the
same order, at 1, 2, 63, 64, 65 and 2^10 leaves, through updates and
deletes; the ``StateManager64`` workflow with rollback and cancel; the
HashDB gRPC service over either package's ``HashDB64`` answers the same
RPC script.  The port's ``HashDB64`` reopens at its latest root."""

import filecmp
import importlib
import os

import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401
from xlayer_prover_tpu_torch.state import hashdb64 as T
from xlayer_prover_tpu_torch.state import smt64_hash
from xlayer_prover_tpu_torch.state.kv_tree import KeyValueTree
from xlayer_prover_tpu_torch.state.page_manager import PAGE_SIZE, PageManager
from xlayer_prover_tpu.state import hashdb64 as J
from xlayer_prover_tpu.state import kv_tree as jkv
from xlayer_prover_tpu.state import page_manager as jpm

P = (1 << 64) - (1 << 32) + 1
ZERO4 = (0, 0, 0, 0)
PKGS = ("xlayer_prover_tpu_torch", "xlayer_prover_tpu")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def seeded_kvs(n: int, seed: int):
    """n keys (4 limbs below p, as Poseidon outputs) and 256-bit values."""
    rng = np.random.default_rng(seed)
    keys = [tuple(int(x) for x in row)
            for row in rng.integers(0, P, (n, 4), dtype=np.uint64)]
    values = [int.from_bytes(rng.bytes(32), "little") or 1
              for _ in range(n)]
    return dict(zip(keys, values))


def edits(kvs: dict, seed: int) -> dict:
    """Updates and deletes (value 0) of a third of the keys, plus new
    keys."""
    rng = np.random.default_rng(seed)
    keys = list(kvs)
    out = {}
    for i in rng.permutation(len(keys))[:max(1, len(keys) // 3)]:
        out[keys[i]] = 0 if i % 2 else kvs[keys[i]] ^ 0xABCDEF
    out.update(seeded_kvs(max(1, len(keys) // 5), seed + 1))
    return out


def files_equal(a: str, b: str, suffixes):
    for s in suffixes:
        assert os.path.getsize(a + s) == os.path.getsize(b + s), s
        assert filecmp.cmp(a + s, b + s, shallow=False), s


# ---------------------------------------------------------------------------
# page pool and KV tree
# ---------------------------------------------------------------------------

def pm_script(pm):
    """COW edits, flush, discard and growth past the initial pages."""
    pages = [pm.get_free_page() for _ in range(5)]
    for i, p in enumerate(pages):
        pm.write_page(p, bytes([i + 1]) * (100 + i))
    shadow = pm.edit_page(pages[1])
    pm.write_page(shadow, b"edited")
    pm.flush()
    other = pm.edit_page(pages[2])
    pm.write_page(other, b"scrap")
    pm.discard()
    more = [pm.get_free_page() for _ in range(12)]
    for p in more:
        pm.write_page(p, p.to_bytes(8, "little") * 10)
    pm.flush()
    return pages + [shadow, other] + more, sorted(pm.free_list), pm.watermark


def test_page_manager_files_equal(tmp_path):
    got = {}
    for name, cls in (("t", PageManager), ("j", jpm.PageManager)):
        pm = cls(str(tmp_path / name), initial_pages=8)
        got[name] = pm_script(pm)
        assert pm.n_pages == 32
    assert got["t"] == got["j"]
    files_equal(str(tmp_path / "t"), str(tmp_path / "j"), ("", ".wm"))
    # the memory pool makes the same choices
    assert pm_script(PageManager(initial_pages=8)) == \
        pm_script(jpm.PageManager(initial_pages=8))


@pytest.mark.parametrize("opener", ["port", "jax"])
def test_page_manager_reopens_the_others_file(tmp_path, opener):
    """A pool written by one package, reopened by the other: the pages
    read back and no live page is handed out again."""
    writer = jpm.PageManager if opener == "port" else PageManager
    reader = PageManager if opener == "port" else jpm.PageManager
    path = str(tmp_path / "pool")
    pm = writer(path, initial_pages=8)
    live = [pm.get_free_page() for _ in range(11)]
    for p in live:
        pm.write_page(p, b"page-%d" % p)
    pm.flush()
    pm2 = reader(path, initial_pages=8)
    for p in live:
        assert pm2.read_page(p)[:8].rstrip(b"\x00") == b"page-%d" % p
        assert len(pm2.read_page(p)) == PAGE_SIZE
    assert pm2.get_free_page() not in live


def test_page_manager_watermark_runs_ahead_between_flushes(tmp_path):
    """The sidecar never lies below the pages in use; at flush it holds
    the watermark exactly, as the JAX package's does."""
    path = str(tmp_path / "pool")
    pm = PageManager(path, initial_pages=8)
    for _ in range(20):
        pm.get_free_page()
    with open(path + ".wm", "rb") as f:
        assert int.from_bytes(f.read(), "little") >= pm.watermark
    pm.flush()
    with open(path + ".wm", "rb") as f:
        assert int.from_bytes(f.read(), "little") == pm.watermark == 21
    pm.close()


def kv_script(t, rng):
    """Version history with leaf splits: versions 1-3, overwrites, keys
    that share their high nibbles (deep paths)."""
    keys = [int(k) for k in rng.integers(0, 1 << 62, 200, dtype=np.int64)]
    for i, k in enumerate(keys[:150]):
        t.write(1, k << 192, i + 1)
    t.write(2, keys[0] << 192, 999)
    for i, k in enumerate(keys[150:]):
        t.write(2, (5 << 250) | k, i + 7)
    t.write(3, 42, 4242)
    t.flush()
    probe = [k << 192 for k in keys[:160]] + [(5 << 250) | k
                                              for k in keys[150:]] + [42, 7]
    return [[t.read(v, k) for k in probe] for v in (1, 2, 3, 9)]


def test_kv_tree_files_equal(tmp_path):
    reads = {}
    for name, tree, pool in (("t", KeyValueTree, PageManager),
                             ("j", jkv.KeyValueTree, jpm.PageManager)):
        t = tree(pool(str(tmp_path / name)))
        reads[name] = kv_script(t, np.random.default_rng(3))
        assert t.latest_version == 3
    assert reads["t"] == reads["j"]
    assert reads["t"][0][0] == 1 and reads["t"][1][0] == 999
    assert reads["t"][2][-2:] == [4242, None]
    files_equal(str(tmp_path / "t"), str(tmp_path / "j"), ("", ".wm"))
    # each package reopens the other's tree
    for name, tree, pool in (("j", KeyValueTree, PageManager),
                             ("t", jkv.KeyValueTree, jpm.PageManager)):
        again = tree(pool(str(tmp_path / name)))
        assert again.latest_version == 3
        assert again.versions == KeyValueTree(
            PageManager(str(tmp_path / name))).versions
    rng = np.random.default_rng(3)
    keys = [int(k) for k in rng.integers(0, 1 << 62, 200, dtype=np.int64)]
    reopened = KeyValueTree(PageManager(str(tmp_path / "j")))
    assert [reopened.read(1, k << 192) for k in keys[:150]] == \
        list(range(1, 151))


def test_kv_tree_refuses_an_older_version():
    t = KeyValueTree()
    t.write(2, 1, 1)
    with pytest.raises(ValueError, match="monotonic"):
        t.write(1, 1, 2)


# ---------------------------------------------------------------------------
# keys, chunks and the level hasher
# ---------------------------------------------------------------------------

def test_key_helpers_equal():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, P, (40, 4), dtype=np.uint64)
    for level in (0, 6, 12, 42, 252, 258):
        assert smt64_hash.slots6(keys, level).tolist() == \
            [J.key_bits6(tuple(int(x) for x in k), level) for k in keys]
    n_bits = rng.integers(0, 260, 40)
    got = smt64_hash.remove_key_bits_np(keys, n_bits)
    for k, n, g in zip(keys, n_bits, got):
        k = tuple(int(x) for x in k)
        assert tuple(int(x) for x in g) == J.remove_key_bits(k, int(n)) \
            == T.remove_key_bits(k, int(n))
        assert T.key_bits6(k, 18) == J.key_bits6(k, 18)


def chunk_of(cls, child_cls, rng, level: int):
    chunk = cls(level)
    for slot in rng.permutation(64)[:9]:
        if slot % 3 == 0:
            continue
        if slot % 2:
            chunk.children[slot] = child_cls(
                type=2, key=tuple(int(x) for x in rng.integers(
                    0, P, 4, dtype=np.uint64)),
                value=int.from_bytes(rng.bytes(32), "little"))
        else:
            chunk.children[slot] = child_cls(
                type=3, hash=tuple(int(x) for x in rng.integers(
                    0, P, 4, dtype=np.uint64)))
    return chunk


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tree_chunk_codec_and_hash_equal(seed):
    """Codec round trips in both packages, the same bytes, each decodes
    the other's; the per-chunk hash (host Poseidon) equals the JAX one."""
    port = chunk_of(T.TreeChunk, T.Child, np.random.default_rng(seed), 12)
    jax = chunk_of(J.TreeChunk, J.Child, np.random.default_rng(seed), 12)
    data = port.encode()
    assert data == jax.encode()
    back = T.TreeChunk.decode(data, 12)
    assert back.encode() == data
    assert [(c.type, c.key, c.value, c.hash) for c in back.children] == \
        [(c.type, c.key, c.value, c.hash)
         for c in J.TreeChunk.decode(data, 12).children]
    top_p, h_p = port.calculate_hash()
    top_j, h_j = jax.calculate_hash()
    assert h_p == h_j and top_p.type == top_j.type


def test_lone_leaf_chunk_hash():
    """A chunk holding one leaf hashes it at the chunk's own level."""
    for level in (0, 6):
        chunks = []
        for cls, child in ((T.TreeChunk, T.Child), (J.TreeChunk, J.Child)):
            c = cls(level)
            c.children[17] = child(type=2, key=(5, 6, 7, 8), value=99)
            chunks.append(c.calculate_hash()[1])
        assert chunks[0] == chunks[1] == J._leaf_hash((5, 6, 7, 8), 99,
                                                      level)


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 1 << 10])
def test_level_hasher_equals_jax_smt64(n):
    """Root and every stored chunk (bytes and write order) of the port's
    set_many equal the JAX Smt64's, before and after updates and
    deletes; the reads and the leaves' order equal too."""
    kvs = seeded_kvs(n, n)
    dj, dt = J.Database64(), T.Database64()
    sj, st = J.Smt64(dj), T.Smt64(dt, "cpu")
    rj, rt = sj.set_many(ZERO4, kvs), st.set_many(ZERO4, kvs)
    assert rt == rj
    assert list(dt.chunks.items()) == list(dj.chunks.items())
    change = edits(kvs, n + 100)
    rj2, rt2 = sj.set_many(rj, change), st.set_many(rt, change)
    assert rt2 == rj2 and rt2 != rt
    assert list(dt.chunks.items()) == list(dj.chunks.items())
    assert list(st.leaves_of(rt2).items()) == list(sj.leaves_of(rj2).items())
    probe = list(kvs)[:50] + list(change)[:50] + [(1, 2, 3, 4)]
    assert [st.get(rt2, k) for k in probe] == [sj.get(rj2, k) for k in probe]


def test_level_hasher_deletes_to_a_lone_leaf_and_to_empty():
    kvs = seeded_kvs(3, 9)
    keys = list(kvs)
    st, sj = T.Smt64(T.Database64(), "cpu"), J.Smt64(J.Database64())
    r = st.set_many(ZERO4, kvs)
    one = {keys[0]: 0, keys[1]: 0}
    assert st.set_many(r, one) == sj.set_many(sj.set_many(ZERO4, kvs), one)
    assert st.set_many(r, dict.fromkeys(keys, 0)) == ZERO4


def test_level_hasher_counts_its_launches(monkeypatch):
    """Two launches for the leaves, then one a level of nodes, deepest
    first: each level's nodes in one permutation call."""
    from xlayer_prover_tpu_torch.ops import poseidon_gl
    sizes = []
    plain = poseidon_gl.permute

    def counted(state):
        sizes.append(state.shape[0])
        return plain(state)

    monkeypatch.setattr(poseidon_gl, "permute", counted)
    kvs = seeded_kvs(200, 4)
    root = T.Smt64(T.Database64(), "cpu").set_many(ZERO4, kvs)
    assert root == J.Smt64(J.Database64()).set_many(ZERO4, kvs)
    assert sizes[:2] == [200, 200]
    # a node per pair of leaves that meet, or leaf and node, fewer than n
    assert 2 < len(sizes) < 40 and sum(sizes[2:]) < 2 * 200


def test_smt64_device_is_resolved():
    """The card is the default: without one, construction raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for build in (lambda: T.Smt64(T.Database64()),
                  lambda: T.HashDB64(),
                  lambda: T.HashDB64(device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


# ---------------------------------------------------------------------------
# StateManager64, HashDB64 on files
# ---------------------------------------------------------------------------

def test_state_manager64_workflow_equal():
    kvs = seeded_kvs(30, 21)
    out = []
    for sm in (T.StateManager64(device="cpu"), J.StateManager64()):
        got = []
        for i, (k, v) in enumerate(kvs.items()):
            got.append(sm.set("b1", k, v))
            assert sm.get("b1", k) == v
            sm.finish_tx("b1")
            sm.finish_block("b1")
        sm.purge("b1")
        root = sm.consolidate_state("b1")
        got.append(root)
        got.append([sm.get("b2", k) for k in kvs])
        k0 = list(kvs)[0]
        got.append(sm.db.read_kv(1, T._packed(k0)))
        # rollback of the last tx, then cancel of another batch
        keys = list(kvs)
        sm.set("b3", keys[0], 5)
        sm.finish_tx("b3")
        sm.set("b3", keys[1], 0)
        sm.rollback_tx("b3")
        got.append(sm.consolidate_state("b3"))
        sm.set("b4", keys[2], 77)
        sm.cancel_batch("b4")
        got.append(("b4" in sm.state, sm.get("b5", keys[2]),
                    sm.get("b5", keys[1]), sm.get("b5", keys[0])))
        out.append(got)
    assert out[0] == out[1]
    assert out[0][-1] == (False, kvs[list(kvs)[2]], kvs[list(kvs)[1]], 5)


def hashdb64_script(h, kvs, change):
    """write_tree, a batch of sets with virtual roots, consolidation, a
    program, reads at old and new roots."""
    out = [h.write_tree(ZERO4, list(kvs.items()))]
    root = out[0]
    for k, v in change.items():
        res = h.set("b1", root, k, v)
        out.append((res.old_root, res.new_root, res.mode))
        root = res.new_root
    out.append(h.get("b1", root, list(change)[0]).value)
    out.append(h.consolidate("b1"))
    h.set_program("b1", (1, 2, 3, 4), b"\x60\x80" * 3000)
    h.db64.flush()
    for r in (out[0], out[-1]):
        out.append([h.get("r", r, k).value for k in list(kvs)[:40]])
    return out


def test_hashdb64_files_equal_and_reopen(tmp_path):
    """The same operations give byte-equal .blob and .kv files and their
    sidecars; each package reopens the other's files with the same
    reads; the port reopens either at the latest root (the JAX reopen
    starts at the zero root)."""
    kvs = seeded_kvs(300, 31)
    change = edits(kvs, 32)
    tp, jp = str(tmp_path / "t"), str(tmp_path / "j")
    ht = T.HashDB64(path=tp, device="cpu")
    got_t = hashdb64_script(ht, kvs, change)
    ht.close()
    got_j = hashdb64_script(J.HashDB64(path=jp), kvs, change)
    assert got_t == got_j
    latest = got_t[len(change) + 2]
    files_equal(tp, jp, (".blob", ".blob.wm", ".kv", ".kv.wm"))
    probe = list(kvs)[:30] + list(change)[:30]
    for path in (tp, jp):
        port = T.HashDB64(path=path, device="cpu")
        jax = J.HashDB64(path=path)
        assert port.get_latest_state_root() == latest
        assert jax.get_latest_state_root() == ZERO4
        assert [port.sm.smt.get(latest, k) for k in probe] == \
            [jax.sm.smt.get(latest, k) for k in probe]
        assert port.get_program(None, (1, 2, 3, 4)) == \
            jax.get_program(None, (1, 2, 3, 4)) == b"\x60\x80" * 3000
        # the reopened port store takes the next consolidation
        port.set("b2", latest, list(kvs)[0], 3)
        # the JAX package reopens at the zero root and KV version 0
        jax.sm.last_consolidated = latest
        jax.db64.version = jax.db64.kv.latest_version
        jax.set("b2", latest, list(kvs)[0], 3)
        assert port.consolidate("b2") == jax.consolidate("b2")
        port.close()


def test_hashdb64_reopens_an_emptied_state_at_zero(tmp_path):
    path = str(tmp_path / "h")
    kvs = seeded_kvs(5, 41)
    h = T.HashDB64(path=path, device="cpu")
    root = h.write_tree(ZERO4, list(kvs.items()))
    h.close()
    h = T.HashDB64(path=path, device="cpu")
    assert h.get_latest_state_root() == root
    for k in kvs:
        h.set("b", root, k, 0)
    assert h.consolidate("b") == ZERO4
    h.close()
    assert T.HashDB64(path=path, device="cpu").get_latest_state_root() \
        == ZERO4


def test_write_tree_refuses_as_the_jax_package():
    kvs = seeded_kvs(4, 51)
    for h in (T.HashDB64(device="cpu"), J.HashDB64()):
        with pytest.raises(ValueError, match="no keyValues"):
            h.write_tree(ZERO4, [])
        h.write_tree(ZERO4, list(kvs.items()))
        with pytest.raises(ValueError, match="not the latest"):
            h.write_tree((1, 2, 3, 4), list(kvs.items()))


# ---------------------------------------------------------------------------
# the HashDB service over the 64 backend
# ---------------------------------------------------------------------------

def test_hashdb_service_with_hashdb64_equal(tmp_path):
    """The RPC script of test_torch_entry_services over each package's
    HashDB service with a HashDB64 backend on a file: equal answers."""
    from tests.test_torch_entry_services import hashdb_script, served
    answers = {}
    for pkg in PKGS:
        svc = mod(pkg, "services.hashdb_service")
        kw = {"device": "cpu"} if pkg == PKGS[0] else {}
        backend = mod(pkg, "state.hashdb64").HashDB64(
            path=str(tmp_path / pkg), **kw)
        with served(svc.HashDBServer(svc.HashDBServiceImpl(backend))) \
                as (_s, ch):
            answers[pkg] = hashdb_script(ch)
    port, jax = (answers[p] for p in PKGS)
    assert [n for n, _ in port] == [n for n, _ in jax]
    for (name, a), (_, b) in zip(port, jax):
        assert a == b, name


@pytest.mark.parametrize("pkg", PKGS)
def test_consolidate_state_unknown_virtual_root(pkg):
    """ConsolidateState of a virtual root no batch publishes answers
    CODE_DB_KEY_NOT_FOUND with a zero root; a known one its real root."""
    from tests.test_torch_entry_services import _rpc, served
    from xlayer_prover_tpu_torch.services import hashdb_service as phs
    from xlayer_prover_tpu_torch.services.gen import hashdb_pb2 as hpb
    svc = mod(pkg, "services.hashdb_service")
    kw = {"device": "cpu"} if pkg == PKGS[0] else {}
    backend = mod(pkg, "state.hashdb64").HashDB64(**kw)
    kvs = seeded_kvs(3, 61)
    with served(svc.HashDBServer(svc.HashDBServiceImpl(backend))) \
            as (_s, ch):
        consolidate = _rpc(ch, "ConsolidateState",
                           hpb.ConsolidateStateRequest,
                           hpb.ConsolidateStateResponse)
        req = hpb.ConsolidateStateRequest()
        phs._set_fea(req.virtual_state_root, (99, 99, 0, T.VIRTUAL_TAG))
        resp = consolidate(req, timeout=60)
        assert resp.result.code == hpb.ResultCode.CODE_DB_KEY_NOT_FOUND
        assert phs._fea(resp.consolidated_state_root) == ZERO4
        vroot = ZERO4
        for k, v in kvs.items():
            vroot = backend.set("b1", vroot, k, v).new_root
        phs._set_fea(req.virtual_state_root, vroot)
        resp = consolidate(req, timeout=60)
        assert resp.result.code == hpb.ResultCode.CODE_SUCCESS
        assert phs._fea(resp.consolidated_state_root) == \
            J.Smt64(J.Database64()).set_many(ZERO4, kvs)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14 on the CPU
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_phase_state_on_the_cpu(tmp_path):
    """chip_smoke.py phase 14 at 2^10 leaves with --device cpu: write_tree
    and a consolidation in this process, the HashDB64 services process
    over the reopened file and the two sqlite processes (load, flush,
    SIGINT; warm restart), every root, read and flush id equal to the
    JAX package's (tools/torch_proof_fixtures.state64_fixture at the same
    size)."""
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke
    from tools import torch_proof_fixtures as fixtures
    want = fixtures.state64_fixture(1 << 10)
    launches, report, values = chip_smoke.phase_state(
        torch, want, device="cpu", out_dir=str(tmp_path / "state"))
    assert len(values) == report["keys"] == 1 << 10
    assert launches["poseidon_permute"] == 0     # plain on the CPU
    assert report["warmed"] == want["sqlite"]["warm"]["warmed"] > 0
    assert want["sqlite"]["first"]["flush"] == [1, 1]
    assert report["bytes_after_consolidate"][".kv"] > \
        report["bytes_after_write_tree"][".blob"] > 0


def test_state_case_mix():
    """The phase's seeded batches: 3/4 updates, 1/8 deletes, 1/8 new
    keys; reads of present, new and absent keys."""
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke
    case = chip_smoke.state_case(1 << 12)
    keys = set(case["keys"])
    batch = case["batch"]
    assert len(batch) == 1024 and len(case["rpc_batch"]) == 256
    assert sum(v == 0 for v in batch.values()) == 128
    assert sum(k not in keys for k in batch) == 128
    assert len(case["reads"]) == 256 and len(set(case["reads"])) == 256
    assert sum(k in keys for k in case["reads"]) == 256 - 32
    assert chip_smoke.state_case(1 << 12) == case


@pytest.mark.slow
def test_state_fixture_is_the_jax_package_s():
    """tests/data/state64_2e18.json made again with the JAX package
    (~1-2 min)."""
    import json
    import sys
    sys.path.insert(0, ROOT)
    from tools import torch_proof_fixtures as fixtures
    with open(os.path.join(ROOT, "tests", "data", "state64_2e18.json")) as f:
        assert json.load(f) == fixtures.state64_fixture()
