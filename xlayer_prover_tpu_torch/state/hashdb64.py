"""hashdb64: the paged 64-ary state backend (reference src/hashdb64/).

The port's own copy of ``xlayer_prover_tpu/state/hashdb64.py``.  State is
stored as TreeChunks of 6 SMT levels = 64 children, each child zero, a
leaf (key, value) or an intermediate (the hash of a deeper chunk)
(tree_chunk.hpp:20-60).  Chunks serialize into blobs held by Database64
(the raw-data page analogue, ``PagedStore``); version history rides the
KeyValueTree (kv_tree.py).  StateManager64 keeps per-batch states with
VIRTUAL state roots — sets during a batch don't hash; consolidation
recomputes the real root and persists (state_manager_64.hpp:102,
consolidateState).

Hash semantics match the classic SMT exactly (leaf: Poseidon(rkey,
Poseidon(value8, cap 0), cap 1); intermediate: Poseidon(l, r, cap 0);
single-leaf subtrees bubble up — tree_chunk.cpp calculateChild), so the
consolidated root of a key-value set equals the classic smt.py root for
the same data.

What differs from the JAX package (the roots, the chunk bytes and the
files are its own):

  * ``Smt64.set_many`` hashes all its chunks a tree level at a time
    through ``smt64_hash.build`` (the ``poseidon_permute`` kernel on the
    card, its plain version on the CPU) on ``device``, which
    ``HashDB64``, ``StateManager64`` and ``Smt64`` take (``None``: the
    card); ``TreeChunk.calculate_hash`` stays a per-chunk hash through
    the host Poseidon, for the tests;
  * ``leaves_of`` and ``get`` read a chunk's children straight from its
    bytes, and ``PagedStore.put_many`` appends a consolidation's records
    in one pass, leaving the pages a ``put`` each would;
  * ``HashDB64(path)`` reopens at the latest consolidated root, where
    the JAX package's reopen starts at the zero root: the root of the
    last chunk record in the log, unless the KV history's latest version
    deleted that tree's leaves (an emptied state); and a reopened
    ``Database64`` numbers its next KV version after the file's latest,
    where the JAX package's starts again at 1, below the file's, and its
    KV tree refuses the write.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import device as dev
from ..ops.poseidon_gl import host_permute
from . import smt64_hash
from .kv_tree import KeyValueTree
from .page_manager import PageManager

P = (1 << 64) - (1 << 32) + 1

CHUNK_LEVELS = smt64_hash.CHUNK_LEVELS
WIDTH = smt64_hash.WIDTH

ZERO, LEAF, INTERMEDIATE = smt64_hash.ZERO, smt64_hash.LEAF, \
    smt64_hash.INTERMEDIATE          # child.hpp ChildType values

_QUAD = struct.Struct("<4Q")
_HEADER = struct.Struct("<QQ")


def remove_key_bits(key4, n_bits: int) -> Tuple[int, int, int, int]:
    """Drop the first n_bits path bits (interleaved limb order) — the
    reference key_utils removeKeyBits."""
    out = []
    for j in range(4):
        used = n_bits // 4 + (1 if j < n_bits % 4 else 0)
        out.append(int(key4[j]) >> used)
    return tuple(out)


def key_bits6(key4, level: int) -> int:
    """The 6 path bits consumed at chunk level `level` (level multiple of
    6): bit i of the result = path bit level+i = key[(level+i) % 4] bit
    (level+i) // 4."""
    v = 0
    for i in range(6):
        b = level + i
        v |= ((int(key4[b % 4]) >> (b // 4)) & 1) << i
    return v


def _leaf_hash(key4, value: int, level: int) -> Tuple[int, ...]:
    v8 = [(value >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    vhash = host_permute(v8 + [0, 0, 0, 0])[:4]
    rkey = remove_key_bits(key4, level)
    return tuple(host_permute(list(rkey) + vhash + [1, 0, 0, 0])[:4])


def _node_hash(left4, right4) -> Tuple[int, ...]:
    return tuple(host_permute(list(left4) + list(right4)
                              + [0, 0, 0, 0])[:4])


@dataclasses.dataclass
class Child:
    type: int = ZERO
    key: tuple = None          # LEAF
    value: int = 0             # LEAF
    hash: tuple = None         # INTERMEDIATE


class TreeChunk:
    """64 children covering 6 SMT levels (tree_chunk.hpp)."""

    def __init__(self, level: int = 0):
        if level % CHUNK_LEVELS:
            raise ValueError(f"chunk level {level} is not a multiple of "
                             f"{CHUNK_LEVELS}")
        self.level = level
        self.children: List[Child] = [Child() for _ in range(WIDTH)]

    # -- codec (children2data / data2children) --------------------------
    # layout: u64 isZero bitmap | u64 isLeaf bitmap | per non-zero child:
    #   leaf -> 4 x u64 key limbs + 32-byte LE value
    #   intermediate -> 4 x u64 hash limbs
    def encode(self) -> bytes:
        is_zero = 0
        is_leaf = 0
        body = []
        for i, c in enumerate(self.children):
            if c.type == ZERO:
                is_zero |= 1 << i
            elif c.type == LEAF:
                is_leaf |= 1 << i
                body.append(_QUAD.pack(*[int(v) for v in c.key]))
                body.append(int(c.value).to_bytes(32, "little"))
            else:
                body.append(_QUAD.pack(*[int(v) for v in c.hash]))
        return _HEADER.pack(is_zero, is_leaf) + b"".join(body)

    @classmethod
    def decode(cls, data: bytes, level: int) -> "TreeChunk":
        chunk = cls(level)
        for i, kind, key, value in _children(data):
            chunk.children[i] = Child(type=LEAF, key=key, value=value) \
                if kind == LEAF else Child(type=INTERMEDIATE, hash=key)
        return chunk

    # -- hashing (tree_chunk.cpp calculateHash/calculateChild) -----------
    def calculate_hash(self) -> Tuple[Child, tuple]:
        """Returns (top child, hash4), one host permutation at a time (the
        tests' check of the level hasher).  A chunk whose subtree holds a
        single leaf bubbles the leaf up (the parent hashes it at ITS
        level), exactly like the classic SMT's sibling compression."""
        # children64 slots are little-endian path bits (bit 0 = the first
        # branch), so siblings at reduction step k differ in slot bit k:
        # pair row[i] with row[i + half], not adjacent entries.
        row = list(self.children)
        size = WIDTH
        rel = CHUNK_LEVELS              # relative level of `row`
        while size > 1:
            rel -= 1
            half = size // 2
            row = [self._calc_child(self.level + rel, row[i], row[i + half])
                   for i in range(half)]
            size = half
        top = row[0]
        if top.type == ZERO:
            return top, (0, 0, 0, 0)
        if top.type == LEAF:
            return top, _leaf_hash(top.key, top.value, self.level)
        return top, top.hash

    @staticmethod
    def _calc_child(level: int, left: Child, right: Child) -> Child:
        lt, rt = left.type, right.type
        if lt == ZERO and rt == ZERO:
            return right
        if lt == ZERO and rt == LEAF:
            return right                  # bubbles up
        if lt == LEAF and rt == ZERO:
            return left                   # bubbles up
        if lt == LEAF and rt == LEAF:
            lh = _leaf_hash(left.key, left.value, level + 1)
            rh = _leaf_hash(right.key, right.value, level + 1)
            return Child(type=INTERMEDIATE, hash=_node_hash(lh, rh))
        # at least one intermediate
        lh = (0, 0, 0, 0) if lt == ZERO else (
            _leaf_hash(left.key, left.value, level + 1) if lt == LEAF
            else left.hash)
        rh = (0, 0, 0, 0) if rt == ZERO else (
            _leaf_hash(right.key, right.value, level + 1) if rt == LEAF
            else right.hash)
        return Child(type=INTERMEDIATE, hash=_node_hash(lh, rh))


def _children(data: bytes):
    """A chunk's non-zero children from its bytes, in slot order: (slot,
    LEAF, key limbs, value) or (slot, INTERMEDIATE, hash limbs, None)."""
    is_zero, is_leaf = _HEADER.unpack_from(data, 0)
    rest = ~is_zero & ((1 << WIDTH) - 1)
    off = 16
    while rest:
        low = rest & -rest
        rest ^= low
        quad = _QUAD.unpack_from(data, off)
        if is_leaf & low:
            yield (low.bit_length() - 1, LEAF, quad,
                   int.from_bytes(data[off + 32:off + 64], "little"))
            off += 64
        else:
            yield low.bit_length() - 1, INTERMEDIATE, quad, None
            off += 32


def _child_at(data: bytes, slot: int):
    """(type, key or hash limbs, value) of one child, from the chunk's
    bytes: its offset counts the non-zero children below it."""
    is_zero, is_leaf = _HEADER.unpack_from(data, 0)
    bit = 1 << slot
    if is_zero & bit:
        return ZERO, None, 0
    below = ~is_zero & (bit - 1)
    off = 16 + 32 * below.bit_count() + 32 * (is_leaf & below).bit_count()
    quad = _QUAD.unpack_from(data, off)
    if is_leaf & bit:
        return LEAF, quad, int.from_bytes(data[off + 32:off + 64], "little")
    return INTERMEDIATE, quad, 0


class PagedStore:
    """Append-only record log over 4 KB PageManager pages: the raw-data
    page analogue of the reference's chunk persistence
    (src/hashdb64/page/raw_data_page.hpp).  Header page 0 carries
    (magic, head, tail, tail_off); data pages are [next:8][payload:4088];
    records are [kind:1][key:32][len:4][bytes].  Reopen replays the log
    into the in-memory index (latest record per (kind, key) wins)."""

    MAGIC = 0x34364244583131  # "11XDB64"
    PAYLOAD = 4096 - 8

    def __init__(self, pm):
        self.pm = pm
        self.index: Dict[tuple, bytes] = {}
        self.last_key: Dict[int, bytes] = {}   # kind -> its last record's
        hdr = pm.read_page(0)
        magic, head, tail, tail_off = struct.unpack("<QQQQ", hdr[:32])
        if magic == self.MAGIC:
            self.head, self.tail, self.tail_off = head, tail, tail_off
            self._replay()
        else:
            self.head = self.tail = pm.get_free_page()
            pm.write_page(self.head, b"\x00" * 8)
            self.tail_off = 0
            self._write_header()

    def _write_header(self):
        self.pm.write_page(0, struct.pack("<QQQQ", self.MAGIC, self.head,
                                          self.tail, self.tail_off))

    def _replay(self):
        parts = []
        page = self.head
        while True:
            data = self.pm.read_page(page)
            nxt = struct.unpack("<Q", data[:8])[0]
            if page == self.tail:
                parts.append(data[8:8 + self.tail_off])
                break
            parts.append(data[8:])
            if nxt == 0:
                break
            page = nxt
        stream = b"".join(parts)
        off = 0
        while off + 37 <= len(stream):
            kind = stream[off]
            key = stream[off + 1:off + 33]
            ln = struct.unpack_from("<I", stream, off + 33)[0]
            self.index[(kind, key)] = stream[off + 37:off + 37 + ln]
            self.last_key[kind] = key
            off += 37 + ln

    def put(self, kind: int, key32: bytes, data: bytes):
        self.put_many(kind, [(key32, data)])

    def put_many(self, kind: int, records):
        """Append (key32, data) records of one kind in order: the pages,
        the header and the index end as a ``put`` each leaves them (the
        JAX package writes the tail page and the header a record)."""
        rec = []
        for key32, data in records:
            key32, data = bytes(key32), bytes(data)
            self.index[(kind, key32)] = data
            self.last_key[kind] = key32
            rec.append(bytes([kind]) + key32 + struct.pack("<I", len(data))
                       + data)
        rec = b"".join(rec)
        if not rec:
            return
        pos = 0
        page_data = bytearray(self.pm.read_page(self.tail))
        while pos < len(rec):
            space = self.PAYLOAD - self.tail_off
            if space == 0:
                nxt = self.pm.get_free_page()
                page_data[0:8] = struct.pack("<Q", nxt)
                self.pm.write_page(self.tail, bytes(page_data))
                self.tail = nxt
                self.tail_off = 0
                page_data = bytearray(4096)
                continue
            take = min(space, len(rec) - pos)
            page_data[8 + self.tail_off:8 + self.tail_off + take] = \
                rec[pos:pos + take]
            self.tail_off += take
            pos += take
        self.pm.write_page(self.tail, bytes(page_data))
        self._write_header()

    def get(self, kind: int, key32: bytes) -> Optional[bytes]:
        return self.index.get((kind, bytes(key32)))

    def flush(self):
        self.pm.flush()


_K_CHUNK, _K_PROGRAM = 1, 2


def _key32(hash4) -> bytes:
    return _QUAD.pack(*[int(v) for v in hash4])


class Database64:
    """Chunk/program store + versioned KV history (database_64.hpp:65):
    chunk blobs keyed by their top hash; the KeyValueTree keeps
    (version, key) -> value history for readKV-style access.  With a
    `path`, chunks/programs persist through a PagedStore (``<path>.blob``)
    and the KV history through a file-backed PageManager (``<path>.kv``)
    — reopening the same path restores the full state (the production
    hashDB64 mode, config.hashdb64 / hashdb_folder).  ``nodes`` / ``write``
    take classic-node blobs sent by LoadDB (opaque to Smt64)."""

    def __init__(self, kv_tree: Optional[KeyValueTree] = None,
                 path: Optional[str] = None):
        self.chunks: Dict[tuple, bytes] = {}
        self.programs: Dict[tuple, bytes] = {}
        self.nodes: Dict[tuple, list] = {}
        self.store = None
        if path is not None:
            self.store = PagedStore(PageManager(path + ".blob"))
            if kv_tree is None:
                kv_tree = KeyValueTree(PageManager(path + ".kv"))
        self.kv = kv_tree if kv_tree is not None else KeyValueTree()
        self.version = self.kv.latest_version

    def write(self, key, value):
        self.nodes[tuple(int(v) for v in key)] = [int(x) for x in value]

    def write_chunk(self, hash4, data: bytes):
        self.write_chunks([(hash4, data)])

    def write_chunks(self, chunks):
        """(hash4, data) chunk blobs in order, as a ``write_chunk`` each."""
        chunks = [(tuple(int(v) for v in h), bytes(d)) for h, d in chunks]
        self.chunks.update(chunks)
        if self.store is not None:
            self.store.put_many(_K_CHUNK, [(_key32(h), d)
                                           for h, d in chunks])

    def read_chunk(self, hash4) -> Optional[bytes]:
        key = tuple(int(v) for v in hash4)
        hit = self.chunks.get(key)
        if hit is None and self.store is not None:
            hit = self.store.get(_K_CHUNK, _key32(key))
            if hit is not None:
                self.chunks[key] = hit
        return hit

    def last_chunk_hash(self) -> Optional[tuple]:
        """The key of the store's last chunk record (a consolidation writes
        its root chunk last), or None."""
        if self.store is None or _K_CHUNK not in self.store.last_key:
            return None
        return _QUAD.unpack(self.store.last_key[_K_CHUNK])

    def set_program(self, key4, data: bytes):
        self.programs[tuple(int(v) for v in key4)] = bytes(data)
        if self.store is not None:
            self.store.put(_K_PROGRAM, _key32(key4), data)

    def get_program(self, key4) -> Optional[bytes]:
        hit = self.programs.get(tuple(int(v) for v in key4))
        if hit is None and self.store is not None:
            hit = self.store.get(_K_PROGRAM, _key32(key4))
        return hit

    def flush(self):
        if self.store is not None:
            self.store.flush()

    def close(self):
        """Flush both page files and close them."""
        if self.store is not None:
            self.store.pm.close()
        self.kv.pm.close()

    def write_kv_version(self, kvs: Dict[int, int]) -> int:
        """Persist a consolidated generation into the KV history tree."""
        self.version += 1
        for k, v in kvs.items():
            self.kv.write(self.version, k, v)
        self.kv.flush()
        return self.version

    def read_kv(self, version: int, key: int) -> Optional[int]:
        return self.kv.read(version, key)


def _packed(key4) -> int:
    packed = 0
    for j in range(4):
        packed |= int(key4[j]) << (64 * j)
    return packed


class Smt64:
    """SMT get/set over TreeChunks (smt_64 semantics): the tree is a
    forest of 6-level chunks linked by intermediate hashes.  ``set_many``
    hashes on `device` (``None``: the card)."""

    def __init__(self, db: Database64, device=None):
        self.db = db
        self.device = dev.resolve(device)

    # -- helpers ----------------------------------------------------------
    def _collect(self, data: bytes, out: Dict[tuple, int]):
        for _slot, kind, quad, value in _children(data):
            if kind == LEAF:
                out[quad] = value
            else:
                sub = self.db.read_chunk(quad)
                if sub is not None:
                    self._collect(sub, out)

    def leaves_of(self, root4) -> Dict[tuple, int]:
        """All (key, value) pairs under a consolidated root, in the JAX
        package's order (depth first, slot order)."""
        out: Dict[tuple, int] = {}
        if all(int(v) == 0 for v in root4):
            return out
        top = self.db.read_chunk(root4)
        if top is not None:
            self._collect(top, out)
        return out

    def get(self, root4, key4) -> Tuple[int, int]:
        """Returns (value, level).  Walks chunk by chunk."""
        if all(int(v) == 0 for v in root4):
            return 0, 0
        level = 0
        cur_hash = root4
        key = tuple(int(v) for v in key4)
        while True:
            data = self.db.read_chunk(cur_hash)
            if data is None:
                return 0, level
            kind, quad, value = _child_at(data, key_bits6(key, level))
            if kind == ZERO:
                return 0, level
            if kind == LEAF:
                return (value, level) if quad == key else (0, level)
            cur_hash = quad
            level += CHUNK_LEVELS

    def set_many(self, root4, kvs: Dict[tuple, int]) -> tuple:
        """Apply a batch of (key4 -> value) writes to the tree under
        `root4`; returns the new consolidated root.  Zero values delete.
        Every chunk of the new tree is hashed (smt64_hash.build) and
        written, as the JAX package's recursion writes them."""
        leaves = self.leaves_of(root4)
        for k, v in kvs.items():
            k = tuple(int(x) for x in k)
            if int(v) == 0:
                leaves.pop(k, None)
            else:
                leaves[k] = int(v)
        if not leaves:
            return (0, 0, 0, 0)
        keys = np.array(list(leaves), dtype=np.uint64).reshape(-1, 4)
        root, chunks = smt64_hash.build(keys, list(leaves.values()),
                                        self.device)
        self.db.write_chunks(chunks)
        return root


# canonical GL limbs are < p, so a limb of 2^64-1 can never appear in a
# real root — the unambiguous virtual-root marker (the reference uses a
# string prefix, state_manager_64.hpp isVirtualStateRoot)
VIRTUAL_TAG = (1 << 64) - 1


@dataclasses.dataclass
class _BatchState64:
    uuid: str
    old_root: tuple = (0, 0, 0, 0)
    writes: dict = dataclasses.field(default_factory=dict)
    tx_marks: list = dataclasses.field(default_factory=list)
    virtual_counter: int = 0
    current_root: tuple = (0, 0, 0, 0)
    blocks: int = 0


class StateManager64:
    """Per-batch overlay with virtual state roots + consolidation
    (state_manager_64.hpp:102).  During a batch, set() returns VIRTUAL
    roots (tagged counters — the reference's virtual state strings);
    consolidate_state() recomputes the real chunk hashes, persists them
    through Database64 and publishes a KV-history version."""

    def __init__(self, db: Optional[Database64] = None, device=None):
        self.db = db if db is not None else Database64()
        self.smt = Smt64(self.db, device)
        self.state: Dict[str, _BatchState64] = {}
        self.last_consolidated: tuple = (0, 0, 0, 0)
        self._virtual_roots: Dict[tuple, str] = {}

    @staticmethod
    def is_virtual_root(root4) -> bool:
        return int(root4[3]) >= P

    def _batch(self, uuid: str) -> _BatchState64:
        st = self.state.get(uuid)
        if st is None:
            st = _BatchState64(uuid=uuid,
                               old_root=self.last_consolidated,
                               current_root=self.last_consolidated)
            self.state[uuid] = st
        return st

    def set_old_state_root(self, uuid: str, root4):
        st = self._batch(uuid)
        st.old_root = tuple(int(v) for v in root4)
        st.current_root = st.old_root

    # -- SMT ops ----------------------------------------------------------
    def set(self, uuid: str, key4, value: int) -> tuple:
        """Write under the batch overlay; returns a VIRTUAL root."""
        st = self._batch(uuid)
        st.writes[tuple(int(v) for v in key4)] = int(value)
        st.virtual_counter += 1
        vroot = (len(self.state), st.virtual_counter, 0, VIRTUAL_TAG)
        st.current_root = vroot
        return vroot

    def get(self, uuid: str, key4) -> int:
        st = self._batch(uuid)
        k = tuple(int(v) for v in key4)
        if k in st.writes:
            return st.writes[k]
        v, _level = self.smt.get(st.old_root, key4)
        return v

    def finish_tx(self, uuid: str):
        st = self._batch(uuid)
        st.tx_marks.append(dict(st.writes))

    def finish_block(self, uuid: str):
        self._batch(uuid).blocks += 1

    def rollback_tx(self, uuid: str):
        """Discard writes since the last finish_tx (tx revert)."""
        st = self._batch(uuid)
        st.writes = dict(st.tx_marks[-1]) if st.tx_marks else {}

    def cancel_batch(self, uuid: str):
        self.state.pop(uuid, None)

    def purge(self, uuid: str):
        """Reference purge: squash discarded substates — the overlay
        already holds only the final writes, so this is a no-op hook."""
        if uuid not in self.state:
            raise KeyError(f"unknown batch {uuid}")

    # -- consolidation ------------------------------------------------------
    def consolidate_state(self, uuid: str) -> tuple:
        """Recompute the real root from the batch writes, persist chunks
        and a KV-history version; returns the consolidated root."""
        st = self._batch(uuid)
        new_root = self.smt.set_many(st.old_root, st.writes)
        self.db.write_kv_version({_packed(k): v
                                  for k, v in st.writes.items()})
        self.last_consolidated = new_root
        st.current_root = new_root
        del self.state[uuid]
        return new_root


# ---------------------------------------------------------------------------
# HashDB facade over the 64 backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Smt64SetResult:
    old_root: tuple
    new_root: tuple
    key: tuple
    mode: str = "virtual"
    proof_hash_counter: int = 0


@dataclasses.dataclass
class Smt64GetResult:
    root: tuple
    key: tuple
    value: int
    found: bool
    proof_hash_counter: int = 0


class HashDB64:
    """HashDBInterface-shaped facade over StateManager64 + Database64 —
    the reference's hashDB64=true selection (hashdb_factory.cpp:11-31,
    database_64.hpp): batch writes return VIRTUAL roots instantly,
    consolidation computes the real chunk-hashed root on `device` (None:
    the card; ``device.resolve`` raises where there is none) and persists
    pages.  Drop-in for services.HashDBServiceImpl(hashdb=...) and for the
    executor's ctx.hashdb surface (set/get/set_program/get_program/
    consolidate/discard).  With a `path`, a reopen restores the latest
    consolidated root."""

    def __init__(self, path: Optional[str] = None, device=None):
        self.db64 = Database64(path=path)
        self.sm = StateManager64(self.db64, device)
        self.db = self.db64          # LoadDB/LoadProgramDB target
        self.sm.last_consolidated = self._latest_on_disk()

    def _latest_on_disk(self) -> tuple:
        """The root of the last chunk record (each consolidation writes its
        root chunk last), or zero when there is none or when the KV
        history's latest version deleted the leaves of that tree."""
        root = self.db64.last_chunk_hash()
        if root is None:
            return (0, 0, 0, 0)
        data = self.db64.read_chunk(root)
        while True:
            _slot, kind, quad, value = next(_children(data))
            if kind == LEAF:
                break
            data = self.db64.read_chunk(quad)
        kv = self.db64.kv
        if kv.versions and not kv.read(kv.latest_version, _packed(quad)):
            return (0, 0, 0, 0)
        return root

    def set(self, batch_uuid, old_root, key, value) -> Smt64SetResult:
        uuid = batch_uuid or "default"
        st = self.sm._batch(uuid)
        old_root = tuple(int(v) for v in old_root)
        if st.current_root == st.old_root and not st.writes \
                and not StateManager64.is_virtual_root(old_root):
            self.sm.set_old_state_root(uuid, old_root)
        new_root = self.sm.set(uuid, key, int(value))
        return Smt64SetResult(old_root=old_root, new_root=new_root,
                              key=tuple(int(v) for v in key))

    def get(self, batch_uuid, root, key) -> Smt64GetResult:
        uuid = batch_uuid or "default"
        root = tuple(int(v) for v in root)
        st = self.sm._batch(uuid)
        if StateManager64.is_virtual_root(root):
            # reads through the overlay are only valid at the batch's
            # current virtual root — an older/unrelated virtual root would
            # silently observe later writes (reference binds reads to the
            # version of the given root, state_manager_64.hpp)
            if root != st.current_root:
                raise KeyError(f"unknown virtual root for batch {uuid}")
            value = self.sm.get(uuid, key)
        elif not st.writes:
            self.sm.set_old_state_root(uuid, root)
            value = self.sm.get(uuid, key)
        elif root == st.current_root:
            value = self.sm.get(uuid, key)
        else:
            # a real root that predates (or is unrelated to) the batch
            # overlay: resolve directly through the consolidated tree at
            # that root, not through the overlay's later writes
            value, _level = self.sm.smt.get(root, key)
        return Smt64GetResult(root=root, key=tuple(int(v) for v in key),
                              value=value, found=value != 0)

    def set_program(self, batch_uuid, key, data: bytes):
        self.db64.set_program(key, data)

    def get_program(self, batch_uuid, key) -> Optional[bytes]:
        return self.db64.get_program(key)

    def consolidate(self, batch_uuid: str) -> tuple:
        root = self.sm.consolidate_state(batch_uuid)
        self.db64.flush()
        return root

    def write_tree(self, old_root, key_values, persistent: bool = True):
        """Bulk key-value write from old_root -> new consolidated root
        (Database64::WriteTree, database_64.cpp:298-430): the old root
        must be the latest consolidated version (or zero on an empty
        tree); writes land as one new KV-history version."""
        old_root = tuple(int(v) for v in old_root)
        kvs = {}
        for key, value in key_values:
            kvs[tuple(int(v) for v in key)] = int(value)
        if not kvs:
            raise ValueError("writeTree called with no keyValues "
                             "(database_64.cpp:306-310)")
        if any(old_root) and old_root != self.sm.last_consolidated:
            raise ValueError(
                "writeTree old root is not the latest consolidated "
                f"version (database_64.cpp:344-348): {old_root} != "
                f"{self.sm.last_consolidated}")
        new_root = self.sm.smt.set_many(old_root, kvs)
        self.db64.write_kv_version({_packed(k): v for k, v in kvs.items()})
        self.sm.last_consolidated = new_root
        if persistent:
            self.db64.flush()
        return new_root

    def consolidate_virtual(self, vroot4) -> Optional[tuple]:
        """Resolve a virtual root to its consolidated real root (the
        ConsolidateState RPC): find the batch publishing that root."""
        vroot = tuple(int(v) for v in vroot4)
        for uuid, st in list(self.sm.state.items()):
            if st.current_root == vroot:
                return self.consolidate(uuid)
        return None

    def discard(self, batch_uuid: str):
        self.sm.cancel_batch(batch_uuid)

    def close(self):
        """Flush and close the page files."""
        self.db64.close()

    # -- HashDBInterface extras (hashdb_interface.hpp:21-40) -------------
    def get_latest_state_root(self) -> tuple:
        return self.sm.last_consolidated

    def start_block(self, batch_uuid: str, old_state_root, persistence=0):
        self.sm._batch(batch_uuid or "default")

    def finish_block(self, batch_uuid: str, new_state_root, persistence=0):
        self.sm.finish_block(batch_uuid or "default")

    def finish_tx(self, batch_uuid: str, new_state_root, persistence=0):
        self.sm.finish_tx(batch_uuid or "default")

    def get_flush_data(self, flush_id: int):
        return 0, {}, {}

    def read_tree(self, state_root, keys):
        root = tuple(int(v) for v in state_root)
        key_values = []
        for key in keys:
            v, _level = self.sm.smt.get(root, key)
            key_values.append((tuple(int(x) for x in key), v))
        return key_values, {}

    def clear_cache(self):
        pass

    def reset(self):
        self.sm.state.clear()
        self.sm.last_consolidated = (0, 0, 0, 0)
        self.db64.nodes.clear()
