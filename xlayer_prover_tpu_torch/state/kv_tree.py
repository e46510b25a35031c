"""Versioned 64-ary key-value tree over the paged backend.

The port's own copy of ``xlayer_prover_tpu/state/kv_tree.py`` (reference
hashdb64 KeyValueTree/LevelTree + root-version pages,
src/hashdb64/key_value_tree.hpp:12, level_tree.hpp,
page/root_version_page.hpp): 256-bit keys descend 6 bits per level (64
children per node), leaves hold packed (key, value) entries, and every
write generation publishes a new root page while prior roots stay
readable — copy-on-write paths.

Page layout (4 KB pages, PAGE_SIZE from page_manager), the JAX package's
byte for byte:
  * node page:  64 x u64 child slots; 0 = empty, else (page << 1) | leaf
  * leaf page:  u16 count + count x 64-byte (key32 | value32) entries,
                big-endian, and the marker 0xAB in the page's last byte
  * page 0:     root-version directory (u16 count + (u64 version,
                u64 root_page) records), persisted on flush

The pages are allocated and written in the JAX package's order.  What the
port adds is a cache of the pages this tree wrote that the latest version
still uses (decoded slots, and a leaf's entries beside their encoded
records): an insert reads its path from memory and writes its new pages
without decoding a page.  A 2^18-key ``write_tree`` makes about four new
pages a key, and the JAX package's reads and encodings took ~0.2 ms a key.
"""

from __future__ import annotations

import bisect
import struct
from typing import Dict, List, Optional, Tuple

from .page_manager import PAGE_SIZE, PageManager

FANOUT = 64
LEVEL_BITS = 6
LEAF_CAP = (PAGE_SIZE - 2) // 64
MAX_LEVELS = 256 // LEVEL_BITS + 1
LEAF_MARKER = 0xAB
_NODE = struct.Struct("<64Q")


def _nibble(key: int, level: int) -> int:
    shift = 256 - LEVEL_BITS * (level + 1)
    if shift < 0:
        return (key << -shift) & (FANOUT - 1)
    return (key >> shift) & (FANOUT - 1)


def _record(key: int, value: int) -> bytes:
    return key.to_bytes(32, "big") + value.to_bytes(32, "big")


class _Leaf:
    """A leaf page's entries sorted by key, with their encoded records."""

    __slots__ = ("keys", "values", "records")

    def __init__(self, keys: List[int], values: List[int],
                 records: List[bytes]):
        self.keys, self.values, self.records = keys, values, records

    @classmethod
    def of(cls, entries) -> "_Leaf":
        entries = sorted(entries)
        return cls([k for k, _ in entries], [v for _, v in entries],
                   [_record(k, v) for k, v in entries])

    def items(self) -> List[Tuple[int, int]]:
        return list(zip(self.keys, self.values))

    def page(self) -> bytes:
        body = struct.pack("<H", len(self.keys)) + b"".join(self.records)
        return body.ljust(PAGE_SIZE - 1, b"\x00") + bytes([LEAF_MARKER])


class KeyValueTree:
    """write(version, key, value) / read(version, key): version history
    with COW paths (old versions stay readable until pruned)."""

    def __init__(self, pm: Optional[PageManager] = None):
        self.pm = pm if pm is not None else PageManager()
        self.versions: Dict[int, int] = {}
        self.latest_version = 0
        # pages this tree wrote that the latest version still reaches:
        # page -> _Leaf, or page -> its 64 slots
        self._cache: Dict[int, object] = {}
        if self.pm.n_pages > 0:
            self._load_directory()

    # -- root-version directory (page 0) --------------------------------
    def _load_directory(self):
        raw = self.pm.read_page(0)
        (count,) = struct.unpack_from("<H", raw, 0)
        if count == 0 or count > (PAGE_SIZE - 2) // 16:
            return
        for i in range(count):
            v, root = struct.unpack_from("<QQ", raw, 2 + 16 * i)
            self.versions[v] = root
            self.latest_version = max(self.latest_version, v)

    def _save_directory(self):
        items = sorted(self.versions.items())[-(PAGE_SIZE - 2) // 16:]
        raw = bytearray(PAGE_SIZE)
        struct.pack_into("<H", raw, 0, len(items))
        for i, (v, root) in enumerate(items):
            struct.pack_into("<QQ", raw, 2 + 16 * i, v, root)
        self.pm.write_page(0, bytes(raw))

    # -- pages ------------------------------------------------------------
    def _put_leaf(self, leaf: _Leaf) -> int:
        idx = self.pm.get_free_page()
        self.pm.write_page(idx, leaf.page())
        self._cache[idx] = leaf
        return idx

    def _new_leaf(self, entries) -> int:
        return self._put_leaf(_Leaf.of(entries))

    def _leaf(self, idx: int) -> _Leaf:
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        raw = self.pm.read_page(idx)
        (count,) = struct.unpack_from("<H", raw, 0)
        return _Leaf.of([(int.from_bytes(raw[2 + 64 * i:34 + 64 * i], "big"),
                          int.from_bytes(raw[34 + 64 * i:66 + 64 * i], "big"))
                         for i in range(count)])

    def _new_node(self, slots) -> int:
        idx = self.pm.get_free_page()
        self.pm.write_page(idx, _NODE.pack(*slots))
        self._cache[idx] = slots
        return idx

    def _node_slots(self, idx: int) -> list:
        hit = self._cache.get(idx)
        if hit is not None:
            return list(hit)
        return list(_NODE.unpack_from(self.pm.read_page(idx), 0))

    def _is_leaf_probe(self, page: int) -> bool:
        """Roots are untagged: a leaf page has a count within LEAF_CAP and
        the marker byte at the page's end."""
        hit = self._cache.get(page)
        if hit is not None:
            return isinstance(hit, _Leaf)
        raw = self.pm.read_page(page)
        (count,) = struct.unpack_from("<H", raw, 0)
        if count > LEAF_CAP:
            return False
        return raw[PAGE_SIZE - 1] == LEAF_MARKER

    # -- operations -------------------------------------------------------
    def write(self, version: int, key: int, value: int):
        """Write under a version generation (>= latest); the prior
        version's tree stays intact (COW path)."""
        if version < self.latest_version:
            raise ValueError(f"version {version} is below the latest, "
                             f"{self.latest_version}: versions are "
                             "monotonic")
        base_root = self.versions.get(self.latest_version)
        if version not in self.versions:
            self.versions[version] = base_root if base_root is not None \
                else self._new_leaf([])
        self.latest_version = max(self.latest_version, version)
        root = self.versions[version]
        self.versions[version] = self._insert(root, key, value, 0)

    def _with(self, page: int, key: int, value: int):
        """The leaf at `page` with (key, value) put in: (the entries in the
        JAX package's dict order, the leaf's then the new key, None) when
        they overflow a leaf, else (None, the new sorted _Leaf); the old
        page leaves the cache."""
        leaf = self._leaf(page)
        self._cache.pop(page, None)
        i = bisect.bisect_left(leaf.keys, key)
        found = i < len(leaf.keys) and leaf.keys[i] == key
        if not found and len(leaf.keys) == LEAF_CAP:
            return leaf.items() + [(key, value)], None
        keys, values, records = (list(leaf.keys), list(leaf.values),
                                 list(leaf.records))
        if found:
            values[i], records[i] = value, _record(key, value)
        else:
            keys.insert(i, key)
            values.insert(i, value)
            records.insert(i, _record(key, value))
        return None, _Leaf(keys, values, records)

    def _insert(self, page: int, key: int, value: int, level: int) -> int:
        """Returns the new page index for this subtree (COW)."""
        if self._is_leaf_probe(page):
            entries, leaf = self._with(page, key, value)
            if leaf is not None:
                return self._put_leaf(leaf)
            return self._build_subtree(entries, level) >> 1
        slots = self._node_slots(page)
        self._cache.pop(page, None)
        nib = _nibble(key, level)
        slot = slots[nib]
        if slot == 0:
            child = self._new_leaf([(key, value)])
            slots[nib] = (child << 1) | 1
        elif slot & 1:
            entries, leaf = self._with(slot >> 1, key, value)
            slots[nib] = (self._put_leaf(leaf) << 1) | 1 \
                if leaf is not None \
                else self._build_subtree(entries, level + 1)
        else:
            slots[nib] = self._insert(slot >> 1, key, value, level + 1) << 1
        return self._new_node(slots)

    def _build_subtree(self, entries, level: int) -> int:
        """Pack entries into a subtree at `level`; returns a tagged slot
        (recursing while a nibble group still overflows a leaf)."""
        if len(entries) <= LEAF_CAP or level >= MAX_LEVELS - 1:
            if len(entries) > LEAF_CAP:
                raise ValueError("duplicate-key overflow")
            return (self._new_leaf(entries) << 1) | 1
        groups: Dict[int, list] = {}
        for k, v in entries:
            groups.setdefault(_nibble(k, level), []).append((k, v))
        slots = [0] * FANOUT
        for nib, group in groups.items():
            slots[nib] = self._build_subtree(group, level + 1)
        return self._new_node(slots) << 1

    def read(self, version: int, key: int) -> Optional[int]:
        root = self.versions.get(version)
        if root is None:
            # read at any version >= a published one sees the latest <= it
            cands = [v for v in self.versions if v <= version]
            if not cands:
                return None
            root = self.versions[max(cands)]
        page, is_leaf, level = root, self._is_leaf_probe(root), 0
        while True:
            if is_leaf:
                leaf = self._leaf(page)
                i = bisect.bisect_left(leaf.keys, key)
                if i < len(leaf.keys) and leaf.keys[i] == key:
                    return leaf.values[i]
                return None
            slot = self._node_slots(page)[_nibble(key, level)]
            if slot == 0:
                return None
            page, is_leaf = slot >> 1, bool(slot & 1)
            level += 1

    def flush(self):
        self._save_directory()
        self.pm.flush()
