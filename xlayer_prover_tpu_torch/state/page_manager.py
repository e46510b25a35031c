"""Paged state backend: 4 KB page pool with copy-on-write editing.

The port's own copy of ``xlayer_prover_tpu/state/page_manager.py``
(reference hashdb64 PageManager, src/hashdb64/page/page_manager.hpp:20-50):
a memory- or file-backed pool of 4 KB pages with a free heap, capacity
that doubles, and ``edit_page`` copy-on-write semantics — editing a page
under an open write generation returns a fresh shadow page; ``flush``
publishes the edited set and recycles the originals.

The pool file and its watermark sidecar (``<path>.wm``, one little-endian
u64) hold the JAX package's bytes after the same operations and a
``flush``, so either package opens the other's files.  Two things differ
in how the bytes get there, both for the bulk writes of a 2^18-key state
(about a million pages):

  * the sidecar is written when an allocation passes the value it holds,
    and then ``WM_RESERVE`` pages ahead, and exactly at ``flush`` and
    ``close``: the JAX package wrote and fsynced it at every allocation.
    The value on disk is never below the pages in use, so a reopen after a
    crash still hands out no live page (it may skip up to WM_RESERVE
    unused ones);
  * the file is opened with a 1 MiB buffer and a write at the current
    position takes no seek, so pages written in allocation order go out
    in large sequential writes.
"""

from __future__ import annotations

import heapq
import os
import struct
import threading
from typing import Dict, List, Optional

PAGE_SIZE = 4096
WM_RESERVE = 1 << 16       # pages the sidecar runs ahead of the watermark
_BUFFER = 1 << 20


class PageManager:
    def __init__(self, path: Optional[str] = None, initial_pages: int = 64):
        self._lock = threading.RLock()
        self.path = path
        self._pos = -1             # the file's position, -1 when unknown
        if path and os.path.exists(path):
            size = os.path.getsize(path)
            self._file = open(path, "r+b", buffering=_BUFFER)
            self.n_pages = max(size // PAGE_SIZE, initial_pages)
            # pages below the persisted watermark may hold live data from
            # a previous open; a file without a sidecar counts every page
            # it holds as used
            self.watermark = self._read_watermark(
                default=max(size // PAGE_SIZE, 1))
            self._wm_saved = self.watermark
        elif path:
            self._file = open(path, "w+b", buffering=_BUFFER)
            self.n_pages = initial_pages
            self._file.truncate(self.n_pages * PAGE_SIZE)
            self.watermark = 1
            self._save_watermark(1)
        else:
            self._file = None
            self.n_pages = initial_pages
            self._mem: Dict[int, bytes] = {}
            self.watermark = 1
            self._wm_saved = 1
        # page 0 is the header and never freed; a min-heap, so allocation
        # is lowest-first and the watermark stays tight
        self.free_list: List[int] = list(range(self.watermark, self.n_pages))
        heapq.heapify(self.free_list)
        self.edited: Dict[int, int] = {}   # original -> shadow (open gen)

    # -- allocation-watermark persistence ---------------------------------
    def _wm_path(self) -> str:
        return self.path + ".wm"

    def _read_watermark(self, default: int) -> int:
        try:
            with open(self._wm_path(), "rb") as f:
                (wm,) = struct.unpack("<Q", f.read(8))
            return max(1, wm)
        except (OSError, struct.error):
            return default

    def _save_watermark(self, value: int):
        self._wm_saved = value
        if not self.path:
            return
        with open(self._wm_path(), "wb") as f:
            f.write(struct.pack("<Q", value))
            f.flush()
            os.fsync(f.fileno())

    # -- raw page IO ----------------------------------------------------
    def read_page(self, idx: int) -> bytes:
        with self._lock:
            self._check(idx)
            if self._file is not None:
                self._file.seek(idx * PAGE_SIZE)
                data = self._file.read(PAGE_SIZE)
                self._pos = -1
                return data.ljust(PAGE_SIZE, b"\x00")
            return self._mem.get(idx, bytes(PAGE_SIZE))

    def write_page(self, idx: int, data: bytes):
        with self._lock:
            self._check(idx)
            if len(data) > PAGE_SIZE:
                raise ValueError(f"page data of {len(data)} bytes")
            data = bytes(data).ljust(PAGE_SIZE, b"\x00")
            if self._file is not None:
                if self._pos != idx * PAGE_SIZE:
                    self._file.seek(idx * PAGE_SIZE)
                self._file.write(data)
                self._pos = (idx + 1) * PAGE_SIZE
            else:
                self._mem[idx] = data

    def _check(self, idx: int):
        if not (0 <= idx < self.n_pages):
            raise IndexError(f"page {idx} out of range (n={self.n_pages})")

    # -- allocation -----------------------------------------------------
    def get_free_page(self) -> int:
        with self._lock:
            if not self.free_list:
                self._grow()
            idx = heapq.heappop(self.free_list)
            if idx >= self.watermark:
                self.watermark = idx + 1
                if self.watermark > self._wm_saved:
                    self._save_watermark(self.watermark + WM_RESERVE)
            return idx

    def release_page(self, idx: int):
        with self._lock:
            self._check(idx)
            if idx == 0:
                raise ValueError("cannot free the header page")
            heapq.heappush(self.free_list, idx)

    def _grow(self):
        old = self.n_pages
        self.n_pages = old * 2
        if self._file is not None:
            self._file.truncate(self.n_pages * PAGE_SIZE)
        for idx in range(old, self.n_pages):
            heapq.heappush(self.free_list, idx)

    @property
    def n_free(self):
        with self._lock:
            return len(self.free_list)

    # -- copy-on-write editing ------------------------------------------
    def edit_page(self, idx: int) -> int:
        """Returns the writable shadow of `idx` for the open generation
        (allocating and copying on first edit; header page edits in place)."""
        with self._lock:
            if idx == 0:
                return 0
            if idx in self.edited:
                return self.edited[idx]
            shadow = self.get_free_page()
            self.write_page(shadow, self.read_page(idx))
            self.edited[idx] = shadow
            return shadow

    def flush(self):
        """Publish the open generation: shadows become canonical, originals
        are recycled; the file and the exact watermark reach the disk."""
        with self._lock:
            for original in list(self.edited.keys()):
                self.release_page(original)
            self.edited.clear()
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                if self._wm_saved != self.watermark:
                    self._save_watermark(self.watermark)

    def discard(self):
        """Abort the open generation: recycle all shadows."""
        with self._lock:
            for shadow in self.edited.values():
                self.release_page(shadow)
            self.edited.clear()

    def close(self):
        """Flush and close the file (a memory pool just flushes)."""
        with self._lock:
            self.flush()
            if self._file is not None:
                self._file.close()
                self._file = None
