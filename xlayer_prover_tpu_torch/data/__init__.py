"""The ROM bundles the port runs: the zkASM main ROM of forks 1-9 and the
Storage SM micro-ROM.

Byte-for-byte copies of the JAX package's vendored bundles
(``xlayer_prover_tpu/data/roms/``), each checked against the sha256 of its
uncompressed JSON in ``roms/MANIFEST.json`` when it is read.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os

_DATA_DIR = os.path.join(os.path.dirname(__file__), "roms")


def _load(name: str) -> dict:
    """The parsed JSON of bundle `name`, checksum-verified."""
    with open(os.path.join(_DATA_DIR, "MANIFEST.json")) as f:
        want = json.load(f)[name]["sha256"]
    with gzip.open(os.path.join(_DATA_DIR, name + ".gz"), "rb") as f:
        raw = f.read()
    got = hashlib.sha256(raw).hexdigest()
    if got != want:
        raise RuntimeError(f"ROM bundle {name}: sha256 {got} != {want}")
    return json.loads(raw)


def load_rom_json(fork_id: int) -> dict:
    """Parsed rom.json of a bundled fork (1-9)."""
    return _load(f"fork_{fork_id}.rom.json")


def has_rom(fork_id: int) -> bool:
    """Whether the main ROM of `fork_id` is bundled."""
    return os.path.exists(os.path.join(_DATA_DIR,
                                       f"fork_{fork_id}.rom.json.gz"))


def load_storage_rom_json() -> dict:
    """Parsed storage_sm_rom.json (the Storage SM micro-ROM)."""
    return _load("storage_sm_rom.json")
