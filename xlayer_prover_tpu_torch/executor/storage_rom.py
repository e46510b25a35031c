"""Storage SM micro-ROM: the loader.

The port's own copy of ``xlayer_prover_tpu/executor/storage_rom.py``;
``StorageRom.load_default`` reads the port's bundled micro-ROM.

The Storage SM replays SMT get/set actions through its own micro-ROM
(config/scripts/storage_sm_rom.json; reference loader src/sm/storage/
storage_rom.hpp, line format storage_rom_line.hpp:10-60): a register file
of Goldilocks quads (RKEY, VALUE_LOW/HIGH, LEVEL, OLD_ROOT/NEW_ROOT,
HASH_LEFT/RIGHT, SIBLING_*) with selectors, setters, Poseidon hash ops,
conditional jumps and the CLIMB_RKEY ops that undo key-bit consumption
while walking back up the tree.

This module parses the program that the replay executor
(``storage_executor.py``) runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class StorageRomLine:
    line: int
    # selectors: inRKEY etc -> coefficient
    ins: Dict[str, int]
    sets: List[str]
    const: Optional[int] = None
    free_in_tag: Optional[dict] = None
    # ops
    hash: bool = False
    hash_type: int = 0          # 0: branch (capacity 0), 1: leaf (capacity 1)
    climb_rkey: bool = False
    climb_sibling_rkey: bool = False
    climb_bit_n: bool = False   # climb with the negated bit
    latch_get: bool = False
    latch_set: bool = False
    jmp: Optional[int] = None
    jmpz: Optional[int] = None
    jmpnz: Optional[int] = None
    line_str: str = ""


class StorageRom:
    def __init__(self, lines: List[StorageRomLine], labels: Dict[str, int]):
        self.lines = lines
        self.labels = labels

    def __len__(self):
        return len(self.lines)

    @staticmethod
    def load_default() -> "StorageRom":
        """The bundled storage-SM micro-ROM (``data/``)."""
        from .. import data as bundles
        return StorageRom.from_json(bundles.load_storage_rom_json())

    @staticmethod
    def from_json(data: dict) -> "StorageRom":
        lines = []
        for i, raw in enumerate(data["program"]):
            ins = {}
            sets = []
            for k, v in raw.items():
                if k.startswith("in") and v:
                    ins[k[2:]] = int(v) if not isinstance(v, str) else int(v)
                elif k.startswith("set") and v:
                    sets.append(k[3:])
            jmp_addr = raw.get("jmpAddress")
            line = StorageRomLine(
                line=i,
                ins=ins,
                sets=sets,
                const=int(raw["CONST"]) if "CONST" in raw else None,
                free_in_tag=raw.get("freeInTag"),
                hash=bool(raw.get("hash")),
                hash_type=int(raw.get("hashType", 0)),
                climb_rkey=bool(raw.get("climbRkey")),
                climb_sibling_rkey=bool(raw.get("climbSiblingRkey")),
                climb_bit_n=bool(raw.get("climbBitN")),
                latch_get=bool(raw.get("latchGet")),
                latch_set=bool(raw.get("latchSet")),
                jmp=int(jmp_addr) if raw.get("jmp") and jmp_addr is not None
                else None,
                jmpz=int(jmp_addr) if raw.get("jmpz") and jmp_addr is not None
                else None,
                jmpnz=int(jmp_addr) if raw.get("jmpnz") and jmp_addr is not None
                else None,
                line_str=raw.get("lineStr", ""),
            )
            lines.append(line)
        return StorageRom(lines=lines, labels=dict(data.get("labels", {})))
