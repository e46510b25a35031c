"""ROM loader: parses the zkASM assembler output (rom.json).

The port's own copy of ``xlayer_prover_tpu/executor/rom.py``, the
equivalent of the reference Rom/RomLine loading
(src/main_sm/fork_9/main/rom.{hpp,cpp}, rom_line.hpp:15-117): a RomLine is a
wide instruction word with ~24 input selectors, CONST/CONSTL immediates,
jump controls, memory/hash/storage/arith/binary operation flags, register
setters and freeInTag command trees.  ``Rom.load_fork(9)`` reads the
port's bundled fork_9 ROM (``data/roms/``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

# input selector fields (coefficient of each source in the op accumulator)
IN_FIELDS = [
    "inA", "inB", "inC", "inD", "inE", "inSR", "inCTX", "inSP", "inPC",
    "inGAS", "inSTEP", "inFREE", "inFREE0", "inRR", "inHASHPOS", "inCntArith",
    "inCntBinary", "inCntKeccakF", "inCntSha256F", "inCntMemAlign",
    "inCntPaddingPG", "inCntPoseidonG", "inROTL_C", "inRCX",
]

# register setter flags
SET_FIELDS = [
    "setA", "setB", "setC", "setD", "setE", "setSR", "setCTX", "setSP",
    "setPC", "setGAS", "setRR", "setHASHPOS", "setRCX",
]

# boolean operation flags
FLAG_FIELDS = [
    "mOp", "mWR", "useCTX", "isStack", "isMem", "incStack", "ind", "indRR",
    "JMP", "JMPC", "JMPN", "JMPZ", "call", "return", "useJmpAddr",
    "useElseAddr", "assert", "assumeFree",
    "hashK", "hashK1", "hashKLen", "hashKDigest",
    "hashP", "hashP1", "hashPLen", "hashPDigest",
    "hashS", "hashS1", "hashSLen", "hashSDigest",
    "sRD", "sWR", "arith", "arithEq0", "arithEq1", "arithEq2", "arithEq3",
    "arithEq4", "arithEq5", "bin", "memAlignRD", "memAlignWR", "memAlignWR8",
    "repeat", "restore", "save",
]


@dataclasses.dataclass
class RomLine:
    zkpc: int
    # selectors: name -> signed int coefficient
    ins: Dict[str, int]
    const: int = 0            # CONST (field element, sign-extended)
    constl: int = 0           # CONSTL (256-bit)
    has_const: bool = False
    has_constl: bool = False
    flags: Dict[str, int] = dataclasses.field(default_factory=dict)
    sets: List[str] = dataclasses.field(default_factory=list)
    offset: int = 0
    offset_label: str = ""
    jmp_addr: Optional[int] = None
    else_addr: Optional[int] = None
    bin_opcode: int = 0
    free_in_tag: Optional[dict] = None
    cmd_before: List[dict] = dataclasses.field(default_factory=list)
    cmd_after: List[dict] = dataclasses.field(default_factory=list)
    line_str: str = ""
    file_name: str = ""
    src_line: int = 0

    def flag(self, name: str) -> int:
        return self.flags.get(name, 0)


class Rom:
    def __init__(self, program: List[RomLine], labels: Dict[str, int],
                 constants: Dict[str, Any]):
        self.program = program
        self.labels = labels
        self.constants = constants

    def __len__(self):
        return len(self.program)

    def label(self, name: str) -> int:
        return self.labels[name]

    @staticmethod
    def load(path: str) -> "Rom":
        with open(path) as f:
            data = json.load(f)
        return Rom.from_json(data)

    @staticmethod
    def load_fork(fork_id: int = 9) -> "Rom":
        """Load a fork's ROM from the port's bundle (``data/``)."""
        from .. import data as bundles
        return Rom.from_json(bundles.load_rom_json(fork_id))

    @staticmethod
    def from_json(data: dict) -> "Rom":
        program = []
        for zkpc, raw in enumerate(data["program"]):
            ins = {}
            for f in IN_FIELDS:
                if f in raw:
                    v = raw[f]
                    ins[f] = int(v) if not isinstance(v, str) else int(v, 0)
            flags = {}
            for f in FLAG_FIELDS:
                if f in raw and raw[f]:
                    flags[f] = int(raw[f])
            sets = [f for f in SET_FIELDS if raw.get(f)]
            line = RomLine(
                zkpc=zkpc,
                ins=ins,
                flags=flags,
                sets=sets,
                offset=int(raw.get("offset", 0)),
                offset_label=raw.get("offsetLabel", ""),
                jmp_addr=int(raw["jmpAddr"]) if "jmpAddr" in raw else None,
                else_addr=int(raw["elseAddr"]) if "elseAddr" in raw else None,
                bin_opcode=int(raw.get("binOpcode", 0)),
                free_in_tag=raw.get("freeInTag"),
                cmd_before=raw.get("cmdBefore", []),
                cmd_after=raw.get("cmdAfter", []),
                line_str=raw.get("lineStr", ""),
                file_name=raw.get("fileName", ""),
                src_line=int(raw.get("line", 0)),
            )
            if "CONST" in raw:
                line.const = int(raw["CONST"])
                line.has_const = True
            if "CONSTL" in raw:
                line.constl = int(raw["CONSTL"])
                line.has_constl = True
            program.append(line)
        return Rom(program=program, labels=dict(data.get("labels", {})),
                   constants=dict(data.get("constants", {})))
