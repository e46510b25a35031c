"""Reference-format ``*.starkinfo.json`` loader and the section memory plan.

The port's own copy of ``xlayer_prover_tpu/stark/stark_info.py`` (host
Python, the same behaviour): ``StarkInfo`` parses the pil-stark metadata
the reference prover consumes (src/starkpil/stark_info.{hpp,cpp}): the
STARK geometry (StarkStruct: nBits/nBitsExt/nQueries/FRI step schedule),
section column counts (mapSectionsN for cm1_n..f_2ns), plookup/
permutation/connection contexts (puCtx/peCtx/ciCtx expression ids), the
evaluation map, quotient shape (qDeg/qDim) and the step scripts
(StepOperation lists).  ``info_from_air`` makes the geometry-only
StarkInfo of a live Air, and ``memory_plan`` turns it into the byte
budget per section and the choice the prover follows
(``stark/prover.py``): every section resident on the device, or the
extended sections in host memory with column blocks streamed through it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional


@dataclasses.dataclass
class StepStruct:
    n_bits: int


@dataclasses.dataclass
class StarkStruct:
    n_bits: int
    n_bits_ext: int
    n_queries: int
    verification_hash_type: str
    steps: List[StepStruct]


@dataclasses.dataclass
class PuCtx:
    f_exp_id: int
    t_exp_id: int
    h1_id: int
    h2_id: int
    z_id: int
    c1_id: int
    c2_id: int
    num_id: int
    den_id: int


@dataclasses.dataclass
class PeCtx:
    f_exp_id: int
    t_exp_id: int
    z_id: int
    c1_id: int
    c2_id: int
    num_id: int
    den_id: int


@dataclasses.dataclass
class CiCtx:
    z_id: int
    num_id: int
    den_id: int


@dataclasses.dataclass
class EvMapEntry:
    type: str    # "cm" | "const" | "q"
    id: int
    prime: bool


@dataclasses.dataclass
class StepOperation:
    op: str
    dest: dict
    src: List[dict]


@dataclasses.dataclass
class StarkInfo:
    stark_struct: StarkStruct
    map_total_n: int
    n_constants: int
    n_publics: int
    n_cm1: int
    n_cm2: int
    n_cm3: int
    n_cm4: int
    q_deg: int
    q_dim: int
    map_sections_n: Dict[str, int]
    map_deg: Dict[str, int]
    map_offsets: Dict[str, int]
    var_pol_map: List[dict]
    cm_n: List[int]
    cm_2ns: List[int]
    qs: List[int]
    pu_ctx: List[PuCtx]
    pe_ctx: List[PeCtx]
    ci_ctx: List[CiCtx]
    ev_map: List[EvMapEntry]
    steps: Dict[str, List[StepOperation]]
    n_exps: int = 0

    @staticmethod
    def load(path: str) -> "StarkInfo":
        with open(path) as f:
            return StarkInfo.from_json(json.load(f))

    @staticmethod
    def from_json(j: dict) -> "StarkInfo":
        ss = j["starkStruct"]
        stark_struct = StarkStruct(
            n_bits=int(ss["nBits"]),
            n_bits_ext=int(ss["nBitsExt"]),
            n_queries=int(ss["nQueries"]),
            verification_hash_type=ss.get("verificationHashType", "GL"),
            steps=[StepStruct(n_bits=int(s["nBits"])) for s in ss["steps"]],
        )

        def sections(key):
            out = {}
            for sec, v in j.get(key, {}).items():
                if isinstance(v, (int, float, str)):
                    out[sec] = int(v)
            return out

        def steps_scripts():
            out = {}
            for name in ("step2prev", "step3prev", "step3", "step42ns",
                         "step52ns"):
                if name in j:
                    ops = [StepOperation(op=o.get("op", ""),
                                         dest=o.get("dest", {}),
                                         src=o.get("src", []))
                           for o in j[name].get("first", [])]
                    out[name] = ops
            return out

        return StarkInfo(
            stark_struct=stark_struct,
            map_total_n=int(j.get("mapTotalN", 0)),
            n_constants=int(j.get("nConstants", 0)),
            n_publics=int(j.get("nPublics", 0)),
            n_cm1=int(j.get("nCm1", 0)),
            n_cm2=int(j.get("nCm2", 0)),
            n_cm3=int(j.get("nCm3", 0)),
            n_cm4=int(j.get("nCm4", 0)),
            q_deg=int(j.get("qDeg", 1)),
            q_dim=int(j.get("qDim", 3)),
            map_sections_n=sections("mapSectionsN"),
            map_deg=sections("mapDeg"),
            map_offsets=sections("mapOffsets"),
            var_pol_map=j.get("varPolMap", []),
            cm_n=[int(v) for v in j.get("cm_n", [])],
            cm_2ns=[int(v) for v in j.get("cm_2ns", [])],
            qs=[int(v) for v in j.get("qs", [])],
            pu_ctx=[PuCtx(f_exp_id=int(c.get("fExpId", 0)),
                          t_exp_id=int(c.get("tExpId", 0)),
                          h1_id=int(c.get("h1Id", 0)),
                          h2_id=int(c.get("h2Id", 0)),
                          z_id=int(c.get("zId", 0)),
                          c1_id=int(c.get("c1Id", 0)),
                          c2_id=int(c.get("c2Id", 0)),
                          num_id=int(c.get("numId", 0)),
                          den_id=int(c.get("denId", 0)))
                    for c in j.get("puCtx", [])],
            pe_ctx=[PeCtx(f_exp_id=int(c.get("fExpId", 0)),
                          t_exp_id=int(c.get("tExpId", 0)),
                          z_id=int(c.get("zId", 0)),
                          c1_id=int(c.get("c1Id", 0)),
                          c2_id=int(c.get("c2Id", 0)),
                          num_id=int(c.get("numId", 0)),
                          den_id=int(c.get("denId", 0)))
                    for c in j.get("peCtx", [])],
            ci_ctx=[CiCtx(z_id=int(c.get("zId", 0)),
                          num_id=int(c.get("numId", 0)),
                          den_id=int(c.get("denId", 0)))
                    for c in j.get("ciCtx", [])],
            ev_map=[EvMapEntry(type=e["type"], id=int(e["id"]),
                               prime=bool(e.get("prime", False)))
                    for e in j.get("evMap", [])],
            steps=steps_scripts(),
            n_exps=int(j.get("nExps", 0)),
        )

    def fri_steps(self) -> List[int]:
        return [s.n_bits for s in self.stark_struct.steps]


# ---------------------------------------------------------------------------
# Memory planner: StarkInfo -> device/host section plan (the consumer of
# the reference's eSection memory map, stark_info.hpp:37-51: sections
# become named arrays instead of one 51 GB buffer)
# ---------------------------------------------------------------------------

def info_from_air(air) -> "StarkInfo":
    """Build the geometry-only StarkInfo for a live Air (so the memory
    planner serves the prover directly, not just archive files)."""
    return StarkInfo.from_json({
        "starkStruct": {"nBits": air.n_bits, "nBitsExt": air.n_bits_ext,
                        "nQueries": getattr(air, "n_queries", 8),
                        "steps": [{"nBits": air.n_bits_ext}]},
        "nConstants": air.const_width, "nPublics": air.n_publics,
        "mapSectionsN": {
            "const_n": air.const_width, "const_2ns": air.const_width,
            "cm1_n": air.cm1_width, "cm1_2ns": air.cm1_width,
            "cm2_n": air.cm2_width, "cm2_2ns": air.cm2_width,
            "cm3_n": air.cm3_width, "cm3_2ns": air.cm3_width,
            "q_2ns": air.cm4_width,
        },
    })


def memory_plan(si: "StarkInfo", n_devices: int = 1,
                hbm_bytes: int = 16 << 30) -> dict:
    """Byte budget per polynomial section and the per-device shard sizes
    for a row-sharded mesh; flags sections that must stream column
    blocks because a full-resident layout exceeds HBM."""
    n = 1 << si.stark_struct.n_bits
    n_ext = 1 << si.stark_struct.n_bits_ext
    sections = {}
    for sec, width in sorted(si.map_sections_n.items()):
        rows = n_ext if sec.endswith("2ns") else n
        sections[sec] = {"cols": width, "rows": rows,
                         "bytes": rows * width * 8}
    total = sum(s["bytes"] for s in sections.values())
    per_device = -(-total // max(1, n_devices))
    resident = per_device <= int(hbm_bytes * 0.75)
    plan = {
        "n_bits": si.stark_struct.n_bits,
        "n_bits_ext": si.stark_struct.n_bits_ext,
        "sections": sections,
        "total_bytes": total,
        "n_devices": n_devices,
        "per_device_bytes": per_device,
        "hbm_resident": resident,
    }
    if not resident:
        # column-block streaming: pick the largest block width that fits
        # alongside one extended working section
        worst = max((s for s in sections.values()), key=lambda s: s["bytes"])
        budget = int(hbm_bytes * 0.5)
        block_cols = max(8, budget // (worst["rows"] * 8 * 3))
        plan["stream_block_cols"] = block_cols
    return plan
