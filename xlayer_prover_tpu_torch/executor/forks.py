"""Fork registry: per-protocol-version ROM bundles.

The port's own copy of ``xlayer_prover_tpu/executor/forks.py``.  The
reference freezes a namespace copy of {main executor, eval_command,
rom.json} per fork and dispatches on input.publicInputs.forkID
(src/executor/executor.cpp:23-377, SURVEY A.8).  Here the interpreter is
table-driven, so one engine serves every fork whose rom.json + input
semantics it understands: forks 7-9 execute their reference e2e
testvectors bit-exactly; forks 4-6 use the V1 input layout
(globalExitRoot/timestamp/batchHashData publics), mapped by BatchInput;
forks 1-3 load but ship no e2e vectors — the reference likewise only keeps
them for process_batch (executor.cpp:23-377, V1/V2 service split
executor_service.cpp:98-101).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from .. import data as bundles
from .main_sm import MainExecutor
from .rom import Rom

SUPPORTED_FORKS = (1, 2, 3, 4, 5, 6, 7, 8, 9)
CURRENT_FORK = 9


class ForkRegistry:
    """Lazy per-fork (Rom, MainExecutor) cache for the fast path.

    ROMs come from the port's bundles (``data/roms/``), or from an
    explicit rom_dir of fork_N/scripts/rom.json layout (a reference
    checkout)."""

    def __init__(self, rom_dir: Optional[str] = None,
                 max_steps: int = 1 << 22):
        self.rom_dir = rom_dir
        self.max_steps = max_steps
        self._roms: Dict[int, Rom] = {}
        self._execs: Dict[int, MainExecutor] = {}

    def rom_path(self, fork_id: int) -> Optional[str]:
        if self.rom_dir is None:
            return None
        return os.path.join(self.rom_dir, f"fork_{fork_id}", "scripts",
                            "rom.json")

    def supported(self, fork_id: int) -> bool:
        if fork_id not in SUPPORTED_FORKS:
            return False
        p = self.rom_path(fork_id)
        if p is not None:
            return os.path.exists(p)
        return bundles.has_rom(fork_id)

    def rom(self, fork_id: int) -> Optional[Rom]:
        if not self.supported(fork_id):
            return None
        if fork_id not in self._roms:
            p = self.rom_path(fork_id)
            self._roms[fork_id] = Rom.load(p) if p is not None \
                else Rom.load_fork(fork_id)
        return self._roms[fork_id]

    def executor(self, fork_id: int) -> Optional[MainExecutor]:
        """Interpreter for the fork's ROM (process_batch fast path)."""
        if fork_id not in self._execs:
            rom = self.rom(fork_id)
            if rom is None:
                return None
            from . import rom_functions as rf
            ex = MainExecutor(rom, max_steps=self.max_steps)
            rf.register_all(ex)
            self._execs[fork_id] = ex
        return self._execs[fork_id]
