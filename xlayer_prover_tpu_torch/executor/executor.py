"""Executor: Main SM run -> secondary-SM trace expansion -> provable trace.

The port's own copy of ``xlayer_prover_tpu/executor/executor.py``, the
equivalent of the reference Executor (src/executor/executor.cpp): the Main
SM interpreter produces per-step trace records plus action vectors
(Required); the trace is committed as the Main SM column group and the
secondary SM expanders fill their column groups of the shared-domain zkEVM
circuit.  ``process_batch`` is the fast path (execute only, no trace);
``execute`` returns the full proving payload: const/cm1 numpy columns +
publics for ``stark.prover.gen_proof``.  The interpreter in Python is the
only engine: the JAX package's native fast path (libnexec) is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from ..models.zkevm import zkevm_air
from ..models.zkevm.padding_bytes import ByteStreamInput
from ..state.hashdb import HashDB
from .main_sm import Context, MainExecutor, Required, linearize_reads
from .rom import Rom

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ExecutionResult:
    ctx: Context
    const_np: Optional[np.ndarray] = None
    cm1_np: Optional[np.ndarray] = None
    publics: Optional[list] = None


class Executor:
    """Owns the zkEVM circuit geometry + the Main SM machine."""

    def __init__(self, rom: Rom, n_bits: int = 16, chunk_bits: int = 4,
                 limb_bits: int = 16, n_queries: int = 8,
                 max_steps: int = 1 << 22,
                 start_label: str = "start",
                 stop_label: str = "finalizeExecution",
                 storage_rom=None):
        self.rom = rom
        self.start_label = start_label
        self.stop_label = stop_label
        self.max_steps = max_steps
        self.main = MainExecutor(rom, max_steps=max_steps)
        self.air, self.layout = zkevm_air.build(
            rom, n_bits=n_bits, chunk_bits=chunk_bits, limb_bits=limb_bits,
            n_queries=n_queries, start_label=start_label,
            stop_label=stop_label, storage_rom=storage_rom)
        self._fixed = None

    def fixed(self) -> np.ndarray:
        """The circuit's constant columns (``zkevm_air.fill_fixed``),
        filled once per executor: they do not depend on the input.  The
        array is read-only, shared by every execution and the Setup."""
        const_np = self._fixed
        if const_np is None:
            const_np = zkevm_air.fill_fixed(self.air, self.layout)
            const_np.flags.writeable = False
            self._fixed = const_np
        return const_np

    def process_batch(self, hashdb: HashDB, batch_uuid: str = "batch",
                      input_vars: Optional[dict] = None,
                      trace: bool = False) -> Context:
        """Fast path: execute only (the sequencer's ProcessBatch); the
        per-step trace records only when `trace`."""
        ctx = Context(self.rom, hashdb, batch_uuid, input_vars)
        if trace:
            ctx.trace = []
        self.main.execute(ctx, self.start_label, self.stop_label)
        return ctx

    def execute(self, hashdb: Optional[HashDB] = None,
                batch_uuid: str = "batch", input_vars: Optional[dict] = None,
                setup_registers=None) -> ExecutionResult:
        """Execute + commit the Main trace + expand all SMs.  `hashdb`
        holds the pre-state (an empty state when None); `setup_registers`
        sets the initial register file (``BatchInput.setup_registers``)."""
        ctx = Context(self.rom, HashDB() if hashdb is None else hashdb,
                      batch_uuid, input_vars)
        ctx.trace = []
        if setup_registers is not None:
            setup_registers(ctx)
        self.main.execute(ctx, self.start_label, self.stop_label)
        req: Required = ctx.required

        for prefix, table, out in (("hashP", ctx.hash_p, req.padding_pg),
                                   ("hashK", ctx.hash_k, req.padding_kk),
                                   ("hashS", ctx.hash_s, req.padding_sha)):
            for addr in sorted(table):
                st = table[addr]
                out.append(ByteStreamInput(
                    addr=addr, data=bytes(st.data),
                    reads=linearize_reads(st, f"{prefix} addr={addr}"),
                    len_called=st.len_called,
                    digest_called=st.digest_called))

        regs = ctx.regs
        final_regs = {
            "A": list(regs.A), "B": list(regs.B), "C": list(regs.C),
            "D": list(regs.D), "E": list(regs.E), "SR": list(regs.SR),
            "CTX": regs.CTX, "SP": regs.SP, "PC": regs.PC, "GAS": regs.GAS,
            "RR": regs.RR, "HASHPOS": regs.HASHPOS, "RCX": regs.RCX,
            "carry": ctx.carry,
            "counters": (ctx.counters.arith, ctx.counters.binary,
                         ctx.counters.keccak_f, ctx.counters.sha256_f,
                         ctx.counters.mem_align, ctx.counters.padding_pg,
                         ctx.counters.poseidon_g),
        }
        const_np, cm1_np, publics = zkevm_air.gen_trace(
            self.air, self.layout, ctx.trace, final_regs, req,
            const_np=self.fixed())
        log.info("executor: %d steps, %d binary ops, %d memory accesses, "
                 "%d eq0 ariths", ctx.counters.steps, len(req.binary),
                 len(req.memory), sum(1 for a in req.arith if a[0] == 0))
        return ExecutionResult(ctx=ctx, const_np=const_np, cm1_np=cm1_np,
                               publics=publics)
