"""The zkEVM batch proving engine (``BatchProver``).

The port's own copy of ``BatchProver`` from
``xlayer_prover_tpu/prover_service.py``, the equivalent of the reference
Prover::genBatchProof pipeline (prover.cpp:392-674, minus the recursion
stages): BatchInput -> executor -> trace -> STARK.  The JAX package's
request queue (``ProverService``) and the gRPC services are not ported.
``device=None`` proves on the GPU; ``device="cpu"`` runs every kernel's
plain PyTorch version on the CPU.
"""

from __future__ import annotations

from .stark import prover as stark_prover


class BatchProver:
    """BatchInput -> executor -> trace -> STARK.

    The circuit's constant polynomials (ROM table + SM tables) do not
    depend on the input, so the Setup (const tree / verkey) is built once
    per geometry and reused across batches — the analogue of the
    reference's preloaded const pols + const tree (starks.hpp:93-191).
    """

    def __init__(self, rom, n_bits: int = 16, chunk_bits: int = 4,
                 limb_bits: int = 16, n_queries: int = 8,
                 max_steps: int = 1 << 22, storage_rom=None, device=None):
        from .executor import rom_functions as rf
        from .executor.executor import Executor
        self.executor = Executor(rom, n_bits=n_bits, chunk_bits=chunk_bits,
                                 limb_bits=limb_bits, n_queries=n_queries,
                                 max_steps=max_steps,
                                 storage_rom=storage_rom)
        rf.register_all(self.executor.main)
        self.device = device
        self._setup = None

    @property
    def air(self):
        return self.executor.air

    def setup(self) -> stark_prover.Setup:
        """Build the preprocessed const pols + tree once, on the device."""
        if self._setup is None:
            from .models.zkevm import zkevm_air
            const_np = zkevm_air.fill_fixed(self.air, self.executor.layout)
            self._setup = stark_prover.Setup.build(self.air, const_np,
                                                   device=self.device)
        return self._setup

    def execute_only(self, batch_input, batch_uuid: str = "batch"):
        """Witness generation only (the zkevmCmPolsAfterExecutor stage)."""
        from .state.hashdb import HashDB
        hashdb = HashDB()
        batch_input.load_db(hashdb)
        return self.executor.execute(
            hashdb, batch_uuid=batch_uuid,
            input_vars=batch_input.input_vars(),
            setup_registers=batch_input.setup_registers)

    def prove_from_trace(self, cm1_np, publics, timings: dict | None = None):
        """STARK over a previously committed trace.  `timings` receives
        the seconds of each round (``stark.prover.gen_proof``)."""
        return stark_prover.gen_proof(self.setup(), cm1_np, publics,
                                      timings=timings)

    def prove(self, batch_input, batch_uuid: str = "batch",
              timings: dict | None = None):
        """Run the batch and prove it.  Returns (StarkProof, Context)."""
        res = self.execute_only(batch_input, batch_uuid)
        proof = self.prove_from_trace(res.cm1_np, res.publics,
                                      timings=timings)
        return proof, res.ctx
