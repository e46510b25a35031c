"""xlayer_prover_tpu_torch: the Goldilocks STARK prover on PyTorch and CUDA.

The PyTorch port of ``xlayer_prover_tpu``.  Module names and layout follow
the JAX package (``fields/``, ``ops/``, ``stark/``, ``models/``).  A field
element is its 64-bit pattern in an ``int64`` tensor (see ``device.py``).
Entry points run on the GPU unless the caller passes ``device="cpu"``; on
the CPU every hand-written CUDA kernel is replaced by its plain PyTorch
version, which lives beside the kernel's wrapper.
"""
