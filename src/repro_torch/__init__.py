"""``repro_torch`` — the PyTorch and CUDA port of the DisCo reproduction.

A second package beside the JAX reference ``repro``: the same module layout
and names, PyTorch inside, and hand-written CUDA kernels for Hopper where
the reference has Pallas kernels.  It imports nothing of ``jax`` or
``repro``; each ported slice is held against the reference by the
``tests/test_torch_*.py`` parity tests.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; a kernel wrapper takes its plain PyTorch version only for
tensors that lie on the CPU.
"""
