"""PyTorch / CUDA port of the iCheck reproduction.

A package beside :mod:`repro` (the JAX reference) with the same module
layout.  It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``: the framework-neutral checkpoint service (``core``, ``obs``,
``kernels/ckpt_codec/{blocks,rs}``, ``configs``) is carried as a copy.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
