"""PyTorch/CUDA port of the Ditto serving system (reference: ``src/repro``).

Mirrors the JAX package module for module: each port file's reference
sits at the same relative path under ``src/repro``. The package imports
``torch`` and never ``jax``, and nothing of the JAX package. Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
