"""PyTorch/CUDA port of the ``repro`` package, module for module.

The JAX package under ``src/repro`` is the reference; this package imports
nothing of it. Entry points run on the CUDA device unless the caller passes
``device="cpu"``, where every hand-written kernel is replaced by its plain
PyTorch version.
"""
