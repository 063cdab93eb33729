"""PyTorch/CUDA port of ``repro``: the tuned graph index on an NVIDIA H100.

The package mirrors ``src/repro/`` path for path. It imports torch, numpy
and the standard library only; the JAX package is its reference and is
never imported here. Entry points run on the card unless the caller asks
for the CPU (``device="cpu"``), where every kernel runs its plain PyTorch
version.
"""
