"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel lives in ``kernels/<name>/``: ``ref.py`` holds the plain
version, ``<name>.py`` the wrapper that launches the CUDA kernel (sources
in ``repro_torch/csrc/``, built by ``kernels/cuda_lib.py``), and ``ops.py``
dispatches on the tensor's device — a CPU tensor goes to the plain version,
a CUDA tensor to the kernel, and there is no fallback between the two.
"""
from __future__ import annotations

from typing import Optional

import torch

BACKENDS = (None, "cuda")


def use_kernel(t: torch.Tensor, backend: Optional[str], name: str) -> bool:
    """True when ``t`` must go through the CUDA kernel ``name``.

    ``backend=None`` decides by the tensor's device; ``"cuda"`` demands the
    kernel and raises on a CPU tensor rather than run the plain version.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown {name} backend {backend!r}; expected "
                         f"None (by device) or 'cuda'")
    if t.is_cuda:
        return True
    if backend == "cuda":
        raise RuntimeError(f"{name}: backend='cuda' needs CUDA tensors, "
                           f"got a tensor on {t.device}")
    return False


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p <<= 1
    return p
