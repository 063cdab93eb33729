"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel lives in ``kernels/<name>/``: ``ref.py`` holds the plain
version, ``<name>.py`` the wrapper that launches the CUDA kernel (sources
in ``repro_torch/csrc/``, built by ``kernels/cuda_lib.py``), and ``ops.py``
dispatches on the tensor's device — a CPU tensor goes to the plain version,
a CUDA tensor to the kernel, and there is no fallback between the two.

A ``meta`` tensor (shapes, no storage: ``launch/dryrun.py``) goes to the
kernel's wrapper where the dry run's cells reach it (``beam_hops``,
``gather_dist``, ``l2topk``, the bag, its backward and its grouping): the
wrapper allocates its outputs as for a launch, records the kernel's cost
(``analysis.op_costs``) and launches nothing. The other wrappers raise on
a meta tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

BACKENDS = (None, "cuda")


def use_kernel(t: torch.Tensor, backend: Optional[str], name: str,
               meta: bool = False) -> bool:
    """True when ``t`` must go through the CUDA kernel ``name``.

    ``backend=None`` decides by the tensor's device; ``"cuda"`` demands the
    kernel and raises on a CPU tensor rather than run the plain version.
    A meta tensor goes to the wrapper when it has a meta branch
    (``meta=True``) and raises otherwise.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown {name} backend {backend!r}; expected "
                         f"None (by device) or 'cuda'")
    if t.is_meta:
        if meta:
            return True
        raise NotImplementedError(f"{name}: no meta branch (no dry-run "
                                  f"cell reaches this kernel)")
    if t.is_cuda:
        return True
    if backend == "cuda":
        raise RuntimeError(f"{name}: backend='cuda' needs CUDA tensors, "
                           f"got a tensor on {t.device}")
    return False


def card_or_meta(*tensors: torch.Tensor) -> bool:
    """All on CUDA, or all on the meta device (a kernel wrapper's dry
    run)."""
    return all(t.is_cuda for t in tensors) or all(t.is_meta
                                                  for t in tensors)


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p <<= 1
    return p
