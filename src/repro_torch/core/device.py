"""Where the port runs: the card by default, the CPU when asked."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the card; raises if no card is visible.

    On CUDA it also pins full-float32 matmuls (process-wide): the exact
    kNN, PCA and every nearest-centroid pass go through ``torch.matmul``,
    and TF32 would change the graph. bf16 products (the LM) keep float32
    sums throughout, as the reference's do: cuBLAS may not reduce split
    sums in bf16.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch runs on CUDA by default and no "
                               "card is visible; pass device='cpu' to run "
                               "on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        torch.set_float32_matmul_precision("highest")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so a host
    clock around a stage measures the work, not its enqueueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
