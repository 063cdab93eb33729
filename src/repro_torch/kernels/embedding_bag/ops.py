"""Device dispatch for EmbeddingBag (the recsys models' multi-hot lookup)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  combiner: str = "sum",
                  backend: Optional[str] = None) -> torch.Tensor:
    """table (V, D) f32/bf16, ids (B, L) (-1 pads), weights (B, L) or None
    -> (B, D) f32 weighted sum or mean of the rows: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if use_kernel(table, backend, "embedding_bag"):
        return embedding_bag_cuda(
            table, ids.to(torch.int32).contiguous(),
            None if weights is None else weights.float().contiguous(),
            combiner)
    return embedding_bag_ref(table, ids, weights, combiner)
