"""Device dispatch for gathered neighbor distances (graph-search hot path)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.gather_dist.gather_dist import gather_dist_cuda
from repro_torch.kernels.gather_dist.ref import gather_dist_ref


def gather_dist(queries: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                backend: Optional[str] = None) -> torch.Tensor:
    """(B, D), (N, D), (B, R) int32 -> (B, R) f32 squared L2 (+inf for
    ids < 0): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if use_kernel(db, backend, "gather_dist"):
        return gather_dist_cuda(queries.contiguous(), db,
                                ids.to(torch.int32).contiguous())
    return gather_dist_ref(queries, db, ids)
