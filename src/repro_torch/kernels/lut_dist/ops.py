"""Device dispatch for quantized LUT distances (quantized-traversal hot
path)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.lut_dist.lut_dist import lut_dist_cuda
from repro_torch.kernels.lut_dist.ref import lut_dist_ref


def lut_dist(lut: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
             backend: Optional[str] = None) -> torch.Tensor:
    """(Q, M, C) f32, (N, M) uint8, (Q, R) int32 -> (Q, R) f32 asymmetric
    distances (+inf for ids < 0): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if use_kernel(codes, backend, "lut_dist"):
        return lut_dist_cuda(lut.float().contiguous(), codes.contiguous(),
                             ids.to(torch.int32).contiguous())
    return lut_dist_ref(lut, codes, ids)
