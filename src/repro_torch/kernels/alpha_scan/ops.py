"""Device dispatch for the α-scan (the graph build's occlusion pass)."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.alpha_scan.alpha_scan import alpha_scan_cuda
from repro_torch.kernels.alpha_scan.ref import alpha_scan_ref


def alpha_scan(data: torch.Tensor, node_ids: torch.Tensor,
               cand_ids: torch.Tensor, cand_dists: torch.Tensor,
               degree: int, alpha: Union[float, torch.Tensor],
               backend: Optional[str] = None, variant: Optional[str] = None):
    """(keep (B, degree) int32, mask (B, L) bool) of the greedy α-RNG scan
    (see ``ref.alpha_scan_ref``): the CUDA kernel for CUDA tensors (the
    variant ``alpha_scan.route`` picks, unless ``variant`` forces one), the
    plain version for CPU tensors.

    The kernel scans at ``min(degree, L)``: a row keeps at most L ids, so
    wider ``keep`` columns are -1 either way and are padded here.
    """
    if not use_kernel(data, backend, "alpha_scan"):
        return alpha_scan_ref(data, node_ids, cand_ids, cand_dists, degree,
                              alpha)
    run = min(degree, cand_ids.shape[1])
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.to(device=data.device, dtype=torch.float32).contiguous()
    keep, mask = alpha_scan_cuda(
        data.contiguous(), node_ids.to(torch.int32).contiguous(),
        cand_ids.to(torch.int32).contiguous(),
        cand_dists.to(torch.float32).contiguous(), run, alpha,
        variant=variant)
    if run < degree:
        keep = torch.nn.functional.pad(keep, (0, degree - run), value=-1)
    return keep, mask
