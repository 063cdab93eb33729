"""Launch wrapper of the CUDA ``alpha_scan`` kernel (``csrc/alpha_scan.cu``):
one chunk's whole greedy α-RNG occlusion scan in one launch."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.gather_dist.gather_dist import vec4_ok

# kept ids live in shared memory, one (degree,) list per warp of a block
# (csrc kScanWarps = 4): 2048 ids keep a block at 32 KB
MAX_DEGREE = 2048


def _check_operands(data, node_ids, cand_ids, cand_dists, degree, alpha):
    tensors = [("data", data), ("node_ids", node_ids),
               ("cand_ids", cand_ids), ("cand_dists", cand_dists)]
    if isinstance(alpha, torch.Tensor):
        tensors.append(("alpha", alpha))
    if not all(t.is_cuda for _, t in tensors):
        raise ValueError("alpha_scan_cuda: every operand must be on CUDA")
    if any(t.device != data.device for _, t in tensors):
        raise ValueError("alpha_scan_cuda: operands on different devices")
    if data.dtype != torch.float32 or cand_dists.dtype != torch.float32:
        raise TypeError("alpha_scan_cuda: data and cand_dists must be "
                        "float32")
    if node_ids.dtype != torch.int32 or cand_ids.dtype != torch.int32:
        raise TypeError("alpha_scan_cuda: node_ids and cand_ids must be "
                        "int32")
    if data.dim() != 2 or node_ids.dim() != 1 or cand_ids.dim() != 2:
        raise ValueError("alpha_scan_cuda: expected (N, D), (B,), (B, L), "
                         "(B, L)")
    b, l = cand_ids.shape
    if cand_dists.shape != cand_ids.shape or node_ids.shape[0] != b:
        raise ValueError(f"alpha_scan_cuda: shapes {tuple(node_ids.shape)},"
                         f" {tuple(cand_ids.shape)}, "
                         f"{tuple(cand_dists.shape)} disagree")
    if data.shape[0] == 0:
        raise ValueError("alpha_scan_cuda: empty data")
    if not 1 <= degree <= min(l, MAX_DEGREE):
        raise ValueError(f"alpha_scan_cuda: degree {degree} outside "
                         f"[1, min(L = {l}, {MAX_DEGREE})]")
    if isinstance(alpha, torch.Tensor) and (
            alpha.dtype != torch.float32 or alpha.shape != (b,)):
        raise ValueError(f"alpha_scan_cuda: a tensor alpha must be ({b},) "
                         f"float32, got {tuple(alpha.shape)} {alpha.dtype}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"alpha_scan_cuda: {name} is not contiguous")


def alpha_scan_cuda(data: torch.Tensor, node_ids: torch.Tensor,
                    cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                    degree: int, alpha: Union[float, torch.Tensor]):
    """data (N, D) f32, node_ids (B,) int32, cand_ids (B, L) int32,
    cand_dists (B, L) f32, alpha a float or a (B,) f32 tensor -> (keep
    (B, degree) int32, mask (B, L) bool), as ``ref.alpha_scan_ref``."""
    _check_operands(data, node_ids, cand_ids, cand_dists, degree, alpha)
    b, l = cand_ids.shape
    dev = data.device
    keep = torch.empty((b, degree), dtype=torch.int32, device=dev)
    mask = torch.empty((b, l), dtype=torch.bool, device=dev)
    if b == 0:
        return keep, mask
    rows = alpha if isinstance(alpha, torch.Tensor) else None
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, d = data.shape
    code = lib.alpha_scan_f32(
        data.data_ptr(), node_ids.data_ptr(), cand_ids.data_ptr(),
        cand_dists.data_ptr(), None if rows is None else rows.data_ptr(),
        0.0 if rows is not None else float(alpha), keep.data_ptr(),
        mask.data_ptr(), b, l, degree, n, d, int(vec4_ok(d, data)), stream)
    cuda_lib.check(code, "alpha_scan_f32")
    alpha_scan_cuda.launches += 1
    return keep, mask


alpha_scan_cuda.launches = 0
