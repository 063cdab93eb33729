"""Launch wrapper of the CUDA ``gather_dist`` kernel (``csrc/gather_dist.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib


def _check_operands(queries, db, ids):
    if not (queries.is_cuda and db.is_cuda and ids.is_cuda):
        raise ValueError("gather_dist_cuda: every operand must be on CUDA")
    if queries.device != db.device or ids.device != db.device:
        raise ValueError("gather_dist_cuda: operands on different devices")
    if queries.dtype != torch.float32 or db.dtype != torch.float32:
        raise TypeError("gather_dist_cuda: queries and db must be float32")
    if ids.dtype != torch.int32:
        raise TypeError("gather_dist_cuda: ids must be int32")
    if queries.dim() != 2 or db.dim() != 2 or ids.dim() != 2:
        raise ValueError("gather_dist_cuda: expected (B, D), (N, D), (B, R)")
    if queries.shape[1] != db.shape[1] or ids.shape[0] != queries.shape[0]:
        raise ValueError(f"gather_dist_cuda: shapes {tuple(queries.shape)}, "
                         f"{tuple(db.shape)}, {tuple(ids.shape)} disagree")
    if db.shape[0] == 0:
        raise ValueError("gather_dist_cuda: empty db")
    for name, t in (("queries", queries), ("db", db), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"gather_dist_cuda: {name} is not contiguous")


def vec4_ok(d: int, *tensors: torch.Tensor) -> bool:
    """Rows can be read as float4: d % 4 == 0 and 16-byte aligned bases."""
    return d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def gather_dist_cuda(queries: torch.Tensor, db: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """queries (B, D) f32, db (N, D) f32, ids (B, R) int32 -> (B, R) f32."""
    _check_operands(queries, db, ids)
    lib = cuda_lib.library()
    b, d = queries.shape
    r = ids.shape[1]
    out = torch.empty((b, r), dtype=torch.float32, device=db.device)
    stream = torch.cuda.current_stream(db.device).cuda_stream
    code = lib.gather_dist_f32(
        queries.data_ptr(), db.data_ptr(), ids.data_ptr(), out.data_ptr(),
        b, r, db.shape[0], d, int(vec4_ok(d, queries, db)), stream)
    cuda_lib.check(code, "gather_dist_f32")
    gather_dist_cuda.launches += 1
    return out


gather_dist_cuda.launches = 0
