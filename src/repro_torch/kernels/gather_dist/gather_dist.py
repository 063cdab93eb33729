"""Launch wrapper of the CUDA ``gather_dist`` kernel (``csrc/gather_dist.cu``).

Four modes: f32 rows, bf16 rows, and either with the prenorm distance
(``norms`` given). ``gather_dist_cuda.by_mode`` counts each mode's
launches (``MODES``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.op_costs import record_kernel
from repro_torch.kernels import card_or_meta, cuda_lib

ROW_DTYPES = (torch.float32, torch.bfloat16)
MODES = ("f32", "bf16", "prenorm", "bf16+prenorm")


def mode_of(db: torch.Tensor, norms: Optional[torch.Tensor]) -> str:
    """The kernel mode of rows ``db`` with or without ``norms``."""
    rows = "bf16" if db.dtype == torch.bfloat16 else "f32"
    if norms is None:
        return rows
    return "prenorm" if rows == "f32" else "bf16+prenorm"


def check_rows(name: str, db: torch.Tensor,
               norms: Optional[torch.Tensor]) -> None:
    """Raise unless ``db`` is f32 or bf16 rows and ``norms`` is None or an
    (N,) f32 contiguous tensor on db's device."""
    if db.dtype not in ROW_DTYPES:
        raise TypeError(f"{name}: db must be float32 or bfloat16, got "
                        f"{db.dtype}")
    if norms is None:
        return
    if norms.device != db.device or norms.dtype != torch.float32:
        raise TypeError(f"{name}: norms must be float32 on {db.device}")
    if norms.shape != (db.shape[0],) or not norms.is_contiguous():
        raise ValueError(f"{name}: norms must be a contiguous "
                         f"({db.shape[0]},) tensor, got "
                         f"{tuple(norms.shape)}")


def _check_operands(queries, db, ids, norms):
    if not card_or_meta(queries, db, ids):
        raise ValueError("gather_dist_cuda: every operand must be on CUDA "
                         "(or all on meta)")
    if queries.device != db.device or ids.device != db.device:
        raise ValueError("gather_dist_cuda: operands on different devices")
    if queries.dtype != torch.float32:
        raise TypeError("gather_dist_cuda: queries must be float32")
    check_rows("gather_dist_cuda", db, norms)
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


def rows_vec4_ok(d: int, queries: torch.Tensor, db: torch.Tensor) -> bool:
    """Queries read as float4 and rows as 4-element chunks: d % 4 == 0,
    the queries 16-byte aligned, the rows aligned to their chunk (16 bytes
    of f32, 8 of bf16)."""
    return (d % 4 == 0 and queries.data_ptr() % 16 == 0
            and db.data_ptr() % (4 * db.element_size()) == 0)


def cost(b: int, r: int, d: int, row_bytes: int, prenorm: bool):
    """(FLOPs, bytes) of one launch, every id counted valid (the shapes
    alone: no host read): the queries, ids and R rows per query read once,
    the norms of those rows under prenorm, the distances written; 3 FLOPs
    per element (difference, square, add; 2 under prenorm: multiply,
    add)."""
    nbytes = b * d * 4 + b * r * 4 + b * r * d * row_bytes + b * r * 4 \
        + (b * r * 4 if prenorm else 0)
    return (2 if prenorm else 3) * b * r * d, nbytes


def gather_dist_cuda(queries: torch.Tensor, db: torch.Tensor,
                     ids: torch.Tensor,
                     norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """queries (B, D) f32, db (N, D) f32 or bf16, ids (B, R) int32 [,
    norms (N,) f32: the prenorm distance] -> (B, R) f32. Meta operands:
    the output, the cost recorded, no launch."""
    _check_operands(queries, db, ids, norms)
    b, d = queries.shape
    r = ids.shape[1]
    out = torch.empty((b, r), dtype=torch.float32, device=db.device)
    record_kernel("gather_dist", *cost(b, r, d, db.element_size(),
                                       norms is not None))
    if db.is_meta:
        return out
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(db.device).cuda_stream
    code = lib.gather_dist_rows(
        queries.data_ptr(), db.data_ptr(), ids.data_ptr(),
        None if norms is None else norms.data_ptr(), out.data_ptr(), b, r,
        db.shape[0], d, int(rows_vec4_ok(d, queries, db)),
        int(db.dtype == torch.bfloat16), stream)
    cuda_lib.check(code, "gather_dist_rows")
    gather_dist_cuda.launches += 1
    gather_dist_cuda.by_mode[mode_of(db, norms)] += 1
    return out


gather_dist_cuda.launches = 0
gather_dist_cuda.by_mode = dict.fromkeys(MODES, 0)
