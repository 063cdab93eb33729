"""Launch wrapper of the CUDA ``l2topk`` kernel (``csrc/l2topk.cu``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import cuda_lib

MAX_K = 128          # the kernel's list capacity
BLOCK_Q, BLOCK_N = 64, 128   # the kernel's query and database tiles


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(nq: int, n: int, sm_count: int):
    """(splits, tiles per split): as many database splits as keep the
    grid within one wave of two blocks per SM (a second, part-filled wave
    would idle most of the card), and no split left empty."""
    q_tiles = -(-nq // BLOCK_Q)
    n_tiles = -(-n // BLOCK_N)
    want = min(n_tiles, max(1, 2 * sm_count // q_tiles))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def _check_operands(queries, database, k):
    if not (queries.is_cuda and database.is_cuda):
        raise ValueError("l2topk_cuda: queries and database must be on CUDA")
    if queries.device != database.device:
        raise ValueError("l2topk_cuda: operands on different devices")
    if queries.dtype != torch.float32 or database.dtype != torch.float32:
        raise TypeError("l2topk_cuda: queries and database must be float32")
    if queries.dim() != 2 or database.dim() != 2 \
            or queries.shape[1] != database.shape[1]:
        raise ValueError(f"l2topk_cuda: expected (Q, D) and (N, D), got "
                         f"{tuple(queries.shape)} and "
                         f"{tuple(database.shape)}")
    if database.shape[0] == 0 or database.shape[1] == 0:
        raise ValueError("l2topk_cuda: empty database")
    if not (queries.is_contiguous() and database.is_contiguous()):
        raise ValueError("l2topk_cuda: operands must be contiguous")
    if k < 1:
        raise ValueError(f"l2topk_cuda: k={k} must be >= 1")
    if min(k, database.shape[0]) > MAX_K:
        raise ValueError(f"l2topk_cuda: k={k} exceeds the kernel's "
                         f"{MAX_K}-entry lists")


def l2topk_cuda(queries: torch.Tensor, database: torch.Tensor, k: int):
    """queries (Q, D) f32, database (N, D) f32 -> (dists (Q, k) f32
    ascending, ids (Q, k) int32), ties by lower id; k is cut to N."""
    _check_operands(queries, database, k)
    nq, d = queries.shape
    n = database.shape[0]
    k = min(k, n)
    dev = database.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    splits, per = split_plan(nq, n, _sm_count(dev))
    norms = torch.empty(nq + n, dtype=torch.float32, device=dev)
    partial = (torch.empty((splits, nq, k), dtype=torch.int64, device=dev)
               if splits > 1 else None)
    lib = cuda_lib.library()
    code = lib.l2topk_f32(
        queries.data_ptr(), database.data_ptr(), norms.data_ptr(),
        None if partial is None else partial.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), nq, n, d, k, splits, per,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(code, "l2topk_f32")
    # norms, the tile kernel, and the merge when the database is split
    l2topk_cuda.launches += 3 if splits > 1 else 2
    return out_d, out_i


l2topk_cuda.launches = 0
