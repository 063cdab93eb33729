"""Launch wrapper of the CUDA ``topk_merge`` kernel (``csrc/topk_merge.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, pow2_at_least

MAX_SORT = 2048          # M, padded to a power of two (at least 32)


def topk_merge_cuda(ids: torch.Tensor, dists: torch.Tensor,
                    fresh, k: int, merge: bool):
    """(B, M) candidate rows -> dedup'd distance-top-k (ids, dists, fresh).

    ``merge=False`` is ``topk_pool`` (nearest copy of an id wins, ``fresh``
    unused and may be None); ``merge=True`` is ``topk_merge`` (the first
    copy by (fresh, position) wins). See ``csrc/topk_merge.cu``.
    """
    if not (ids.is_cuda and dists.is_cuda) or ids.device != dists.device:
        raise ValueError("topk_merge_cuda: ids and dists must be on one "
                         "CUDA device")
    if ids.dtype != torch.int32 or dists.dtype != torch.float32:
        raise TypeError("topk_merge_cuda: ids int32 and dists float32")
    if ids.dim() != 2 or dists.shape != ids.shape:
        raise ValueError(f"topk_merge_cuda: shapes {tuple(ids.shape)} and "
                         f"{tuple(dists.shape)} disagree")
    if not (ids.is_contiguous() and dists.is_contiguous()):
        raise ValueError("topk_merge_cuda: ids/dists not contiguous")
    if merge:
        if (fresh is None or fresh.dtype != torch.bool or not fresh.is_cuda
                or fresh.shape != ids.shape or not fresh.is_contiguous()):
            raise ValueError("topk_merge_cuda: merge needs a contiguous "
                             "CUDA bool fresh of the ids' shape")
    b, m = ids.shape
    if not 1 <= k <= m:
        raise ValueError(f"topk_merge_cuda: k={k} must be in [1, M={m}]")
    p = pow2_at_least(max(m, 32))
    if p > MAX_SORT:
        raise ValueError(f"topk_merge_cuda: M={m} exceeds {MAX_SORT}")
    lib = cuda_lib.library()
    dev = ids.device
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_f = torch.empty((b, k), dtype=torch.bool, device=dev)
    code = lib.topk_merge_rows(
        ids.data_ptr(), dists.data_ptr(),
        fresh.data_ptr() if merge else None, out_i.data_ptr(),
        out_d.data_ptr(), out_f.data_ptr(), b, m, k, p, int(merge),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(code, "topk_merge_rows")
    topk_merge_cuda.launches += 1
    return out_i, out_d, out_f


topk_merge_cuda.launches = 0
