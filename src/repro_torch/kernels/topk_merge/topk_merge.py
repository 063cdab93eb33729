"""Launch wrapper of the CUDA ``topk_merge`` kernels (``csrc/topk_merge.cu``).

Two variants compute the same function; ``route`` picks one by the row
width M, padded to a power of two p >= 32, and each counts its own
launches in ``topk_merge_cuda.by_variant`` (``topk_merge_cuda.launches`` is
their sum):

- ``warp`` (p <= ``WARP_MAX_SORT``): one warp per row, the keys in
  registers, no block barrier; in pool mode a per-warp hash table finds
  each id's nearest copy and one sort orders the survivors (the NSG pool
  assembly, the device finish's union, NN-Descent's merge);
- ``block`` (p <= ``MAX_SORT``): one 128-thread block per row in shared
  memory, two barrier-separated sorts (wider rows).

``topk_merge_cuda.by_mode`` splits the same launches by mode (``merge``:
NN-Descent's table updates; ``pool``: the pool assembly and the device
finish's union) and variant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib, pow2_at_least

MAX_SORT = 2048          # M, padded to a power of two (at least 32)
WARP_MAX_SORT = 256      # the warp variant's widest row (8 keys per lane)
VARIANTS = ("block", "warp")     # the C entry point's variant codes


def route(m: int, variant: Optional[str] = None) -> str:
    """The variant a row of ``m`` candidates takes; ``variant`` forces one
    (tests, measurements), which must take the width."""
    p = pow2_at_least(max(m, 32))
    if p > MAX_SORT:
        raise ValueError(f"topk_merge_cuda: M={m} exceeds {MAX_SORT}")
    if variant is None:
        return "warp" if p <= WARP_MAX_SORT else "block"
    if variant not in VARIANTS:
        raise ValueError(f"topk_merge_cuda: unknown variant {variant!r}; "
                         f"expected one of {VARIANTS}")
    if variant == "warp" and p > WARP_MAX_SORT:
        raise ValueError(f"topk_merge_cuda: the warp variant takes M <= "
                         f"{WARP_MAX_SORT}; got M={m}")
    return variant


def topk_merge_cuda(ids: torch.Tensor, dists: torch.Tensor,
                    fresh, k: int, merge: bool,
                    variant: Optional[str] = None):
    """(B, M) candidate rows -> dedup'd distance-top-k (ids, dists, fresh).

    ``merge=False`` is ``topk_pool`` (nearest copy of an id wins, ``fresh``
    unused and may be None); ``merge=True`` is ``topk_merge`` (the first
    copy by (fresh, position) wins). See ``csrc/topk_merge.cu``. The
    variant is ``route``'s unless one is forced.
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
    variant = route(m, variant)
    p = pow2_at_least(max(m, 32))
    lib = cuda_lib.library()
    dev = ids.device
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_f = torch.empty((b, k), dtype=torch.bool, device=dev)
    if b == 0:
        return out_i, out_d, out_f       # nothing to launch
    code = lib.topk_merge_rows(
        ids.data_ptr(), dists.data_ptr(),
        fresh.data_ptr() if merge else None, out_i.data_ptr(),
        out_d.data_ptr(), out_f.data_ptr(), b, m, k, p, int(merge),
        VARIANTS.index(variant), torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(code, f"topk_merge_rows ({variant})")
    topk_merge_cuda.launches += 1
    topk_merge_cuda.by_variant[variant] += 1
    topk_merge_cuda.by_mode["merge" if merge else "pool"][variant] += 1
    return out_i, out_d, out_f


topk_merge_cuda.launches = 0
topk_merge_cuda.by_variant = dict.fromkeys(VARIANTS, 0)
topk_merge_cuda.by_mode = {mode: dict.fromkeys(VARIANTS, 0)
                           for mode in ("merge", "pool")}
