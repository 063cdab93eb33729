"""Device dispatch for the dedup + distance-top-k primitive.

``topk_merge`` (NN-Descent table update: current rows + proposal
candidates, old copies win dedup) and ``topk_pool`` (NSG pool assembly:
one candidate list, nearest copy wins) both route to one CUDA kernel for
CUDA tensors, and to the plain versions in ``ref.py`` for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.topk_merge.ref import topk_merge_ref, topk_pool_ref
from repro_torch.kernels.topk_merge.topk_merge import topk_merge_cuda


def topk_merge(cur_i, cur_d, cur_f, cand_i, cand_d, k: int,
               backend: Optional[str] = None):
    """Merge (B, K) table rows with (B, M) candidates -> top-k rows.

    Candidates are implicitly fresh; dedup keeps the existing (old) copy
    of an id. Returns (ids, dists, fresh), -1/inf padded.
    """
    if use_kernel(cur_i, backend, "topk_merge"):
        ids = torch.cat([cur_i, cand_i], 1).to(torch.int32).contiguous()
        ds = torch.cat([cur_d, cand_d], 1).float().contiguous()
        fresh = torch.cat(
            [cur_f, torch.ones_like(cand_i, dtype=torch.bool)], 1)
        return topk_merge_cuda(ids, ds, fresh.contiguous(), k, merge=True)
    return topk_merge_ref(cur_i, cur_d, cur_f, cand_i, cand_d, k)


def topk_pool(ids, ds, k: int, backend: Optional[str] = None):
    """Distance-sort + dedup (nearest copy wins) + truncate to k.

    Returns (ids, dists); invalid tail entries come back as (-1, inf).
    """
    if use_kernel(ids, backend, "topk_pool"):
        out_i, out_d, _ = topk_merge_cuda(
            ids.to(torch.int32).contiguous(), ds.float().contiguous(), None,
            k, merge=False)
        return out_i, out_d
    return topk_pool_ref(ids, ds, k)
