"""Exact L2 distance + top-k (the reference's ``core/distances.py``).

``l2_topk`` goes through ``kernels/l2topk``: on CUDA tensors the
hand-written kernel, on CPU tensors its plain version (the chunked
``torch.matmul`` + packed-key ``torch.topk`` pass in
``kernels/l2topk/ref.py``). Both use the matmul form
``|q|^2 + |x|^2 - 2 q.x`` clamped at 0 and the reference's ``lax.top_k``
tie rule: among equal distances the lower id comes first. ``l2_topk`` and
``pairwise_sqdist`` live in ``kernels/l2topk`` and are re-exported here,
where the reference defines them. The reference's ``match_vma`` (a
``shard_map`` typing aid) has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.l2topk.ops import l2_topk
from repro_torch.kernels.l2topk.ref import (  # noqa: F401  (re-exported)
    pack_keys, pairwise_sqdist, unpack_keys,
)

__all__ = ["l2_topk", "nearest", "pack_keys", "pairwise_sqdist",
           "smallest_k", "unpack_keys"]


def nearest(queries: torch.Tensor, database: torch.Tensor,
            chunk: int = 16384):
    """argmin-L2 id and distance per query (k=1 fast path)."""
    d, i = l2_topk(queries, database, 1, chunk=chunk)
    return d[:, 0], i[:, 0]


def smallest_k(d: torch.Tensor, k: int):
    """The k smallest entries of each row of ``d`` (all >= 0, +inf allowed)
    and their int32 positions, ties by lower position: the rule of the
    reference's ``lax.top_k(-d, k)``, which ``torch.topk`` alone does not
    promise. It selects on ``pack_keys``' (distance bits, position) keys,
    which are all distinct, so the order is the same on either device."""
    k = min(k, d.shape[1])
    pos = torch.arange(d.shape[1], device=d.device).expand(d.shape[0], -1)
    keys = torch.topk(pack_keys(d, pos), k, dim=1, largest=False,
                      sorted=True).values
    return unpack_keys(keys)
