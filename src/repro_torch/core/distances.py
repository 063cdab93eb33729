"""Chunked exact L2 distance + top-k (the reference's ``core/distances.py``).

Distances use the matmul form ``|q|^2 + |x|^2 - 2 q.x`` clamped at 0, and
the database is scanned in ``chunk``-row blocks with a running top-k, so
the full (Q, N) matrix never exists. The tie rule is the reference's
``lax.top_k`` one: among equal distances the lower id comes first. It is
made exact by selecting on a packed int64 key, (f32 bits of the distance
<< 32) | id, whose values are all distinct.
"""
from __future__ import annotations

import torch


def pairwise_sqdist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances. q: (Q, D), x: (N, D) -> (Q, N)."""
    q32, x32 = q.float(), x.float()
    qn = (q32 * q32).sum(-1, keepdim=True)                   # (Q, 1)
    xn = (x32 * x32).sum(-1)                                 # (N,)
    return (qn + xn[None, :] - 2.0 * (q32 @ x32.T)).clamp_min(0.0)


def pack_keys(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(dist >= 0, id >= 0) -> int64 keys ordered by (dist, id)."""
    bits = (d + 0.0).view(torch.int32).long()     # + 0.0: -0.0 -> +0.0
    return (bits << 32) | ids.long()


def unpack_keys(keys: torch.Tensor):
    """Inverse of ``pack_keys`` -> (dists f32, ids int32)."""
    d = (keys >> 32).to(torch.int32).view(torch.float32)
    return d, (keys & 0xFFFFFFFF).to(torch.int32)


def l2_topk(queries: torch.Tensor, database: torch.Tensor, k: int,
            chunk: int = 16384):
    """Exact k smallest L2^2 distances of each query against the database.

    Returns (dists (Q, k) f32 ascending, ids (Q, k) int32), ties by id.
    """
    n = database.shape[0]
    k = min(k, n)
    best = None
    for s in range(0, n, chunk):
        blk = database[s:s + chunk]
        ids = torch.arange(s, s + blk.shape[0], device=database.device)
        keys = pack_keys(pairwise_sqdist(queries, blk),
                         ids[None, :].expand(queries.shape[0], -1))
        if best is not None:
            keys = torch.cat([best, keys], dim=1)
        best = torch.topk(keys, min(k, keys.shape[1]), dim=1,
                          largest=False, sorted=True).values
    return unpack_keys(best)


def nearest(queries: torch.Tensor, database: torch.Tensor,
            chunk: int = 16384):
    """argmin-L2 id and distance per query (k=1 fast path)."""
    d, i = l2_topk(queries, database, 1, chunk=chunk)
    return d[:, 0], i[:, 0]
