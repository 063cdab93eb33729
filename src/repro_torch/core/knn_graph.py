"""Exact k-NN graph construction (build-time substrate for NSG + AntiHub).

O(N^2 D) through the chunked streaming top-k. Callers go through
``core.build.build_knn`` (backend dispatch).
"""
from __future__ import annotations

import torch

from repro_torch.core.distances import l2_topk


def knn_graph(data: torch.Tensor, k: int, query_chunk: int = 4096,
              db_chunk: int = 16384):
    """(N, k) f32 sq-dists + (N, k) int32 neighbor ids, self excluded."""
    n = data.shape[0]
    kk = min(k + 1, n)
    dists, ids = [], []
    for s in range(0, n, query_chunk):
        q = data[s:s + query_chunk]
        d, i = l2_topk(q, data, kk, chunk=db_chunk)
        rows = torch.arange(s, s + q.shape[0], device=data.device)
        # push self-matches to the back (stably), then drop the last column
        d = torch.where(i == rows[:, None], float("inf"), d)
        order = torch.sort(d, dim=1, stable=True).indices[:, :kk - 1]
        dists.append(d.gather(1, order))
        ids.append(i.gather(1, order))
    dists, ids = torch.cat(dists), torch.cat(ids)
    if kk - 1 < k:  # degenerate tiny-N case: pad out to k
        padw = k - (kk - 1)
        dists = torch.nn.functional.pad(dists, (0, padw), value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, padw), value=-1)
    return dists, ids
