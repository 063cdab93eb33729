"""Host-side batching (paper Algorithms 1 & 2; the reference's
``core/batching.py``).

The batched search gives every query its own entry point natively, so the
grouping trick is unnecessary there. These versions reproduce the paper's
CPU/Faiss-style execution so the Algorithm-1-vs-2 comparison (its batching
contribution) can be measured: Algorithm 1 searches one query at a time;
Algorithm 2 groups the batch by optimal entry point and runs one batched
search per group — identical results, more batch parallelism. Both return
numpy arrays, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.beam_search import beam_search


def _orig_ids(index, ii: torch.Tensor) -> np.ndarray:
    kept = index.kept_idx.cpu().numpy()
    ii = ii.cpu().numpy()
    return np.where(ii >= 0, kept[np.maximum(ii, 0)], -1)


def search_naive(index, queries, k: int):
    """Algorithm 1: per-query entry point, single-query searches."""
    q = index.project(queries)
    eps = index.eps.select(q)
    out_d = np.empty((q.shape[0], k), np.float32)
    out_i = np.empty((q.shape[0], k), np.int64)
    for qi in range(q.shape[0]):
        d, i, _ = beam_search(
            q[qi: qi + 1], index.base, index.graph.neighbors,
            eps[qi: qi + 1], ef=max(index.params.ef_search, k), k=k)
        out_d[qi] = d[0].cpu().numpy()
        out_i[qi] = _orig_ids(index, i[0])
    return out_d, out_i


def search_grouped(index, queries, k: int):
    """Algorithm 2: group queries by entry point; batch within groups."""
    q = index.project(queries)
    eps = index.eps.select(q).cpu().numpy()
    out_d = np.empty((q.shape[0], k), np.float32)
    out_i = np.empty((q.shape[0], k), np.int64)
    for ep in np.unique(eps):                      # paper's L2
        sel = np.nonzero(eps == ep)[0]             # paper's L3
        batch = q[torch.as_tensor(sel, device=q.device)]     # paper's L4
        d, i, _ = beam_search(                     # paper's L7 (batched)
            batch, index.base, index.graph.neighbors,
            torch.full((len(sel),), int(ep), dtype=torch.int32,
                       device=q.device),
            ef=max(index.params.ef_search, k), k=k)
        out_d[sel] = d.cpu().numpy()
        out_i[sel] = _orig_ids(index, i)
    return out_d, out_i
