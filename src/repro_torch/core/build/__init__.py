"""Graph-build subsystem: the kNN-table dispatch (``build_knn``), the
α-RNG pruning primitive and the rebuild-free ``reprune`` family
(``build/prune.py``) and the NSG finishing pass (``build/finish.py``).

Only the exact kNN backend is ported; ``"nndescent"`` raises until the
NN-Descent slice (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch

from repro_torch.core.build.finish import (
    FINISH_BACKENDS, FinishStats, finish_nsg, repair, require_host,
)
from repro_torch.core.build.prune import (
    RepruneFamily, alpha_prune, alpha_prune_mask, mark_dups,
    nsg_from_neighbors, pairwise_rows_sqdist, prune_in_chunks, reprune,
    reprune_family, reprune_nsg, rows_sqdist_in_chunks,
    sorted_adjacency_chunk,
)

__all__ = [
    "AUTO_NND_MIN_N", "FINISH_BACKENDS", "FinishStats", "RepruneFamily",
    "alpha_prune", "alpha_prune_mask", "build_knn", "finish_nsg",
    "mark_dups", "nsg_from_neighbors", "pairwise_rows_sqdist",
    "prune_in_chunks", "repair", "require_host", "reprune",
    "reprune_family", "reprune_nsg", "resolve_backend",
    "rows_sqdist_in_chunks", "sorted_adjacency_chunk",
]

# Below this N the exact pass wins on wall-clock; above it the reference
# switches "auto" to NN-Descent.
AUTO_NND_MIN_N = 8192

_BACKENDS = ("exact", "nndescent", "auto")


def resolve_backend(backend: str, n: int) -> str:
    """Resolve ``"auto"`` against the database size; validate the name."""
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown knn backend {backend!r}; expected one of {_BACKENDS}")
    if backend == "auto":
        return "nndescent" if n >= AUTO_NND_MIN_N else "exact"
    return backend


def build_knn(data: torch.Tensor, k: int, *, backend: str = "auto", **kw):
    """Build the (N, k) kNN graph -> (dists, ids) like ``knn_graph``.

    Extra keyword args reach the exact pass (its chunk sizes).
    """
    from repro_torch.core.knn_graph import knn_graph   # lazy: import cycle

    if resolve_backend(backend, data.shape[0]) == "nndescent":
        raise NotImplementedError(
            "knn backend 'nndescent' is not ported yet (ROADMAP Queue 1 "
            "item 5, the NN-Descent slice); pass knn_backend='exact'")
    return knn_graph(data, k, **kw)
