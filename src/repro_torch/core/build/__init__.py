"""Graph-build subsystem: the kNN-table dispatch (``build_knn``: the exact
pass or NN-Descent, ``build/nn_descent.py``), the table-derived NSG pools
(``build/pools.py``), the α-RNG pruning primitive and the rebuild-free
``reprune`` family (``build/prune.py``), the NSG finishing pass with its
host and device backends (``build/finish.py``), and the out-of-core tier's
pieces: chunk streaming and the host-offload store (``build/stream.py``)
and the shard-local derivation (``build/shardlocal.py``).
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from repro_torch.core.build.finish import (
    FINISH_BACKENDS, FinishStats, finish_nsg, reachable_mask, repair,
    repair_connectivity_device, resolve_finish_backend,
)
from repro_torch.core.build.nn_descent import BuildStats, NNDDraws, \
    nn_descent
from repro_torch.core.build.pools import nnd_candidate_pools
from repro_torch.core.build.prune import (
    RepruneFamily, alpha_prune, alpha_prune_mask, mark_dups,
    nsg_from_neighbors, pairwise_rows_sqdist, prune_in_chunks, reprune,
    reprune_family, reprune_nsg, rows_sqdist_in_chunks, sorted_adjacency,
    sorted_adjacency_chunk,
)
from repro_torch.core.build.shardlocal import derive_local, repair_local
from repro_torch.core.build.stream import (
    DEFAULT_CHUNK, HostOffloadStore, chunk_spans,
)

__all__ = [
    "AUTO_NND_MIN_N", "BuildStats", "DEFAULT_CHUNK", "FINISH_BACKENDS",
    "FinishStats", "HostOffloadStore", "NNDDraws", "RepruneFamily",
    "alpha_prune", "alpha_prune_mask", "build_knn", "chunk_spans",
    "derive_local", "finish_nsg", "knn_graph_recall", "mark_dups",
    "nn_descent", "nnd_candidate_pools", "nsg_from_neighbors",
    "pairwise_rows_sqdist", "prune_in_chunks", "reachable_mask", "repair",
    "repair_connectivity_device", "repair_local", "reprune",
    "reprune_family", "reprune_nsg",
    "resolve_backend", "resolve_finish_backend", "rows_sqdist_in_chunks",
    "sorted_adjacency", "sorted_adjacency_chunk",
]

# Below this N the exact pass wins on wall-clock (one matmul sweep, no
# refinement rounds) and is exact for free; above it "auto" switches to
# NN-Descent.
AUTO_NND_MIN_N = 8192

_BACKENDS = ("exact", "nndescent", "auto")

# rows per block of ``knn_graph_recall``: its (rows, k, k) compare stays
# small
_RECALL_ROWS = 4096


def knn_graph_recall(approx_ids, exact_ids) -> float:
    """Mean overlap between an approximate and the exact kNN id table.

    -1 padding never counts as a hit; the denominator is the number of
    valid exact entries; each distinct exact id of a row counts once (the
    reference's per-row ``np.intersect1d``), here in row blocks on the
    tables' device.
    """
    approx = torch.as_tensor(np.asarray(approx_ids)) \
        if not torch.is_tensor(approx_ids) else approx_ids
    exact = torch.as_tensor(np.asarray(exact_ids)) \
        if not torch.is_tensor(exact_ids) else exact_ids
    approx = approx.to(exact.device)
    hits, valid = 0, 0
    for s in range(0, exact.shape[0], _RECALL_ROWS):
        a, e = approx[s:s + _RECALL_ROWS], exact[s:s + _RECALL_ROWS]
        ok = e >= 0
        found = ((a[:, None, :] == e[:, :, None]) & (a[:, None, :] >= 0)
                 ).any(-1)
        seen = torch.ones(e.shape[1], e.shape[1], dtype=torch.bool,
                          device=e.device).tril(-1)
        first = ~((e[:, :, None] == e[:, None, :]) & seen).any(-1)
        hits += int((ok & found & first).sum())
        valid += int(ok.sum())
    return hits / max(valid, 1)


def resolve_backend(backend: str, n: int) -> str:
    """Resolve ``"auto"`` against the database size; validate the name."""
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown knn backend {backend!r}; expected one of {_BACKENDS}")
    if backend == "auto":
        return "nndescent" if n >= AUTO_NND_MIN_N else "exact"
    return backend


def build_knn(data: torch.Tensor, k: int, *, backend: str = "auto",
              draws=None, with_stats: bool = False, **kw):
    """Build the (N, k) kNN graph with the selected backend.

    Returns (dists, ids) like ``knn_graph`` — plus a ``BuildStats`` when
    ``with_stats`` is set. ``draws`` reaches NN-Descent (its random draws,
    an ``NNDDraws``); extra keyword args reach the backend (chunk sizes for
    exact, rounds and sampling for NN-Descent). Under ``"auto"`` the
    keyword args the resolved backend does not take are dropped, since the
    caller cannot know which backend runs.
    """
    from repro_torch.core.knn_graph import knn_graph   # lazy: import cycle

    n = data.shape[0]
    resolved = resolve_backend(backend, n)
    if backend == "auto" and kw:
        fn = knn_graph if resolved == "exact" else nn_descent
        accepted = set(inspect.signature(fn).parameters)
        kw = {k_: v for k_, v in kw.items() if k_ in accepted}
    if resolved == "exact":
        d, i = knn_graph(data, k, **kw)
        if with_stats:
            return d, i, BuildStats(backend="exact", n=n, k=k,
                                    distance_evals=n * n, rounds=1,
                                    update_rate=0.0)
        return d, i
    return nn_descent(data, k, draws=draws, with_stats=with_stats, **kw)
