"""NSG graph construction (Fu et al., VLDB'19), the reference's
``core/nsg.py`` with the search pools and the host finishing pass.

Build phases:
  1. medoid (navigating node) — one distance pass;
  2. per-node candidate pools: beam search *on the kNN graph* toward each
     node (batched, chunked over nodes), united with the node's own kNN
     list through ``kernels/topk_merge`` (``topk_pool``);
  3. α-RNG occlusion pruning (``build/prune.py``);
  4-5. reverse-edge interconnect + re-prune, then connectivity repair
     (``build/finish.py``, host path).

The table-derived pools (``pools_backend="nndescent"``) and the device
finishing pass are not ported yet and raise.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch.core.beam_search import beam_search
from repro_torch.core.build.finish import finish_nsg, require_host
from repro_torch.core.build.prune import pairwise_rows_sqdist, prune_in_chunks
from repro_torch.core.device import synchronize
from repro_torch.core.distances import nearest
from repro_torch.kernels.topk_merge import topk_pool


class NSGGraph(NamedTuple):
    neighbors: torch.Tensor   # (N, R) int32, -1 padded
    medoid: torch.Tensor      # () int32


class NSGBuildStats(NamedTuple):
    """Work accounting for one NSG build."""
    pools_backend: str     # "search" (the only ported backend)
    n: int
    degree: int
    pool_evals: int        # phase-2 database-distance evaluations
    prune_evals: int       # phases 3-4, derived from the actual widths
    finish_backend: str = "host"
    interconnect_seconds: float = 0.0   # phase-4 wall-clock (to ready)
    repair_seconds: float = 0.0         # phase-5 wall-clock (to ready)
    repair_rounds: int = 0              # attach rounds until reachable
    pools_seconds: float = 0.0          # phase-2 wall-clock (to ready)
    prune_seconds: float = 0.0          # phase-3 wall-clock (to ready)


POOLS_BACKENDS = ("search", "nndescent")


def _candidate_pools(data, knn_ids, medoid, n_candidates, chunk):
    """Per-node candidate pools: beam-search the kNN graph toward each node
    (k = ef = n_candidates, 2 * ef hops at most), then union the node's own
    kNN list, nearest copy of an id first. Returns (N, L) ids + dists sorted
    plus the distance-evaluation count (hops * K + the entry distance + the
    own-list pass, per node)."""
    n, k = knn_ids.shape
    ef = n_candidates
    pools_i, pools_d, hops_parts = [], [], []
    for s in range(0, n, chunk):
        q = data[s:s + chunk]
        entry = torch.full((q.shape[0],), int(medoid), dtype=torch.int32,
                           device=data.device)
        d_pool, i_pool, hops = beam_search(
            q, data, knn_ids, entry, ef=ef, k=ef, max_iters=2 * ef,
            mode="while")
        own = knn_ids[s:s + chunk]
        own_d = pairwise_rows_sqdist(q, data, own)
        hops_parts.append(hops)
        ids, ds = topk_pool(torch.cat([i_pool, own], 1),
                            torch.cat([d_pool, own_d], 1), ef)
        pools_i.append(ids)
        pools_d.append(ds)
    evals = int(torch.cat(hops_parts).sum(dtype=torch.int64)) * k \
        + n * (k + 1)
    return torch.cat(pools_i), torch.cat(pools_d), evals


def build_nsg(data: torch.Tensor, knn_ids: torch.Tensor, *, degree: int,
              n_candidates: int = 64, chunk: int = 2048,
              alpha: float = 1.0, pools_backend: str = "search",
              finish_backend: str = "host", with_stats: bool = False):
    """Build an NSG over ``data`` from its kNN graph.

    Returns the ``NSGGraph`` — plus an ``NSGBuildStats`` when
    ``with_stats`` is set.
    """
    n = data.shape[0]
    if pools_backend not in POOLS_BACKENDS:
        raise ValueError(f"unknown pools backend {pools_backend!r}; "
                         f"expected one of {POOLS_BACKENDS}")
    if pools_backend != "search":
        raise NotImplementedError(
            "pools_backend 'nndescent' is not ported yet (ROADMAP Queue 1 "
            "item 5, the NN-Descent slice); pass pools_backend='search'")
    require_host(finish_backend)
    _, medoid = nearest(data.float().mean(0, keepdim=True), data)
    medoid = medoid[0]

    t_pools = time.perf_counter()
    cand_i, cand_d, pool_evals = _candidate_pools(
        data, knn_ids, medoid, n_candidates, chunk)
    synchronize(cand_d.device)
    t_prune = time.perf_counter()
    node_ids = torch.arange(n, dtype=torch.int32, device=data.device)
    nbrs = prune_in_chunks(data, node_ids, cand_i, cand_d, degree, chunk,
                           alpha)
    synchronize(nbrs.device)
    prune_seconds = time.perf_counter() - t_prune

    nbrs, fstats = finish_nsg(data, nbrs, medoid, knn_ids, degree=degree,
                              alpha=alpha, chunk=chunk)
    graph = NSGGraph(neighbors=nbrs, medoid=medoid)
    if not with_stats:
        return graph
    prune_evals = (n * cand_i.shape[1] * degree + fstats.union_dist_evals
                   + n * fstats.union_width * degree)
    return graph, NSGBuildStats(
        pools_backend=pools_backend, n=n, degree=degree,
        pool_evals=int(pool_evals), prune_evals=int(prune_evals),
        finish_backend=fstats.backend,
        interconnect_seconds=fstats.interconnect_seconds,
        repair_seconds=fstats.repair_seconds,
        repair_rounds=fstats.repair_rounds,
        pools_seconds=t_prune - t_pools, prune_seconds=prune_seconds)
