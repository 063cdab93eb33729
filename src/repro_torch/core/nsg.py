"""NSG graph construction (Fu et al., VLDB'19), the reference's
``core/nsg.py``.

Build phases:
  1. medoid (navigating node) — one distance pass;
  2. per-node candidate pools, two backends (``pools_backend``):
     * ``"search"`` — beam search *on the kNN graph* toward each node
       (batched, chunked over nodes), united with the node's own kNN list
       through ``kernels/topk_merge`` (``topk_pool``);
     * ``"nndescent"`` — pools derived from the kNN *table* (forward ∪
       reverse ∪ 1-hop expansion, ``build/pools.py``); what ``"auto"``
       resolves to whenever the table's distances are in hand;
  3. α-RNG occlusion pruning (``build/prune.py``);
  4-5. reverse-edge interconnect + re-prune, then connectivity repair
     (``build/finish.py``: the device pass, what ``"auto"`` resolves to,
     or the host path).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from repro_torch.core.beam_search import beam_search
from repro_torch.core.build.finish import finish_nsg, resolve_finish_backend
from repro_torch.core.build.pools import nnd_candidate_pools
from repro_torch.core.build.prune import (
    alpha_prune, pairwise_rows_sqdist, prune_in_chunks,
    rows_sqdist_in_chunks,
)
from repro_torch.core.device import synchronize
from repro_torch.core.distances import nearest
from repro_torch.kernels.topk_merge import topk_pool


class NSGGraph(NamedTuple):
    neighbors: torch.Tensor   # (N, R) int32, -1 padded
    medoid: torch.Tensor      # () int32


class NSGBuildStats(NamedTuple):
    """Work accounting for one NSG build."""
    pools_backend: str     # "search" | "nndescent" (resolved)
    n: int
    degree: int
    pool_evals: int        # phase-2 database-distance evaluations
    prune_evals: int       # phases 3-4, derived from the actual widths
    finish_backend: str = "host"        # "host" | "device" (resolved)
    interconnect_seconds: float = 0.0   # phase-4 wall-clock (to ready)
    repair_seconds: float = 0.0         # phase-5 wall-clock (to ready)
    repair_rounds: int = 0              # attach rounds until reachable
    pools_seconds: float = 0.0          # phase-2 wall-clock (to ready)
    prune_seconds: float = 0.0          # phase-3 wall-clock (to ready)


POOLS_BACKENDS = ("search", "nndescent", "auto")


def resolve_pools_backend(backend: str, knn_dists) -> str:
    """Resolve ``"auto"``: table-derived pools whenever dists are in hand."""
    if backend not in POOLS_BACKENDS:
        raise ValueError(
            f"unknown pools backend {backend!r}; expected one of "
            f"{POOLS_BACKENDS}")
    if backend == "auto":
        return "nndescent" if knn_dists is not None else "search"
    return backend


def mrng_prune(data: torch.Tensor, node_ids: torch.Tensor,
               cand_ids: torch.Tensor, cand_dists: torch.Tensor,
               degree: int) -> torch.Tensor:
    """MRNG edge selection: ``alpha_prune`` at alpha=1 (bit-identical; on
    the card the same ``alpha_scan`` launch)."""
    return alpha_prune(data, node_ids, cand_ids, cand_dists, degree)


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
              alpha: float = 1.0, pools_backend: str = "auto",
              knn_dists: Optional[torch.Tensor] = None,
              finish_backend: str = "auto", with_stats: bool = False):
    """Build an NSG over ``data`` from its kNN graph.

    ``pools_backend``: ``"search"`` (beam-search pools), ``"nndescent"``
    (table-derived pools; without ``knn_dists`` the table's distances are
    computed here, one O(N * K) gather pass counted in ``pool_evals``) or
    ``"auto"`` (table-derived whenever ``knn_dists`` is given).
    ``finish_backend``: ``"device"`` (what ``"auto"`` resolves to) or
    ``"host"``.
    Returns the ``NSGGraph`` — plus an ``NSGBuildStats`` when
    ``with_stats`` is set.
    """
    n = data.shape[0]
    resolved = resolve_pools_backend(pools_backend, knn_dists)
    resolved_finish = resolve_finish_backend(finish_backend)
    _, medoid = nearest(data.float().mean(0, keepdim=True), data)
    medoid = medoid[0]

    t_pools = time.perf_counter()
    if resolved == "nndescent":
        if knn_dists is None:
            knn_dists = rows_sqdist_in_chunks(data, knn_ids, chunk)
            pool_evals = int(n) * int(knn_ids.shape[1])
        else:
            pool_evals = 0
        cand_i, cand_d, ev = nnd_candidate_pools(
            data, knn_ids, knn_dists, n_candidates, chunk=chunk)
        pool_evals += ev
    else:
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
                              alpha=alpha, chunk=chunk,
                              backend=resolved_finish)
    graph = NSGGraph(neighbors=nbrs, medoid=medoid)
    if not with_stats:
        return graph
    # occlusion + interconnect work derived from the widths actually built
    prune_evals = (n * cand_i.shape[1] * degree + fstats.union_dist_evals
                   + n * fstats.union_width * degree)
    return graph, NSGBuildStats(
        pools_backend=resolved, n=n, degree=degree,
        pool_evals=int(pool_evals), prune_evals=int(prune_evals),
        finish_backend=fstats.backend,
        interconnect_seconds=fstats.interconnect_seconds,
        repair_seconds=fstats.repair_seconds,
        repair_rounds=fstats.repair_rounds,
        pools_seconds=t_prune - t_pools, prune_seconds=prune_seconds)
