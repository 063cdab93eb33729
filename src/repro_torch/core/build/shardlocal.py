"""Shard-local graph derivation: reprune + repair of one shard where it
lives (the reference's ``core/build/shardlocal.py``).

``derive_local`` restates the whole (alpha, degree) derivation —
distance-sorted adjacency -> α-RNG occlusion scan -> connectivity repair —
over one shard's arrays on the shard's own device, so a sharded reprune
never gathers the ``(S * m, R)`` table anywhere. It keeps the reference's
two deviations from ``core/build/finish.py``'s repair:

  * the exact nearest-reachable fallback parent is replaced by the
    *medoid*: an unreachable node without an acceptable reachable kNN
    parent proposes the navigating node instead;
  * reachability is recomputed from the medoid each round, and the round
    count is capped (``max_rounds``); ``force`` (protection override) arms
    after a round that places nothing.

The prune stage is bit-identical to ``build.prune.reprune``: it runs the
same sorted adjacency and the same ``alpha_prune`` (``kernels/alpha_scan``,
one launch per ``blk``-row block on the card). Winners come from
``finish._choose_winners`` (the sort-based scatter-min), the distances
from ``gather_dist``. The reference's in-jit control flow is host control
flow here: one host sync per round and per reachability step.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.build.finish import _choose_winners, propagate_reach
from repro_torch.core.build.prune import pairwise_rows_sqdist, reprune

# Row-block size of the blocked passes below: bounds every f32 temp at
# (BLK, R[, D]) whatever the shard size is.
_BLK = 1024


def _blocked(fn: Callable, n_rows: int, *arrays, blk: int = _BLK):
    """``fn`` over fixed-size row blocks of ``arrays``, concatenated (the
    reference pads to a block multiple for ``lax.map``; eager torch runs
    the short last block as is)."""
    return torch.cat([fn(tuple(a[s:s + blk] for a in arrays))
                      for s in range(0, n_rows, blk)])


def _edge_dists(data: torch.Tensor, nbrs: torch.Tensor,
                rows: Optional[torch.Tensor] = None, blk: int = _BLK):
    """(B, R) d(rows[i], nbrs[i]) — blocked, +inf at -1 padding; ``rows``
    defaults to 0..B-1 (each row's own edges)."""
    if rows is None:
        rows = torch.arange(nbrs.shape[0], device=nbrs.device)

    def f(args):
        rb, ib = args
        return pairwise_rows_sqdist(data[rb.long()], data, ib)

    if nbrs.shape[0] == 0:
        return torch.zeros(nbrs.shape, dtype=torch.float32,
                           device=nbrs.device)
    return _blocked(f, nbrs.shape[0], rows, nbrs, blk=blk)


def _reprune_blocked(data, nbrs, degree: int, alpha, blk: int = _BLK):
    """Streamed sort + α-scan over ``blk``-row blocks: ``reprune`` itself
    at ``chunk=blk`` (rows are independent, so bit-identical to it at any
    chunk)."""
    return reprune(data, nbrs, alpha=alpha, degree=degree, chunk=blk)


def _apply_dense(data, nbrs, prot, parent, win, force: bool,
                 blk: int = _BLK):
    """Attach every winning node beneath its parent.

    The slot rule is ``finish._apply_block``'s (first free slot, else the
    farthest unprotected edge; protection overridden only under
    ``force``); winners hold distinct parents, so the writes cannot
    conflict. The reference's dropped writes (``mode="drop"`` at row N)
    are a masked write here. Returns (nbrs, prot, placed mask).
    """
    n = nbrs.shape[0]
    ok = win & (parent >= 0)
    u = ok.nonzero()[:, 0]
    sp = parent[u].long()
    prow = nbrs[sp]
    free = prow < 0
    has_free = free.any(1)
    first_free = torch.argmax(free.to(torch.uint8), 1)
    dr = _edge_dists(data, prow, rows=sp, blk=blk)
    evictable = ~prot[sp] | force
    dr = torch.where(evictable & (prow >= 0), dr, -1.0)
    evict_slot = torch.argmax(dr, 1)
    can_evict = dr.gather(1, evict_slot[:, None])[:, 0] >= 0
    slot = torch.where(has_free, first_free, evict_slot)
    go = has_free | can_evict
    nbrs = nbrs.clone()
    prot = prot.clone()
    nbrs[sp[go], slot[go]] = u[go].to(nbrs.dtype)
    prot[sp[go], slot[go]] = True
    placed = torch.zeros(n, dtype=torch.bool, device=nbrs.device)
    placed[u[go]] = True
    return nbrs, prot, placed


def repair_local(data: torch.Tensor, nbrs: torch.Tensor,
                 knn_ids: torch.Tensor, medoid,
                 valid: Optional[torch.Tensor] = None, *,
                 max_rounds: int = 16, blk: int = _BLK):
    """Connectivity repair of one shard (the reference's shard_map-safe
    tail).

    Rounds of (reach from medoid -> all unreachable valid nodes propose a
    parent -> one attach per parent): parents are the first *acceptable*
    reachable kNN parent (free or evictable slot — always acceptable
    under ``force``), falling back to the medoid. Repair edges are
    protected from later eviction, so attachment is monotone; ``force``
    arms after a round that places nothing. ``valid`` masks padded rows
    (they are never missing, never parents). Returns (nbrs, rounds).
    """
    n, r = nbrs.shape
    dev = nbrs.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    medoid = int(medoid)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    seed = torch.zeros(n, dtype=torch.bool, device=dev)
    seed[medoid] = True
    nbrs = nbrs.to(torch.int32)
    knn_ids = knn_ids.to(torch.int32)
    prot = torch.zeros((n, r), dtype=torch.bool, device=dev)
    reach = propagate_reach(nbrs, seed) & valid
    force = False
    rounds = 0
    while rounds < max_rounds and bool((valid & ~reach).any()):
        acceptable = reach & ((nbrs < 0).any(1) | (~prot).any(1) | force)
        pk_ok = (knn_ids >= 0) & acceptable[knn_ids.clamp_min(0).long()]
        first = torch.argmax(pk_ok.to(torch.uint8), 1)
        has = pk_ok.any(1)
        parent = torch.where(has, knn_ids.gather(1, first[:, None])[:, 0],
                             medoid)
        parent = torch.where(valid & ~reach & (parent != rows), parent, -1)
        # reach | ~valid: padded rows are never "missing" to the winner
        # selection (shared with finish.py's host-driven repair)
        win = _choose_winners(data, nbrs, prot, reach | ~valid, parent,
                              force)
        nbrs, prot, placed = _apply_dense(data, nbrs, prot, parent, win,
                                          force, blk=blk)
        reach = propagate_reach(nbrs, seed) & valid
        force = not bool(placed.any())
        rounds += 1
    return nbrs, rounds


def derive_local(base: torch.Tensor, neighbors: torch.Tensor,
                 knn_ids: torch.Tensor, medoid,
                 valid: Optional[torch.Tensor] = None, *,
                 alpha: float = 1.0, degree: Optional[int] = None,
                 max_rounds: int = 16, repair: bool = True,
                 blk: int = _BLK) -> torch.Tensor:
    """One shard's (alpha, degree) serving graph from its cached
    max-degree adjacency — sort, α-scan, repair. With ``repair=False``
    returns the prune stage alone, bit-identical to
    ``build.prune.reprune``."""
    n, rmax = neighbors.shape
    degree = rmax if degree is None else min(degree, rmax)
    base = base.float()
    nbrs = _reprune_blocked(base, neighbors, degree, float(alpha), blk=blk)
    if not repair:
        return nbrs
    nbrs, _ = repair_local(base, nbrs, knn_ids, medoid, valid,
                           max_rounds=max_rounds, blk=blk)
    return nbrs
