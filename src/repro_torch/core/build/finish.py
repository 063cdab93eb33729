"""NSG finishing pass: reverse interconnect + connectivity repair (the
reference's ``core/build/finish.py``), with both of its backends:

  * ``"device"`` (what ``"auto"`` resolves to) —
      - reverse edges accumulate by salted scatter-min into an oversampled
        (N, 4 * rev_cap) slot buffer (the nearest source per slot wins, the
        last writer among equals), of which each row keeps its nearest
        ``rev_cap``; reverse distances are the forward ones, so the union
        costs one O(N * R) gather-distance pass;
      - the forward ∪ reverse union sorts and dedups through
        ``kernels/topk_merge``'s pool mode, then is re-pruned;
      - reachability is frontier propagation to a fixpoint (one boolean
        scatter over the adjacency per step, one host sync per step for
        its ``any`` check; ``propagate_reach.steps`` counts them);
      - repair attaches every unreachable node per round beneath its first
        reachable kNN parent that can accept (exact nearest acceptable node
        otherwise), one attachment per parent per round, repair edges
        protected from eviction.
  * ``"host"`` — the reference's parity baseline, held to its graph
    exactly. Two of its steps are vectorized without changing their
    result: the reverse lists keep "the first ``rev_cap`` sources in
    ascending source order" through a stable sort of the edges by target,
    and the BFS from the medoid expands whole numpy frontiers. The attach
    loop after the BFS stays sequential, as in the reference.

The device path's scatters go through ``build/scatter.py`` (deterministic
winners, a spare row for dropped updates); torch's ``argmax`` / ``argmin``
return the first index among ties, as the reference's do.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.build.prune import (
    mark_dups, pairwise_rows_sqdist, prune_in_chunks, rows_sqdist_in_chunks,
)
from repro_torch.core.build.scatter import hash_slot, \
    nearest_last_writer, scatter_min
from repro_torch.core.device import synchronize
from repro_torch.kernels.topk_merge import topk_pool

FINISH_BACKENDS = ("host", "device", "auto")

# Rows per block of the fallback-parent search (a (block, N) product) and
# of the attach step
_FB_BLOCK = 256

# Reverse edges hash into OVERSAMPLE * rev_cap slots before the nearest
# rev_cap are kept, so hash collisions rarely drop an edge outright
_REV_OVERSAMPLE = 4

_SALT = 0x9E3779B9                     # fixed: builds stay deterministic

INF = float("inf")


class FinishStats(NamedTuple):
    """Work + wall-clock accounting for one finishing pass."""
    backend: str               # "host" | "device" (resolved)
    union_width: int           # forward + reverse union width actually built
    union_dist_evals: int      # distance evals the union pass issued
    interconnect_seconds: float
    repair_seconds: float
    repair_rounds: int         # attach rounds until medoid-reachable


def resolve_finish_backend(backend: str) -> str:
    """Resolve ``"auto"`` (-> the device path); validate the name."""
    if backend not in FINISH_BACKENDS:
        raise ValueError(
            f"unknown finish backend {backend!r}; expected one of "
            f"{FINISH_BACKENDS}")
    return "device" if backend == "auto" else backend


# ---------------------------------------------------------------------------
# Reverse-edge interconnect
# ---------------------------------------------------------------------------


def _reverse_buffer(nbrs: torch.Tensor, nbr_dists: torch.Tensor,
                    slots: int):
    """(N, slots) reverse-edge slot buffer via salted scatter-min.

    Every edge u->v lands in slot ``hash(u ^ salt) % slots`` of v; the
    nearest source per slot wins, and among equally near ones the last
    edge in flat order (the reference's winner re-scatter).
    """
    n, r = nbrs.shape
    dev = nbrs.device
    src = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(r)
    dst = nbrs.reshape(-1).long()
    d = torch.where(dst >= 0, nbr_dists.reshape(-1).float(), INF)
    spare = n * slots
    cell = torch.where(dst >= 0, dst * slots + hash_slot(src, slots, _SALT),
                       spare)
    pos, first = nearest_last_writer(cell, d)       # the edge e = u * r + j
    w_cell = cell[pos]
    tgt = torch.where(first & (w_cell < spare), w_cell, spare)
    buf_i = torch.full((spare + 1,), -1, dtype=torch.int32, device=dev)
    buf_d = torch.full((spare + 1,), INF, dtype=torch.float32, device=dev)
    buf_i[tgt] = (pos // r).to(torch.int32)
    buf_d[tgt] = d[pos]
    return buf_i[:spare].view(n, slots), buf_d[:spare].view(n, slots)


def _interconnect_device(data, nbrs, degree, alpha, chunk, rev_cap):
    """Forward ∪ scatter-min reverse -> topk_pool dedup -> re-prune."""
    n, r = nbrs.shape
    node_ids = torch.arange(n, dtype=torch.int32, device=data.device)
    nbrs = nbrs.to(torch.int32)
    nbr_d = rows_sqdist_in_chunks(data, nbrs, chunk)   # the only new dists
    rev_i, rev_d = _reverse_buffer(nbrs, nbr_d, _REV_OVERSAMPLE * rev_cap)
    width = r + rev_cap
    union_i, union_d = [], []
    for s in range(0, n, chunk):
        # the nearest rev_cap of the oversampled buffer, lower slot first
        # among equals (``lax.top_k``'s order); forward edges are never
        # truncated
        pos = torch.sort(rev_d[s:s + chunk], dim=1,
                         stable=True).indices[:, :rev_cap]
        ids = torch.cat([nbrs[s:s + chunk], rev_i[s:s + chunk].gather(1, pos)],
                        1)
        ds = torch.cat([nbr_d[s:s + chunk], rev_d[s:s + chunk].gather(1, pos)],
                       1)
        ids, ds = topk_pool(ids, ds, width)
        union_i.append(ids)
        union_d.append(ds)
    out = prune_in_chunks(data, node_ids, torch.cat(union_i),
                          torch.cat(union_d), degree, chunk, alpha)
    return out, width, n * r


def reverse_lists(nbrs_np: np.ndarray, rev_cap: int) -> np.ndarray:
    """(N, rev_cap) reverse adjacency: for each target v, the first
    ``rev_cap`` sources p with an edge p -> v, in ascending (source, slot)
    order, -1 padded — the reference's ragged append, vectorized."""
    n = nbrs_np.shape[0]
    src, col = np.nonzero(nbrs_np >= 0)            # row-major edge order
    dst = nbrs_np[src, col]
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    rank = np.arange(dst.size) - np.searchsorted(dst, dst, side="left")
    keep = rank < rev_cap
    rev = np.full((n, rev_cap), -1, np.int32)
    rev[dst[keep], rank[keep]] = src[keep]
    return rev


def _interconnect_host(data, nbrs, degree, alpha, chunk, rev_cap):
    """Ragged reverse append, first-cap truncation, stable sort + dedup,
    re-prune (the reference's host path)."""
    n = nbrs.shape[0]
    dev = data.device
    node_ids = torch.arange(n, dtype=torch.int32, device=dev)
    nbrs_np = nbrs.cpu().numpy()
    union = np.concatenate([nbrs_np, reverse_lists(nbrs_np, rev_cap)], 1)
    union_t = torch.from_numpy(union).to(dev)
    union_d = rows_sqdist_in_chunks(data, union_t, chunk)
    order = torch.sort(union_d + 0.0, dim=1, stable=True).indices
    union_t, union_d = union_t.gather(1, order), union_d.gather(1, order)
    dup = mark_dups(union_t)
    union_t = torch.where(dup, -1, union_t)
    union_d = torch.where(dup, float("inf"), union_d)
    order = torch.sort(union_d + 0.0, dim=1, stable=True).indices
    union_t, union_d = union_t.gather(1, order), union_d.gather(1, order)
    out = prune_in_chunks(data, node_ids, union_t, union_d, degree, chunk,
                          alpha)
    width = union.shape[1]
    return out, width, n * width


def interconnect(data, nbrs, *, degree: int, alpha: float = 1.0,
                 chunk: int = 2048, backend: str = "auto"):
    """Reverse-edge interconnect + re-prune (NSG phase 4), with reverse
    lists capped at 2 * degree (the reference's default cap: the union is
    3R wide on both backends).

    Returns (pruned (N, degree) neighbors, union width, union distance
    evals).
    """
    backend = resolve_finish_backend(backend)
    rev_cap = 2 * degree
    if backend == "host":
        return _interconnect_host(data, nbrs, degree, alpha, chunk, rev_cap)
    return _interconnect_device(data, nbrs, degree, alpha, chunk, rev_cap)


# ---------------------------------------------------------------------------
# Reachability
# ---------------------------------------------------------------------------


def propagate_reach(nbrs: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Close an (N,) bool seed set under edge-following, to fixpoint.

    One boolean scatter over every edge whose source is reached, per step,
    until a step reaches nothing new (at most N + 1 steps, as the
    reference's ``while_loop``). Each step's ``any`` check is one host
    sync; ``propagate_reach.steps`` counts the steps.
    """
    n = nbrs.shape[0]
    edge = nbrs >= 0
    reach = seed.clone()
    it = 0
    changed = True
    while changed and it <= n:
        tgt = torch.where(edge & reach[:, None], nbrs, n).reshape(-1).long()
        new = torch.cat([reach, reach.new_zeros(1)])
        new[tgt] = True                       # every writer writes True
        new = new[:n]
        changed = bool((new != reach).any())
        propagate_reach.steps += 1
        reach = new
        it += 1
    return reach


propagate_reach.steps = 0


def reachable_mask(nbrs: torch.Tensor, medoid) -> torch.Tensor:
    """(N,) bool: reachable from the medoid over the directed adjacency
    (``propagate_reach`` seeded with the medoid alone)."""
    seed = torch.zeros(nbrs.shape[0], dtype=torch.bool, device=nbrs.device)
    seed[int(medoid)] = True
    return propagate_reach(nbrs, seed)


# ---------------------------------------------------------------------------
# Batched connectivity repair
# ---------------------------------------------------------------------------


def _parent_candidates(nbrs, prot, reach, knn_ids, force: bool):
    """Per node: the first reachable kNN parent that can accept an edge.

    Acceptable parents are reachable rows with a free slot or an
    unprotected (evictable) one; under ``force`` every reachable row
    accepts. Returns (parent (N,), has_parent (N,), acceptable (N,)).
    """
    acceptable = (nbrs < 0).any(1) | (~prot).any(1)
    acceptable = (acceptable | force) & reach
    ok = (knn_ids >= 0) & acceptable[knn_ids.clamp_min(0).long()]
    first = torch.argmax(ok.to(torch.uint8), 1)
    has = ok.any(1)
    parent = torch.where(has, knn_ids.gather(1, first[:, None])[:, 0], -1)
    return parent.to(torch.int32), has, acceptable


def _nearest_acceptable(data, norms, acceptable, blk):
    """Exact nearest acceptable parent for a block of node ids: one
    (B, N) product (``torch.matmul``, as the reference leaves it to XLA)."""
    q = data[blk.long()]
    d = ((q * q).sum(-1, keepdim=True) + norms[None, :]
         - 2.0 * torch.matmul(q, data.T))
    self_col = torch.arange(data.shape[0], device=data.device)[None, :] \
        == blk[:, None]
    d = torch.where(acceptable[None, :] & ~self_col, d, INF)
    best = torch.argmin(d, 1)
    found = torch.isfinite(d.gather(1, best[:, None])[:, 0])
    return torch.where(found, best, -1).to(torch.int32)


def _choose_winners(data, nbrs, prot, reach, parent, force: bool):
    """(N,) bool: nodes that attach this round, one per parent.

    Conflicts resolve by scatter-min on d(node, parent), then on the node
    id; a winner stands only if its parent has a free slot or an occupied
    unprotected one (or ``force``).
    """
    n = nbrs.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=nbrs.device)
    valid = ~reach & (parent >= 0)
    safe_p = parent.clamp_min(0).long()
    # d(u, parent(u)) in diff-square form: gather_dist's function
    d_up = pairwise_rows_sqdist(data, data, parent[:, None])[:, 0]
    d_up = torch.where(valid, d_up, INF)
    pidx = torch.where(valid, safe_p, n)
    best_d = scatter_min(pidx, d_up, n + 1, INF)
    cand = valid & (d_up <= best_d[safe_p])
    best_u = scatter_min(torch.where(cand, safe_p, n), rows, n + 1,
                         2 ** 31 - 1)
    win = cand & (best_u[safe_p] == rows)
    prow = nbrs[safe_p]
    can_place = ((prow < 0).any(1)
                 | ((~prot[safe_p] | force) & (prow >= 0)).any(1))
    return win & can_place


def _apply_block(data, nbrs_p, prot_p, parent, blk, force: bool):
    """Attach one block of winning nodes in place.

    ``nbrs_p`` / ``prot_p`` carry a spare row N that takes the dropped
    writes. The slot is the first free one, else the farthest unprotected
    edge (any edge under ``force``); the new edge is marked protected.
    Winners hold distinct parents, so the block's writes cannot conflict.
    Returns the number of evictions.
    """
    n = nbrs_p.shape[0] - 1
    u = blk.long()
    p = parent[u]
    ok = p >= 0
    sp = p.clamp_min(0).long()
    prow = nbrs_p[sp]                                       # (B, R)
    free = prow < 0
    has_free = free.any(1)
    first_free = torch.argmax(free.to(torch.uint8), 1)
    dr = pairwise_rows_sqdist(data[sp], data, prow)
    evictable = ~prot_p[sp] | force
    dr = torch.where(evictable & (prow >= 0), dr, -1.0)
    evict_slot = torch.argmax(dr, 1)
    can_evict = dr.gather(1, evict_slot[:, None])[:, 0] >= 0
    slot = torch.where(has_free, first_free, evict_slot)
    ok = ok & (has_free | can_evict)
    tgt = torch.where(ok, sp, n)
    nbrs_p[tgt, slot] = blk.to(torch.int32)
    prot_p[tgt, slot] = True
    return int((ok & ~has_free).sum())


def _blocks(ids: torch.Tensor):
    """``ids`` in blocks of ``_FB_BLOCK`` (the reference's
    ``_padded_blocks`` pads each to that size so its jitted block functions
    never retrace; eager torch needs no padding)."""
    for s in range(0, ids.numel(), _FB_BLOCK):
        yield ids[s:s + _FB_BLOCK]


def _repair_round(data, nbrs_p, prot_p, reach, parent, force: bool):
    """One attach round: dense winner selection, then the winners applied
    block by block. Returns (placed-node mask, eviction count)."""
    n = nbrs_p.shape[0] - 1
    win = _choose_winners(data, nbrs_p[:n], prot_p[:n], reach, parent, force)
    n_evict = 0
    for blk in _blocks(torch.nonzero(win)[:, 0]):
        n_evict += _apply_block(data, nbrs_p, prot_p, parent, blk, force)
    return win, n_evict


def repair_connectivity_device(data, nbrs, medoid, knn_ids, *,
                               max_rounds: int = 64,
                               return_protected: bool = False):
    """Batched spanning-tree repair: rounds of (reach -> attach-all).

    Per round every unreachable node proposes an edge beneath its first
    reachable kNN parent that can accept (lacking one, its exact nearest
    acceptable node); each parent accepts its nearest proposer. Repair
    edges are protected from eviction; ``force`` arms only after a round
    places nothing. Reachability is extended from the just-placed nodes
    between rounds and recomputed from the medoid only to confirm an exit
    after an eviction. The repaired table is a copy; ``nbrs`` is left as
    it is.
    """
    data = data.float()
    n, r = nbrs.shape
    dev = nbrs.device
    nbrs_p = torch.cat([nbrs.to(torch.int32),
                        torch.full((1, r), -1, dtype=torch.int32,
                                   device=dev)])
    prot_p = torch.zeros((n + 1, r), dtype=torch.bool, device=dev)
    knn_ids = knn_ids.to(device=dev, dtype=torch.int32)
    norms = (data * data).sum(-1)
    rounds = 0
    force = False
    reach = reachable_mask(nbrs_p[:n], medoid)
    exact = True          # no eviction since `reach` was last recomputed
    while rounds < max_rounds:
        missing = ~reach
        if not bool(missing.any()):
            if exact:
                break
            reach = reachable_mask(nbrs_p[:n], medoid)   # authoritative
            exact = True
            continue
        parent, has, acceptable = _parent_candidates(
            nbrs_p[:n], prot_p[:n], reach, knn_ids, force)
        need = missing & ~has
        need_ids = torch.nonzero(need)[:, 0].to(torch.int32)
        if need_ids.numel():
            fb = torch.full((n,), -1, dtype=torch.int32, device=dev)
            for blk in _blocks(need_ids):
                fb[blk.long()] = _nearest_acceptable(data, norms, acceptable,
                                                     blk)
            parent = torch.where(need, fb, parent)
        placed, n_evict = _repair_round(data, nbrs_p, prot_p, reach, parent,
                                        force)
        rounds += 1
        force = not bool(placed.any())          # stalled: override once
        exact = exact and n_evict == 0
        reach = propagate_reach(nbrs_p[:n], reach | placed)
    if return_protected:
        return nbrs_p[:n], prot_p[:n], rounds
    return nbrs_p[:n], rounds


def reachable_from(nbrs: np.ndarray, medoid: int) -> np.ndarray:
    """(N,) bool: nodes reachable from ``medoid`` (BFS by whole frontiers)."""
    seen = np.zeros(nbrs.shape[0], bool)
    seen[medoid] = True
    frontier = np.array([medoid])
    while frontier.size:
        nxt = nbrs[frontier].ravel()
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen


def ensure_connected_host(nbrs: np.ndarray, data: torch.Tensor, medoid: int,
                          knn_ids: np.ndarray) -> Tuple[np.ndarray, int]:
    """BFS from medoid; attach unreachable nodes beneath their nearest
    reachable kNN parent (or the medoid), NSG's spanning-tree repair — the
    reference's sequential host loop. ``nbrs`` is repaired in place.

    The distances of a parent's row are taken on the host; the fallback
    scan over every reachable node runs where ``data`` lies.
    Returns (repaired neighbors, repair rounds).
    """
    data_np = None
    protected = {}       # parent -> repair-edge slots: never evicted, so
    # repairs are monotone and full rows can't ping-pong across rounds
    rounds = 0
    for _ in range(64):  # fixpoint: attaching can unlock whole islands
        seen = reachable_from(nbrs, medoid)
        missing = np.nonzero(~seen)[0]
        if missing.size == 0:
            break
        if data_np is None:
            data_np = data.float().cpu().numpy()
        rounds += 1
        for u in missing:
            def try_attach(parent):
                row = nbrs[parent]
                free = np.nonzero(row < 0)[0]
                if free.size:
                    slot = int(free[0])
                else:
                    # evict the farthest *evictable* edge; protected repair
                    # edges stay, else repairs undo each other forever
                    dr = ((data_np[row] - data_np[parent]) ** 2).sum(-1)
                    for ss in protected.get(parent, ()):
                        dr[ss] = -1.0
                    slot = int(np.argmax(dr))
                    if dr[slot] < 0:
                        return False        # row is all repair edges
                nbrs[parent, slot] = u
                protected.setdefault(parent, set()).add(slot)
                seen[u] = True  # u reachable; its subtree fixed next round
                return True

            # cheap path first: u's reachable kNNs as parents
            placed = any(try_attach(int(p)) for p in knn_ids[u]
                         if p >= 0 and seen[p])
            if not placed:
                # fallback: nearest reachable nodes by true distance, over
                # the LIVE seen set, so nodes attached earlier this round
                # can chain
                seen_ids = np.nonzero(seen)[0]
                sel = torch.from_numpy(seen_ids).to(data.device)
                du = ((data[sel].float() - data[int(u)].float()) ** 2
                      ).sum(-1).cpu().numpy()
                near = [int(p) for p in seen_ids[np.argsort(du)[:16]]]
                placed = any(try_attach(p) for p in near)
                if not placed:
                    # every candidate row saturated with protected repairs
                    # (pathological): force-evict from the nearest parent
                    parent = near[0]
                    dr = ((data_np[nbrs[parent]] - data_np[parent]) ** 2
                          ).sum(-1)
                    slot = int(np.argmax(dr))
                    nbrs[parent, slot] = u
                    protected.setdefault(parent, set()).add(slot)
                    seen[u] = True
    return nbrs, rounds


def repair(data, nbrs, medoid, knn_ids, *, backend: str = "auto"):
    """Connectivity repair (NSG phase 5) -> (neighbors tensor, rounds)."""
    if resolve_finish_backend(backend) == "host":
        out, rounds = ensure_connected_host(
            nbrs.cpu().numpy().copy(), data, int(medoid),
            knn_ids.cpu().numpy())
        return torch.from_numpy(out).to(nbrs.device), rounds
    return repair_connectivity_device(data, nbrs, medoid, knn_ids)


def finish_nsg(data, nbrs, medoid, knn_ids, *, degree: int,
               alpha: float = 1.0, chunk: int = 2048,
               backend: str = "auto"):
    """Interconnect + repair: pruned (N, R) adjacency -> servable graph.

    Returns (neighbors (N, degree), ``FinishStats``); both stages are timed
    to completion.
    """
    resolved = resolve_finish_backend(backend)
    t0 = time.perf_counter()
    out, width, union_evals = interconnect(
        data, nbrs, degree=degree, alpha=alpha, chunk=chunk,
        backend=resolved)
    synchronize(out.device)
    t1 = time.perf_counter()
    out, rounds = repair(data, out, medoid, knn_ids, backend=resolved)
    synchronize(out.device)
    t2 = time.perf_counter()
    return out, FinishStats(
        backend=resolved, union_width=int(width),
        union_dist_evals=int(union_evals),
        interconnect_seconds=t1 - t0, repair_seconds=t2 - t1,
        repair_rounds=int(rounds))
