"""NSG finishing pass: reverse interconnect + connectivity repair (the
host path of the reference's ``core/build/finish.py``).

The host path is the reference's parity baseline: a graph built here is
held to the reference's exactly. Two of its steps are vectorized without
changing their result:

  * the reverse lists keep "the first ``rev_cap`` sources in ascending
    source order" through a stable sort of the edges by target;
  * the BFS from the medoid expands whole numpy frontiers; it reaches the
    same set in any visiting order.

The attach loop after the BFS stays sequential, as in the reference. The
device finishing pass (what ``"auto"`` resolves to) is not ported yet
(ROADMAP Queue 1 item 5, the device-finish slice) and raises.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.build.prune import (
    mark_dups, prune_in_chunks, rows_sqdist_in_chunks,
)
from repro_torch.core.device import synchronize

FINISH_BACKENDS = ("host", "device", "auto")


class FinishStats(NamedTuple):
    """Work + wall-clock accounting for one finishing pass."""
    backend: str               # "host" (the only ported backend)
    union_width: int           # forward + reverse union width actually built
    union_dist_evals: int      # distance evals the union pass issued
    interconnect_seconds: float
    repair_seconds: float
    repair_rounds: int         # attach rounds until medoid-reachable


def require_host(backend: str) -> None:
    """Validate a finish backend name; raise unless it is the ported host
    path ("auto" resolves to the device pass, as in the reference)."""
    if backend not in FINISH_BACKENDS:
        raise ValueError(
            f"unknown finish backend {backend!r}; expected one of "
            f"{FINISH_BACKENDS}")
    if backend != "host":
        raise NotImplementedError(
            f"finish backend {backend!r} resolves to the device finishing "
            f"pass, which is not ported yet (ROADMAP Queue 1 item 5, the "
            f"device-finish slice); pass finish_backend='host'")


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
                 chunk: int = 2048):
    """Reverse-edge interconnect + re-prune (NSG phase 4), with reverse
    lists capped at 2 * degree (the reference's default cap).

    Returns (pruned (N, degree) neighbors, union width, union distance
    evals).
    """
    return _interconnect_host(data, nbrs, degree, alpha, chunk, 2 * degree)


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


def repair(data, nbrs, medoid, knn_ids):
    """Connectivity repair (NSG phase 5) -> (neighbors tensor, rounds)."""
    out, rounds = ensure_connected_host(
        nbrs.cpu().numpy().copy(), data, int(medoid),
        knn_ids.cpu().numpy())
    return torch.from_numpy(out).to(nbrs.device), rounds


def finish_nsg(data, nbrs, medoid, knn_ids, *, degree: int,
               alpha: float = 1.0, chunk: int = 2048,
               backend: str = "host"):
    """Interconnect + repair: pruned (N, R) adjacency -> servable graph.

    Returns (neighbors (N, degree), ``FinishStats``); both stages are timed
    to completion.
    """
    require_host(backend)
    t0 = time.perf_counter()
    out, width, union_evals = interconnect(data, nbrs, degree=degree,
                                           alpha=alpha, chunk=chunk)
    synchronize(out.device)
    t1 = time.perf_counter()
    out, rounds = repair(data, out, medoid, knn_ids)
    synchronize(out.device)
    t2 = time.perf_counter()
    return out, FinishStats(
        backend="host", union_width=int(width),
        union_dist_evals=int(union_evals),
        interconnect_seconds=t1 - t0, repair_seconds=t2 - t1,
        repair_rounds=int(rounds))
