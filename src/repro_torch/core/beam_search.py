"""Fixed-width beam (best-first) graph traversal, batch-major (the
reference's ``core/beam_search.py``, ``layout="batched"``).

All Q queries step together. The candidate pool of each query is a
distance-sorted (ef,) triple (ids, dists, visited); one hop expands the
closest unvisited entry of every live query: its R graph neighbors are
scored and merged into the pool. A query whose pool is fully visited (or
whose hop budget is spent) is frozen while its batch-mates continue.

Two hop backends:
  * ``staged``: gather + distance, then the pool merge (``merge_one``) as
    separate ops — the default on the CPU;
  * ``fused``: one ``kernels/beam_hop`` launch per hop — the default on
    CUDA. It equals the staged hop bit for bit when the staged hop runs
    the ``gather_dist`` family (``gather_backend="kernel"``, or the
    default on CUDA).

Two loop modes: ``while`` runs until no query is live (one host sync per
hop), ``fori`` runs exactly ``max_iters`` guarded hops.

The reference's vmap layout is bit-identical to this layout with the
dot-formula gather, so the port has only this one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.beam_hop import beam_hop as _kernel_beam_hop
from repro_torch.kernels.beam_hop import merge_one
from repro_torch.kernels.gather_dist import gather_dist as _kernel_gather_dist

INF = float("inf")


class BeamStats(NamedTuple):
    """Per-query work accounting of one beam_search call.

    ``hops``: expansions taken; ``gathered``: neighbor rows whose distance
    was evaluated; ``dup_gathered``: of those, rows already pool-resident;
    ``wasted_hops``: loop iterations a lane sat through after its own
    termination because batch-mates were still working.
    """
    hops: torch.Tensor
    gathered: torch.Tensor
    dup_gathered: torch.Tensor
    wasted_hops: torch.Tensor


def _sqdist_rows(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, D), (Q, R, D) -> (Q, R) squared L2 by the dot formula."""
    q = queries.float()
    r = rows.float()
    dot = torch.bmm(r, q[:, :, None])[:, :, 0]
    return ((q * q).sum(-1, keepdim=True) + (r * r).sum(-1)
            - 2.0 * dot).clamp_min(0.0)


def _default_gather_dist(queries, db, ids):
    return _sqdist_rows(queries, db[ids.long()])


def _select_frontier(pool_i, pool_d, pool_v):
    """Pick the closest unvisited pool entry and mark it visited.

    Returns (pool_v, node, active): ``node`` is 0 when the lane has
    converged (``active`` False) — the caller masks.
    """
    unvisited = (~pool_v) & (pool_i >= 0)
    masked = torch.where(unvisited, pool_d, INF)
    slot = torch.argmin(masked, dim=-1, keepdim=True)     # first minimum
    active = unvisited.gather(-1, slot)[..., 0]
    pool_v = pool_v | (torch.arange(pool_v.shape[-1],
                                    device=pool_v.device) == slot)
    node = torch.where(active, pool_i.gather(-1, slot)[..., 0], 0)
    return pool_v, node, active


def _expand_batch(state, queries, db, neighbors, gather_dist_b):
    """One staged hop: a (Q, R) gather + distance block, then the merge."""
    pool_i, pool_d, pool_v, n_hops, n_gath, n_dup = state
    pool_v, node, active = _select_frontier(pool_i, pool_d, pool_v)
    nbr = neighbors[node.long()]                          # (Q, R)
    valid = (nbr >= 0) & active[:, None]
    safe = torch.where(valid, nbr, 0)
    nd = gather_dist_b(queries, db, safe)
    nd = torch.where(valid, nd, INF)
    pool_i, pool_d, pool_v, dup = merge_one(
        pool_i, pool_d, pool_v, torch.where(valid, safe, -1), nd)
    return (pool_i, pool_d, pool_v, n_hops + active.to(torch.int32),
            n_gath + valid.sum(1, dtype=torch.int32), n_dup + dup)


def _expand_fused(state, queries, db, neighbors):
    """One ``kernels/beam_hop`` launch: gather + distance + merge fused."""
    pool_i, pool_d, pool_v, n_hops, n_gath, n_dup = state
    pool_v, node, active = _select_frontier(pool_i, pool_d, pool_v)
    sel = torch.where(active, node, -1).to(torch.int32)
    pool_i, pool_d, pool_v, stats = _kernel_beam_hop(
        sel, neighbors, pool_i, pool_d, pool_v, queries, db)
    return (pool_i, pool_d, pool_v, n_hops + active.to(torch.int32),
            n_gath + stats[:, 0], n_dup + stats[:, 1])


def resolve_gather_backend(backend: Optional[str],
                           device: torch.device) -> Optional[str]:
    """None -> ``"kernel"`` (the gather_dist kernel) on CUDA, and on the
    CPU ``None``: the dot-formula gather, the arithmetic of the
    reference's default. ``"kernel"`` -> ``kernels/gather_dist`` on any
    device (its plain diff-square version on the CPU)."""
    if backend not in (None, "kernel"):
        raise ValueError(f"unknown gather backend {backend!r} "
                         f"(expected None | 'kernel')")
    if backend is None and torch.device(device).type == "cuda":
        return "kernel"
    return backend


def resolve_hop_backend(backend: Optional[str],
                        device: torch.device) -> str:
    """None/"auto" -> the fused kernel on CUDA, the staged path on the CPU
    (as the reference picks fused on TPU, staged elsewhere)."""
    if backend in (None, "auto"):
        return "fused" if torch.device(device).type == "cuda" else "staged"
    if backend not in ("staged", "fused"):
        raise ValueError(f"unknown hop backend {backend!r} "
                         f"(expected 'staged' | 'fused' | 'auto')")
    return backend


def _not_ported(what: str):
    return NotImplementedError(
        f"beam_search {what} is not ported yet (ROADMAP Queue 1 item 3 "
        f"for quantized traversal, item 4 for straggler control)")


def beam_search(queries: torch.Tensor, db: torch.Tensor,
                neighbors: torch.Tensor, entry_ids: torch.Tensor, *,
                ef: int, k: int, max_iters: int = 0, mode: str = "while",
                gather_backend: Optional[str] = None,
                dist_backend: str = "f32",
                hop_backend: Optional[str] = None,
                patience: Optional[int] = None,
                with_stats: bool = False):
    """Batched graph search.

    queries: (Q, D); db: (N, D); neighbors: (N, R) int32 (-1 padded);
    entry_ids: (Q,) int32 per-query entry points. Returns (dists (Q, k) f32
    ascending, ids (Q, k) int32, hops (Q,) int32); with ``with_stats=True``
    the third element is a full ``BeamStats``.
    """
    if dist_backend != "f32":
        raise _not_ported(f"dist_backend={dist_backend!r}")
    if patience is not None:
        raise _not_ported("patience")
    if mode not in ("while", "fori"):
        raise ValueError(f"bad mode {mode!r}")
    max_iters = max_iters or 4 * ef
    gd, body = _batched_hop_setup(queries, db, neighbors,
                                  gather_backend=gather_backend,
                                  hop_backend=hop_backend)
    state = _seed_batched(queries, db, neighbors, entry_ids, ef, gd)
    state = _run_hops(state, body, max_iters=max_iters, mode=mode)
    pool_i, pool_d, _, hops, gath, dup, wasted = state
    if with_stats:
        return (pool_d[:, :k], pool_i[:, :k],
                BeamStats(hops, gath, dup, wasted))
    return pool_d[:, :k], pool_i[:, :k], hops


def _batched_hop_setup(queries, db, neighbors, *, gather_backend,
                       hop_backend):
    """Resolve the hop backend + distance callable; returns ``(gd, body)``
    where ``gd`` seeds the pool's entry distances and ``body`` is one hop
    over the 6-tuple core state."""
    hop = resolve_hop_backend(hop_backend, db.device)
    if hop == "fused":
        # the fused hop's in-kernel arithmetic is gather_dist's: seed the
        # pool from the same family so the entry distances carry the bits
        # the hops will reproduce
        gd = _kernel_gather_dist
    elif resolve_gather_backend(gather_backend, db.device) is None:
        gd = _default_gather_dist
    else:
        gd = _kernel_gather_dist

    if hop == "fused":
        body = lambda s: _expand_fused(s, queries, db, neighbors)
    else:
        body = lambda s: _expand_batch(s, queries, db, neighbors, gd)
    return gd, body


def _seed_batched(queries, db, neighbors, entry_ids, ef, gd):
    """Entry-seeded 7-tuple loop state:
    (pool_i, pool_d, pool_v, hops, gathered, dup_gathered, wasted)."""
    nq = queries.shape[0]
    dev = db.device
    entry_ids = entry_ids.to(device=dev, dtype=torch.int32)
    d0 = gd(queries, db, entry_ids[:, None])[:, 0]
    pool_i = torch.full((nq, ef), -1, dtype=torch.int32, device=dev)
    pool_i[:, 0] = entry_ids
    pool_d = torch.full((nq, ef), INF, dtype=torch.float32, device=dev)
    pool_d[:, 0] = d0
    pool_v = torch.zeros((nq, ef), dtype=torch.bool, device=dev)
    zeros = torch.zeros((nq,), dtype=torch.int32, device=dev)
    return (pool_i, pool_d, pool_v, zeros, zeros, zeros, zeros)


def _lane_live(state, *, max_iters):
    """Per-lane "still working" mask over the loop state."""
    pool_i, pool_v, hops = state[0], state[2], state[3]
    return ((~pool_v) & (pool_i >= 0)).any(1) & (hops < max_iters)


def _run_hops(state, body, *, max_iters, mode):
    """Advance the batched loop state to convergence.

    One hop: run the body on every lane, keep its result only on lanes
    that were live before the hop (the freeze-select), and count a wasted
    hop on the others. ``while`` stops when no lane is live; ``fori`` runs
    ``max_iters`` guarded hops.
    """
    def hop(s):
        keep = _lane_live(s, max_iters=max_iters)
        new = body(s[:6])
        merged = tuple(
            torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(new, s[:6]))
        return merged + (s[6] + (~keep).to(torch.int32),)

    if mode == "while":
        while bool(_lane_live(state, max_iters=max_iters).any()):
            state = hop(state)
        return state
    for _ in range(max_iters):
        state = hop(state)
    return state
