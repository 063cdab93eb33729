"""Fixed-width beam (best-first) graph traversal, batch-major (the
reference's ``core/beam_search.py``, ``layout="batched"``).

All Q queries step together. The candidate pool of each query is a
distance-sorted (ef,) triple (ids, dists, visited); one hop expands the
closest unvisited entry of every live query: its R graph neighbors are
scored and merged into the pool. A query whose pool is fully visited (or
whose hop budget is spent) is frozen while its batch-mates continue.

Two hop backends:
  * ``staged``: gather + distance, then the pool merge (``merge_one``) as
    separate ops, one host-driven step per hop — the default on the CPU;
  * ``fused``: gather + distance + merge in one ``kernels/beam_hop`` hop —
    the default on CUDA. On CUDA the whole hop loop runs on the device, as
    the reference's ``lax.while_loop`` does: one ``beam_hops`` launch per
    search (``_run_hop_slices``); on the CPU the host steps the plain hop.
    It equals the staged hop bit for bit when the staged hop runs the
    ``gather_dist`` family (``gather_backend="kernel"``, or the default on
    CUDA).

Under a quantized ``dist_backend`` ("pq" | "int8") the hops score uint8
codes with a per-query LUT: the staged hop through ``kernels/lut_dist``,
the fused hop through ``kernels/beam_hop`` in LUT mode, which share one
left-to-right sum and so agree bit for bit on either device.

Two loop modes: ``while`` runs until no query is live (the host-driven
loop syncs once per hop, the device loop once per search), ``fori`` runs
exactly ``max_iters`` guarded hops. ``beam_search.host_syncs`` counts the
loops' syncs.

Straggler control (``patience``/``eps``): a lane also stops after
``patience`` consecutive hops in which no top-k prefix distance improved
by more than ``eps``. ``patience=None`` keeps the full-pool-convergence
rule bit for bit.

The reference's vmap layout is bit-identical to this layout with the
dot-formula gather, so the port has only this one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.quant import check_dist_backend
from repro_torch.kernels.beam_hop import beam_hop as _kernel_beam_hop
from repro_torch.kernels.beam_hop import beam_hops as _kernel_beam_hops
from repro_torch.kernels.beam_hop import lane_live, merge_one
from repro_torch.kernels.beam_hop import select_frontier as _select_frontier
from repro_torch.kernels.gather_dist import gather_dist as _kernel_gather_dist
from repro_torch.kernels.lut_dist import lut_dist as _kernel_lut_dist

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


def _expand_fused(state, q_or_lut, table, neighbors, dist_backend):
    """One ``kernels/beam_hop`` launch: gather + distance + merge fused."""
    pool_i, pool_d, pool_v, n_hops, n_gath, n_dup = state
    pool_v, node, active = _select_frontier(pool_i, pool_d, pool_v)
    sel = torch.where(active, node, -1).to(torch.int32)
    pool_i, pool_d, pool_v, stats = _kernel_beam_hop(
        sel, neighbors, pool_i, pool_d, pool_v, q_or_lut, table,
        dist_backend)
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




def beam_search(queries: torch.Tensor, db: torch.Tensor,
                neighbors: torch.Tensor, entry_ids: torch.Tensor, *,
                ef: int, k: int, max_iters: int = 0, mode: str = "while",
                gather_backend: Optional[str] = None,
                dist_backend: str = "f32",
                codes: Optional[torch.Tensor] = None,
                lut: Optional[torch.Tensor] = None,
                hop_backend: Optional[str] = None,
                patience: Optional[int] = None,
                eps: float = 0.0,
                with_stats: bool = False):
    """Batched graph search.

    queries: (Q, D); db: (N, D); neighbors: (N, R) int32 (-1 padded);
    entry_ids: (Q,) int32 per-query entry points. Under
    ``dist_backend="pq"|"int8"`` the hops score ``codes`` (N, M) uint8
    with ``lut`` (Q, M, C) f32 instead of the f32 rows (the returned
    distances are then the LUT's approximations). ``patience``/``eps``
    enable adaptive early termination (see the module docstring). Returns
    (dists (Q, k) f32 ascending, ids (Q, k) int32, hops (Q,) int32); with
    ``with_stats=True`` the third element is a full ``BeamStats``.
    """
    if eps < 0.0:
        raise ValueError(f"eps must be >= 0, got {eps}")
    if patience is not None and patience < 1:
        raise ValueError(
            f"patience must be >= 1 (or None to disable), got {patience}")
    if mode not in ("while", "fori"):
        raise ValueError(f"bad mode {mode!r}")
    check_dist_backend(dist_backend)
    max_iters = max_iters or 4 * ef
    gd, body = _batched_hop_setup(queries, db, neighbors,
                                  gather_backend=gather_backend,
                                  hop_backend=hop_backend,
                                  dist_backend=dist_backend, codes=codes,
                                  lut=lut)
    state = _seed_batched(queries, db, neighbors, entry_ids, ef, gd)
    loop_kw = dict(k=k, max_iters=max_iters, mode=mode, patience=patience,
                   eps=eps)
    q_or_lut, table = (queries, db) if dist_backend == "f32" else \
        (lut, codes)
    if resolve_hop_backend(hop_backend, db.device) == "fused" \
            and table.is_cuda:
        state = _run_hop_slices(state, q_or_lut, table, neighbors,
                                dist_backend, max_steps=max_iters, **loop_kw)
    else:
        state = _run_hops(state, body, **loop_kw)
    pool_i, pool_d, _, hops, gath, dup, wasted, _ = state
    if with_stats:
        return (pool_d[:, :k], pool_i[:, :k],
                BeamStats(hops, gath, dup, wasted))
    return pool_d[:, :k], pool_i[:, :k], hops


def _batched_hop_setup(queries, db, neighbors, *, gather_backend,
                       hop_backend, dist_backend="f32", codes=None,
                       lut=None):
    """Resolve the hop backend + distance callable; returns ``(gd, body)``
    where ``gd`` seeds the pool's entry distances and ``body`` is one hop
    over the 6-tuple core state. Under a quantized ``dist_backend`` ``gd``
    is the LUT distance (``queries`` and ``db`` only fill its signature)."""
    hop = resolve_hop_backend(hop_backend, db.device)
    if dist_backend != "f32":
        if codes is None or lut is None:
            raise ValueError(
                f"dist_backend={dist_backend!r} needs codes and lut "
                f"(encode the db with a core.quant codec first)")
        gd = lambda q, db_, ids: _kernel_lut_dist(lut, codes, ids)
    elif hop == "fused":
        # the fused hop's in-kernel arithmetic is gather_dist's: seed the
        # pool from the same family so the entry distances carry the bits
        # the hops will reproduce
        gd = _kernel_gather_dist
    elif resolve_gather_backend(gather_backend, db.device) is None:
        gd = _default_gather_dist
    else:
        gd = _kernel_gather_dist

    if hop == "fused":
        q_or_lut, table = (queries, db) if dist_backend == "f32" else \
            (lut, codes)
        body = lambda s: _expand_fused(s, q_or_lut, table, neighbors,
                                       dist_backend)
    else:
        body = lambda s: _expand_batch(s, queries, db, neighbors, gd)
    return gd, body


def _seed_batched(queries, db, neighbors, entry_ids, ef, gd):
    """Entry-seeded 8-tuple loop state:
    (pool_i, pool_d, pool_v, hops, gathered, dup_gathered, wasted, stale)."""
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
    return (pool_i, pool_d, pool_v, zeros, zeros, zeros, zeros, zeros)


def _lane_live(state, *, max_iters, patience):
    """Per-lane "still working" mask over the 8-tuple state."""
    return lane_live(state[0], state[2], state[3], state[7],
                     max_iters=max_iters, patience=patience)


def _run_hops(state, body, *, k, max_iters, mode, patience, eps):
    """Advance the 8-tuple batched loop state to convergence.

    One hop: run the body on every lane and keep its result only on lanes
    that were live before the hop (the freeze-select). Two straggler
    counters ride along: ``stale`` (consecutive hops without a top-k prefix
    improvement > ``eps``; adaptive mode only, frozen with the rest) and
    ``wasted`` (iterations ridden while not live, updated outside the
    freeze-select, since the frozen lanes are the ones accruing it).
    ``while`` stops when no lane is live; ``fori`` runs ``max_iters``
    guarded hops.
    """
    adaptive = patience is not None

    def live_of(s):
        return _lane_live(s, max_iters=max_iters, patience=patience)

    def hop(s):
        keep = live_of(s)
        new = body(s[:6])
        if adaptive:
            progress = ((s[1][:, :k] - new[1][:, :k]) > eps).any(1)
            stale = torch.where(progress, torch.zeros_like(s[7]), s[7] + 1)
        else:
            stale = s[7]
        merged = tuple(
            torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(new + (stale,), s[:6] + (s[7],)))
        return merged[:6] + (s[6] + (~keep).to(torch.int32), merged[6])

    if mode == "while":
        while True:
            beam_search.host_syncs += 1
            if not bool(live_of(state).any()):
                return state
            state = hop(state)
    for _ in range(max_iters):
        state = hop(state)
    return state


def _run_hop_slices(state, q_or_lut, table, neighbors, dist_backend="f32",
                    *, k, max_iters, mode, patience, eps, max_steps):
    """``_run_hops`` with the loop on the device: slices of up to
    ``max_steps`` guarded hops per lane, each one ``kernels/beam_hop``
    ``beam_hops`` call (one launch on CUDA; the plain loop on the CPU).

    ``while`` runs slices until no lane is live, with one host sync per
    slice (the live test); ``fori`` runs ``max_iters`` hops in slices of
    ``max_steps``, with none. A slice's step count is what the reference's
    loop would have run: the most hops any lane ran in it (``while``), or
    its length (``fori``); a lane's ``wasted`` grows by that count less its
    own hops, the iterations it sat through frozen. ``max_steps =
    max_iters`` takes one slice per search, as the reference's unsliced
    loop runs; the reference's compaction slices are the same unit.
    """
    pool_i, pool_d, pool_v, hops, gath, dup, wasted, stale = state
    if pool_i.shape[0] == 0:
        return state
    left = max_iters
    while mode == "while" or left > 0:
        steps = max_steps if mode == "while" else min(max_steps, left)
        pool_i, pool_d, pool_v, hops, gath, dup, stale, iters, live = \
            _kernel_beam_hops(neighbors, pool_i, pool_d, pool_v, hops, gath,
                              dup, stale, q_or_lut, table, dist_backend, k=k,
                              max_iters=max_iters, max_steps=steps,
                              patience=patience, eps=eps)
        if mode == "fori":
            wasted = wasted + (steps - iters)
            left -= steps
            continue
        wasted = wasted + (iters.max() - iters)
        beam_search.host_syncs += 1
        if not bool(live.any()):
            break
    return (pool_i, pool_d, pool_v, hops, gath, dup, wasted, stale)


beam_search.host_syncs = 0
