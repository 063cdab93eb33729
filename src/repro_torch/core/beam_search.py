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
rule bit for bit. ``beam_search_compacted`` runs the fused loop in slices
of ``compact_every`` hops and between slices gathers the live lanes into a
smaller power-of-two batch, with the same results.

The sharded tier's two modes (the reference's ``ANN_BF16_BASE`` and
``ANN_PRENORM``) reach the hops through ``db`` and ``norms``: a bf16 ``db``
is read as bf16 rows, widened exactly, and ``norms`` (N,) f32 (|x|^2 kept
at build time) selects the distance ``max(|q|^2 + norms[id] - 2 q.x, 0)``.
Both run in the f32 hop loop kernel and in ``gather_dist`` on the card; on
the CPU the staged hop scores a bf16 ``db`` by the dot formula over the
widened rows, as the reference does, and the prenorm distance through
``gather_dist``'s plain version.

The reference's vmap layout is bit-identical to this layout with the
dot-formula gather, so the port has only this one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quant import check_dist_backend
from repro_torch.kernels.beam_hop import beam_hop as _kernel_beam_hop
from repro_torch.kernels.beam_hop import beam_hops as _kernel_beam_hops
from repro_torch.kernels.beam_hop import lane_live, merge_one
from repro_torch.kernels.beam_hop import select_frontier as _select_frontier
from repro_torch.kernels.gather_dist import gather_dist as _kernel_gather_dist
from repro_torch.kernels.lut_dist import lut_dist as _kernel_lut_dist
from repro_torch.serve.batching import bucket_for, pow2_buckets

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


def _expand_fused(state, q_or_lut, table, neighbors, dist_backend,
                  norms=None):
    """One ``kernels/beam_hop`` launch: gather + distance + merge fused."""
    pool_i, pool_d, pool_v, n_hops, n_gath, n_dup = state
    pool_v, node, active = _select_frontier(pool_i, pool_d, pool_v)
    sel = torch.where(active, node, -1).to(torch.int32)
    pool_i, pool_d, pool_v, stats = _kernel_beam_hop(
        sel, neighbors, pool_i, pool_d, pool_v, q_or_lut, table,
        dist_backend, norms=norms)
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
    if backend is None and torch.device(device).type in ("cuda", "meta"):
        return "kernel"
    return backend


def resolve_hop_backend(backend: Optional[str],
                        device: torch.device) -> str:
    """None/"auto" -> the fused kernel on CUDA (and on meta, where the
    dry run prices the card's path), the staged path on the CPU (as the
    reference picks fused on TPU, staged elsewhere)."""
    if backend in (None, "auto"):
        return "fused" if torch.device(device).type in ("cuda", "meta") \
            else "staged"
    if backend not in ("staged", "fused"):
        raise ValueError(f"unknown hop backend {backend!r} "
                         f"(expected 'staged' | 'fused' | 'auto')")
    return backend




def beam_search(queries: torch.Tensor, db: torch.Tensor,
                neighbors: torch.Tensor, entry_ids: torch.Tensor, *,
                ef: int, k: int, max_iters: int = 0, mode: str = "while",
                layout: str = "batched",
                gather_backend: Optional[str] = None,
                dist_backend: str = "f32",
                codes: Optional[torch.Tensor] = None,
                lut: Optional[torch.Tensor] = None,
                hop_backend: Optional[str] = None,
                patience: Optional[int] = None,
                eps: float = 0.0,
                with_stats: bool = False,
                norms: Optional[torch.Tensor] = None):
    """Batched graph search.

    ``layout`` ("vmap" | "batched") is accepted as the reference's callers
    pass it; both run this batched layout, which is bit-identical to the
    reference's vmap layout (see the module docstring).

    queries: (Q, D); db: (N, D); neighbors: (N, R) int32 (-1 padded);
    entry_ids: (Q,) int32 per-query entry points. Under
    ``dist_backend="pq"|"int8"`` the hops score ``codes`` (N, M) uint8
    with ``lut`` (Q, M, C) f32 instead of the f32 rows (the returned
    distances are then the LUT's approximations). ``db`` may hold bf16
    rows, and ``norms`` (N,) f32 selects the prenorm distance (the module
    docstring). ``patience``/``eps``
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
    if layout not in ("vmap", "batched"):
        raise ValueError(f"bad layout {layout!r}")
    check_dist_backend(dist_backend)
    max_iters = max_iters or 4 * ef
    gd, body = _batched_hop_setup(queries, db, neighbors,
                                  gather_backend=gather_backend,
                                  hop_backend=hop_backend,
                                  dist_backend=dist_backend, codes=codes,
                                  lut=lut, norms=norms)
    state = _seed_batched(queries, db, neighbors, entry_ids, ef, gd)
    loop_kw = dict(k=k, max_iters=max_iters, mode=mode, patience=patience,
                   eps=eps)
    q_or_lut, table = (queries, db) if dist_backend == "f32" else \
        (lut, codes)
    if resolve_hop_backend(hop_backend, db.device) == "fused" \
            and (table.is_cuda or table.is_meta):
        state = _run_hop_slices(state, q_or_lut, table, neighbors,
                                dist_backend, max_steps=max_iters,
                                norms=norms, **loop_kw)
    else:
        state = _run_hops(state, body, **loop_kw)
    pool_i, pool_d, _, hops, gath, dup, wasted, _ = state
    if with_stats:
        return (pool_d[:, :k], pool_i[:, :k],
                BeamStats(hops, gath, dup, wasted))
    return pool_d[:, :k], pool_i[:, :k], hops


def _batched_hop_setup(queries, db, neighbors, *, gather_backend,
                       hop_backend, dist_backend="f32", codes=None,
                       lut=None, norms=None):
    """Resolve the hop backend + distance callable; returns ``(gd, body)``
    where ``gd`` seeds the pool's entry distances and ``body`` is one hop
    over the 6-tuple core state. Under a quantized ``dist_backend`` ``gd``
    is the LUT distance (``queries`` and ``db`` only fill its signature);
    with ``norms`` it is ``gather_dist``'s prenorm distance."""
    hop = resolve_hop_backend(hop_backend, db.device)
    if dist_backend != "f32":
        if codes is None or lut is None:
            raise ValueError(
                f"dist_backend={dist_backend!r} needs codes and lut "
                f"(encode the db with a core.quant codec first)")
        if norms is not None:
            raise ValueError(f"norms (the prenorm distance) need "
                             f"dist_backend='f32', got {dist_backend!r}")
        gd = lambda q, db_, ids: _kernel_lut_dist(lut, codes, ids)
    elif hop == "fused" or norms is not None:
        # the fused hop's in-kernel arithmetic is gather_dist's, in the
        # same mode: seed the pool from the same family so the entry
        # distances carry the bits the hops will reproduce
        gd = lambda q, db_, ids: _kernel_gather_dist(q, db_, ids,
                                                     norms=norms)
    elif resolve_gather_backend(gather_backend, db.device) is None:
        gd = _default_gather_dist
    else:
        gd = _kernel_gather_dist

    if hop == "fused":
        q_or_lut, table = (queries, db) if dist_backend == "f32" else \
            (lut, codes)
        body = lambda s: _expand_fused(s, q_or_lut, table, neighbors,
                                       dist_backend, norms)
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


def _hop_slice(state, q_or_lut, table, neighbors, dist_backend="f32", *,
               k, max_iters, patience, eps, max_steps, mode="while",
               norms=None):
    """Advance the 8-tuple state by one slice: up to ``max_steps`` guarded
    hops per lane in one ``kernels/beam_hop`` ``beam_hops`` call (one
    launch on CUDA; the plain loop on the CPU). Returns ``(state, live)``,
    ``live`` the per-lane continuation mask after the slice (on the
    device: the caller decides whether to read it).

    The slice's step count is what the reference's loop would have run: the
    most hops any lane ran in it (``while``), or ``max_steps`` (``fori``);
    a lane's ``wasted`` grows by that count less its own hops, the
    iterations it sat through frozen.
    """
    pool_i, pool_d, pool_v, hops, gath, dup, wasted, stale = state
    pool_i, pool_d, pool_v, hops, gath, dup, stale, iters, live = \
        _kernel_beam_hops(neighbors, pool_i, pool_d, pool_v, hops, gath,
                          dup, stale, q_or_lut, table, dist_backend, k=k,
                          max_iters=max_iters, max_steps=max_steps,
                          patience=patience, eps=eps, norms=norms)
    ran = iters.max() if mode == "while" else max_steps
    return (pool_i, pool_d, pool_v, hops, gath, dup, wasted + (ran - iters),
            stale), live


def _run_hop_slices(state, q_or_lut, table, neighbors, dist_backend="f32",
                    *, k, max_iters, mode, patience, eps, max_steps,
                    norms=None):
    """``_run_hops`` with the loop on the device: ``_hop_slice`` after
    ``_hop_slice`` of up to ``max_steps`` hops each.

    ``while`` runs slices until no lane is live, with one host sync per
    slice (the live test); ``fori`` runs ``max_iters`` hops in slices of
    ``max_steps``, with none. ``max_steps = max_iters`` takes one slice per
    search, as the reference's unsliced loop runs; the compaction slices of
    ``beam_search_compacted`` are the same unit.
    """
    if state[0].shape[0] == 0:
        return state
    left = max_iters
    while mode == "while" or left > 0:
        steps = max_steps if mode == "while" else min(max_steps, left)
        state, live = _hop_slice(state, q_or_lut, table, neighbors,
                                 dist_backend, k=k, max_iters=max_iters,
                                 patience=patience, eps=eps,
                                 max_steps=steps, mode=mode, norms=norms)
        if mode == "fori":
            left -= steps
            continue
        beam_search.host_syncs += 1
        if not bool(live.any()):
            break
    return state


def _compact_seed(queries, db, neighbors, entry_ids, *, ef,
                  dist_backend="f32", codes=None, lut=None, norms=None):
    """Pool seeding for the compacted search: the fused hop's entry
    distances (``gather_dist`` in the hop's mode, or ``lut_dist`` under a
    quantized backend), so the seed carries the bits its hops
    reproduce."""
    gd, _ = _batched_hop_setup(queries, db, neighbors, gather_backend=None,
                               hop_backend="fused",
                               dist_backend=dist_backend, codes=codes,
                               lut=lut, norms=norms)
    return _seed_batched(queries, db, neighbors, entry_ids, ef, gd)


def _mask_lanes_dead(state, start):
    """Make lanes ``start:`` inert: an empty pool is never live, and its
    results are +inf / -1. Writes in place: the caller owns every state
    tensor (fresh from the seed, a slice or a gather)."""
    state[0][start:] = -1
    state[1][start:] = INF
    return state


def beam_search_compacted(queries: torch.Tensor, db: torch.Tensor,
                          neighbors: torch.Tensor, entry_ids: torch.Tensor,
                          *, ef: int, k: int, compact_every: int,
                          max_iters: int = 0, mode: str = "while",
                          dist_backend: str = "f32",
                          codes: Optional[torch.Tensor] = None,
                          lut: Optional[torch.Tensor] = None,
                          patience: Optional[int] = None,
                          eps: float = 0.0,
                          with_stats: bool = False,
                          buckets: Optional[Sequence[int]] = None,
                          shape_log: Optional[list] = None,
                          norms: Optional[torch.Tensor] = None):
    """``beam_search`` with active-query compaction.

    A host loop over ``_hop_slice``: each slice runs up to
    ``compact_every`` hops per lane in one fused loop call (one
    ``beam_hops`` launch on CUDA, the plain loop on the CPU), then the host
    reads the live mask (its one sync per slice, counted in
    ``beam_search.host_syncs``). Finished lanes' results are copied to
    their original slots on the device (``index_copy_``); the survivors are
    gathered on the device (one ``index_select`` per state tensor) into the
    smallest power-of-two bucket that holds them
    (``serve/batching.pow2_buckets``, or the sizes ``buckets`` gives: a
    serving layer's own pre-warmed set, which must hold one size >= Q), the
    bucket's spare lanes filled with the first survivor and made inert.
    Batch cost then tracks the distribution of per-query hop counts
    instead of the max.

    Lanes never interact, so ids, dists, hops, gathered and dup_gathered
    equal the uncompacted fused search's bit for bit; ``wasted_hops`` is
    what shrinks: a lane stops riding at its first slice boundary after its
    termination. The hop is always the fused one (the staged hop equals it
    bit for bit on the card); ``db`` and ``norms`` take the modes of
    ``beam_search``. ``shape_log``, when given, gets each slice's batch
    size appended.

    Only while mode exists here (fori's fixed trip count is the straggler
    cost compaction removes), and the stats are flushed per lane, so
    ``with_stats`` shapes match ``beam_search``'s.
    """
    if mode != "while":
        raise ValueError(
            f"compaction requires mode='while' (mode={mode!r}): a fixed "
            f"fori trip count is exactly the straggler cost it removes")
    if compact_every < 1:
        raise ValueError(f"compact_every must be >= 1, got {compact_every}")
    if eps < 0.0:
        raise ValueError(f"eps must be >= 0, got {eps}")
    if patience is not None and patience < 1:
        raise ValueError(
            f"patience must be >= 1 (or None to disable), got {patience}")
    check_dist_backend(dist_backend)
    nq = queries.shape[0]
    dev = db.device
    max_iters = max_iters or 4 * ef
    buckets = tuple(sorted(pow2_buckets(nq) if buckets is None
                           else set(int(b) for b in buckets)))
    quantized = dist_backend != "f32"
    if quantized and (codes is None or lut is None):
        raise ValueError(
            f"dist_backend={dist_backend!r} needs codes and lut "
            f"(encode the db with a core.quant codec first)")

    b0 = bucket_for(nq, buckets)
    fill = torch.zeros((b0,), dtype=torch.int64)
    fill[:nq] = torch.arange(nq)
    fill = fill.to(dev)

    def pad(a):
        """Rows of ``a`` up to the first bucket, the first row repeated."""
        return a if b0 == nq else a.index_select(0, fill)

    q_cur = pad(queries.to(dev))
    lut_cur = pad(lut) if quantized else None
    state = _compact_seed(q_cur, db, neighbors,
                          pad(entry_ids.to(device=dev, dtype=torch.int32)),
                          ef=ef, dist_backend=dist_backend, codes=codes,
                          lut=lut_cur, norms=norms)
    state = _mask_lanes_dead(state, nq)
    # q_or_lut carries the lanes: the queries (f32) or their LUTs
    q_or_lut, table = (q_cur, db) if not quantized else (lut_cur, codes)
    orig = np.arange(b0, dtype=np.int64)
    orig[nq:] = -1

    out_d = torch.full((nq, k), INF, dtype=torch.float32, device=dev)
    out_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    out_stats = torch.zeros((4, nq), dtype=torch.int32, device=dev)

    def flush(rows):
        src = torch.from_numpy(rows).to(dev)
        dst = torch.from_numpy(orig[rows]).to(dev)
        out_d.index_copy_(0, dst, state[1].index_select(0, src)[:, :k])
        out_i.index_copy_(0, dst, state[0].index_select(0, src)[:, :k])
        out_stats.index_copy_(1, dst, torch.stack(state[3:7])
                              .index_select(1, src))
        orig[rows] = -1

    # hops strictly increase on every live lane, so the slice loop is
    # bounded; the +1 covers the all-dead exit slice
    for _ in range(-(-max_iters // compact_every) + 1):
        state, live = _hop_slice(state, q_or_lut, table, neighbors,
                                 dist_backend, k=k, max_iters=max_iters,
                                 patience=patience, eps=eps,
                                 max_steps=compact_every, norms=norms)
        if shape_log is not None:
            shape_log.append(int(q_or_lut.shape[0]))
        live_np = live.cpu().numpy()
        beam_search.host_syncs += 1
        done = np.nonzero(~live_np & (orig >= 0))[0]
        if done.size:
            flush(done)
        survivors = np.nonzero(live_np)[0]
        if survivors.size == 0:
            break
        nb = bucket_for(survivors.size, buckets)
        if nb < q_or_lut.shape[0]:
            idx = np.full(nb, survivors[0], np.int64)
            idx[:survivors.size] = survivors
            take = torch.from_numpy(idx).to(dev)
            state = _mask_lanes_dead(
                tuple(a.index_select(0, take) for a in state),
                survivors.size)
            q_or_lut = q_or_lut.index_select(0, take)
            orig = np.concatenate(
                [orig[survivors], np.full(nb - survivors.size, -1,
                                          np.int64)])

    if with_stats:
        return out_d, out_i, BeamStats(*out_stats.unbind(0))
    return out_d, out_i, out_stats[0]


beam_search.host_syncs = 0
