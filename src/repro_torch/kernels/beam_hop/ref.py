"""Plain PyTorch version of the fused beam hop, in f32 and LUT mode, plus
the pool merge it shares with the staged traversal path (the reference's
``beam_hop/ref.py``), and of the hop loop (``beam_hops_ref``: the
reference's guarded ``_run_hops`` step, repeated).

``merge_one`` is batched over the leading axes: the staged expansion and
``beam_hop_ref`` call the same function, so on the CPU the fused and staged
hops agree by construction; on the card the kernels reproduce it bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_dist.ref import gather_dist_ref
from repro_torch.kernels.lut_dist.ref import lut_dist_ref

INF = float("inf")


def merge_one(pool_i, pool_d, pool_v, cand_i, cand_d):
    """Merge (..., R) candidates into sorted (..., ef) pools; dedup only
    against the pool (not among the candidates).

    Returns the updated (ids, dists, visited) and the number of valid
    candidates that were already pool-resident (the duplicate gathers).
    The merge is a stable sort by distance over [pool, candidates]:
    ties keep pool entries first, then candidate order.
    """
    dup = (cand_i[..., :, None] == pool_i[..., None, :]).any(-1)
    n_dup = (dup & (cand_i >= 0)).sum(-1, dtype=torch.int32)
    bad = dup | (cand_i < 0)
    cand_i = torch.where(bad, -1, cand_i)
    cand_d = torch.where(bad, INF, cand_d)
    ids = torch.cat([pool_i, cand_i], -1)
    ds = torch.cat([pool_d, cand_d], -1)
    vis = torch.cat([pool_v, torch.zeros_like(cand_i, dtype=torch.bool)], -1)
    # + 0.0 maps -0.0 to +0.0, so the two zeros tie (as in jnp.argsort)
    order = torch.sort(ds + 0.0, dim=-1, stable=True).indices
    order = order[..., : pool_i.shape[-1]]
    return (ids.gather(-1, order), ds.gather(-1, order),
            vis.gather(-1, order), n_dup)


def beam_hop_ref(sel, neighbors, pool_i, pool_d, pool_v, q_or_lut, table,
                 dist_backend: str = "f32", norms=None):
    """One hop: neighbor gather -> distances -> pool merge.

    sel (Q,) int32 selected nodes (-1 = lane inactive this hop);
    neighbors (N, R) int32 (-1 padded); pool_* (Q, ef) with the frontier
    slot already marked visited. ``dist_backend="f32"``: q_or_lut is the
    (Q, D) f32 queries and table the (N, D) f32 or bf16 db (``norms``:
    the prenorm distance, as ``gather_dist_ref``); ``"pq"``/``"int8"``:
    q_or_lut is the (Q, M, C) f32 LUT and table the (N, M) uint8 codes.
    Returns (pool_i, pool_d, pool_v, stats) with stats (Q, 2) int32 =
    [neighbor rows gathered, duplicate gathers] per query.
    """
    active = sel >= 0
    nbr = neighbors[sel.clamp_min(0).long()]                 # (Q, R)
    valid = (nbr >= 0) & active[:, None]
    safe = torch.where(valid, nbr, 0)
    if dist_backend == "f32":
        nd = gather_dist_ref(q_or_lut, table, safe, norms)
    else:
        nd = lut_dist_ref(q_or_lut, table, safe)
    nd = torch.where(valid, nd, INF)
    pool_i, pool_d, pool_v, n_dup = merge_one(
        pool_i, pool_d, pool_v, torch.where(valid, safe, -1), nd)
    stats = torch.stack([valid.sum(1, dtype=torch.int32), n_dup], dim=1)
    return pool_i, pool_d, pool_v, stats


def select_frontier(pool_i, pool_d, pool_v):
    """Pick the closest unvisited pool entry and mark it visited.

    The first minimum of ``where(unvisited & valid, d, +inf)``; its slot is
    marked visited even when it is no unvisited valid entry (every such
    entry at +inf). Returns (pool_v, node, active): ``node`` is 0 when the
    lane is inactive — the caller masks.
    """
    unvisited = (~pool_v) & (pool_i >= 0)
    masked = torch.where(unvisited, pool_d, INF)
    slot = torch.argmin(masked, dim=-1, keepdim=True)     # first minimum
    active = unvisited.gather(-1, slot)[..., 0]
    pool_v = pool_v | (torch.arange(pool_v.shape[-1],
                                    device=pool_v.device) == slot)
    node = torch.where(active, pool_i.gather(-1, slot)[..., 0], 0)
    return pool_v, node, active


def lane_live(pool_i, pool_v, hops, stale, *, max_iters, patience):
    """Per-lane "still working" mask: an unvisited valid entry exists, the
    hop budget is not spent and (``patience`` set) the lane is not stale."""
    live = ((~pool_v) & (pool_i >= 0)).any(-1) & (hops < max_iters)
    if patience is not None:
        live = live & (stale < patience)
    return live


def beam_hops_ref(neighbors, pool_i, pool_d, pool_v, hops, gathered, dup,
                  stale, q_or_lut, table, *, k: int, max_iters: int,
                  max_steps: int, patience=None, eps: float = 0.0,
                  norms=None):
    """Up to ``max_steps`` guarded hops per lane: the reference's
    ``_run_hops`` step, each lane until it stops being live.

    A step, on each live lane (``lane_live``): ``select_frontier``, then
    ``beam_hop_ref`` with ``sel = node`` where the slot was active, else -1;
    hops += active, gathered and dup_gathered += the hop's stats and, with
    ``patience``, stale = 0 when any of the first k distances fell by more
    than ``eps`` (f32), else stale + 1. A lane that is not live keeps its
    state, and never becomes live again. ``q_or_lut``/``table`` are the f32
    queries and the f32 or bf16 base (``norms``: the prenorm distance), or a
    (Q, M, C) LUT and uint8 codes.

    Returns (pool_i, pool_d, pool_v, hops, gathered, dup_gathered, stale,
    iters, live): ``iters`` (Q,) int32 the hops each lane ran here, ``live``
    the live test after them.
    """
    dist_backend = "pq" if q_or_lut.dim() == 3 else "f32"
    iters = torch.zeros_like(hops)
    state = (pool_i, pool_d, pool_v, hops, gathered, dup, stale)
    live_of = lambda s: lane_live(s[0], s[2], s[3], s[6],
                                  max_iters=max_iters, patience=patience)
    for _ in range(max_steps):
        keep = live_of(state)
        if not bool(keep.any()):
            break
        p_i, p_d, p_v, h, g, dp, st = state
        p_v, node, active = select_frontier(p_i, p_d, p_v)
        sel = torch.where(active, node, -1).to(torch.int32)
        n_i, n_d, n_v, stats = beam_hop_ref(sel, neighbors, p_i, p_d, p_v,
                                            q_or_lut, table, dist_backend,
                                            norms)
        if patience is not None:
            progress = ((p_d[:, :k] - n_d[:, :k]) > eps).any(1)
            st = torch.where(progress, torch.zeros_like(st), st + 1)
        new = (n_i, n_d, n_v, h + active.to(torch.int32), g + stats[:, 0],
               dp + stats[:, 1], st)
        state = tuple(
            torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(new, state))
        iters = iters + keep.to(torch.int32)
    return state + (iters, live_of(state))
