"""Plain PyTorch version of the fused beam hop, plus the pool merge it
shares with the staged traversal path (the reference's
``beam_hop/ref.py``).

``merge_one`` is batched over the leading axes: the staged expansion and
``beam_hop_ref`` call the same function, so on the CPU the fused and staged
hops agree by construction; on the card the kernel reproduces it bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_dist.ref import gather_dist_ref

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


def beam_hop_ref(sel, neighbors, pool_i, pool_d, pool_v, queries, db):
    """One hop: neighbor gather -> distances -> pool merge.

    sel (Q,) int32 selected nodes (-1 = lane inactive this hop);
    neighbors (N, R) int32 (-1 padded); pool_* (Q, ef) with the frontier
    slot already marked visited; queries (Q, D) f32; db (N, D) f32.
    Returns (pool_i, pool_d, pool_v, stats) with stats (Q, 2) int32 =
    [neighbor rows gathered, duplicate gathers] per query.
    """
    active = sel >= 0
    nbr = neighbors[sel.clamp_min(0).long()]                 # (Q, R)
    valid = (nbr >= 0) & active[:, None]
    safe = torch.where(valid, nbr, 0)
    nd = gather_dist_ref(queries, db, safe)
    nd = torch.where(valid, nd, INF)
    pool_i, pool_d, pool_v, n_dup = merge_one(
        pool_i, pool_d, pool_v, torch.where(valid, safe, -1), nd)
    stats = torch.stack([valid.sum(1, dtype=torch.int32), n_dup], dim=1)
    return pool_i, pool_d, pool_v, stats
