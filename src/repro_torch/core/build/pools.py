"""NSG candidate pools derived from the kNN table — no beam searches (the
reference's ``core/build/pools.py``; the EFANNA/DiskANN recipe):

    pool(p) = kNN(p)  ∪  reverse edges into p  ∪  1-hop expansion

  * forward kNN: ids and distances straight from the table — no evals;
  * reverse edges: every edge u->v writes its flat index into slot
    hash(u) % S of v (the last writer of a slot wins) and carries d(u, v)
    along — no evals;
  * 1-hop expansion: each forward neighbor's own ``hop_fanout`` nearest
    neighbors — the only entries whose distance to p is computed, once per
    distinct id that no free entry already covers (a stable sort puts the
    known-distance copy first in each id run).

The expansion's distances are ``gather_dist``'s function (rows of ids,
diff-square form, -1 giving +inf), so on the card they run the kernel; the
pool assembly goes through ``topk_merge``'s pool mode. Distance
evaluations are counted exactly and summed in int64.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.build.scatter import hash_slot, last_writer
from repro_torch.kernels.gather_dist import gather_dist
from repro_torch.kernels.topk_merge import topk_pool

INF = float("inf")
_I32_MAX = 2 ** 31 - 1


def default_hop_fanout(k: int, n_candidates: int) -> int:
    """Second-hop neighbors taken per forward neighbor: enough to roughly
    double the requested pool width."""
    return max(2, min(k, -(-2 * n_candidates // max(k, 1))))


def _reverse_table(knn_ids, knn_dists, rev_slots):
    """(N, S) reverse-edge ids + dists via one scatter of the flat edge
    index (id and distance gathered back through it, so a slot can never
    pair one source's id with another's distance)."""
    n, k = knn_ids.shape
    dev = knn_ids.device
    src = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(k)
    dst = knn_ids.reshape(-1).long()
    d = knn_dists.reshape(-1)
    tgt = torch.where(dst >= 0, dst, n)
    ptr = last_writer(tgt * rev_slots + hash_slot(src, rev_slots),
                      (n + 1) * rev_slots).view(n + 1, rev_slots)[:n]
    safe = ptr.clamp_min(0)
    rev_i = torch.where(ptr >= 0, safe // k, -1).to(torch.int32)
    rev_d = torch.where(ptr >= 0, d[safe], INF)
    return rev_i, rev_d


def _pool_chunk(q, data, rows, fwd_i, fwd_d, rev_i, rev_d, hop_i):
    """Assemble one row chunk's unsorted pools; returns (ids, dists,
    n_evals tensor)."""
    ids = torch.cat([fwd_i, rev_i, hop_i], 1).to(torch.int32)
    known_d = torch.cat([fwd_d, rev_d, torch.full(hop_i.shape, INF,
                                                  device=ids.device)], 1)
    known = torch.cat([torch.ones(fwd_i.shape, dtype=torch.bool),
                       torch.ones(rev_i.shape, dtype=torch.bool),
                       torch.zeros(hop_i.shape, dtype=torch.bool)],
                      1).to(ids.device)
    ids = torch.where(ids == rows[:, None], -1, ids)
    known = known & (ids >= 0)

    # dedup with known-first priority: stable sort by ~known, then by id —
    # within an equal-id run the known-distance copy leads
    def take(order):
        return ids.gather(1, order), known_d.gather(1, order), \
            known.gather(1, order)

    ids, known_d, known = take(
        torch.sort((~known).to(torch.uint8), dim=1, stable=True).indices)
    ids, known_d, known = take(torch.sort(
        torch.where(ids >= 0, ids, _I32_MAX), dim=1, stable=True).indices)
    prev = torch.cat([torch.full_like(ids[:, :1], -2), ids[:, :-1]], 1)
    dup = (ids == prev) | (ids < 0)

    need = ~dup & ~known & (ids >= 0)
    d = gather_dist(q, data, torch.where(need, ids, -1))
    ds = torch.where(known, known_d, torch.where(need, d, INF))
    ds = torch.where(dup, INF, ds)
    ids = torch.where(dup, -1, ids)
    return ids, ds, need.sum(dtype=torch.int64)


def nnd_candidate_pools(
        data: torch.Tensor, knn_ids: torch.Tensor, knn_dists: torch.Tensor,
        n_candidates: int, *, chunk: int = 2048,
        rev_slots: Optional[int] = None, hop_fanout: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Table-derived per-node candidate pools.

    Returns ((N, n_candidates) ids, dists — distance-ascending, -1/inf
    padded) plus the exact distance-evaluation count. ``knn_dists`` are
    the table's own squared distances in ``data``'s space; only the
    deduplicated 1-hop expansion pays new evaluations.
    """
    n, k = knn_ids.shape
    rev_slots = rev_slots if rev_slots is not None else k
    hop_fanout = (hop_fanout if hop_fanout is not None
                  else default_hop_fanout(k, n_candidates))
    hop_fanout = min(hop_fanout, k)
    knn_ids = knn_ids.to(torch.int32)
    knn_dists = torch.where(knn_ids >= 0, knn_dists.float(), INF)

    rev_i, rev_d = _reverse_table(knn_ids, knn_dists, rev_slots)
    safe_fwd = knn_ids.clamp_min(0).long()
    pools_i, pools_d, evals = [], [], []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        fwd = knn_ids[s:e]
        # (b, k, fanout): each forward neighbor's own nearest neighbors; a
        # padded forward slot contributes only -1s
        hop = torch.where(fwd[:, :, None] >= 0,
                          knn_ids[safe_fwd[s:e], :hop_fanout], -1)
        hop = hop.reshape(e - s, k * hop_fanout)
        rows = torch.arange(s, e, dtype=torch.int32, device=data.device)
        ids, ds, n_eval = _pool_chunk(data[s:e], data, rows, fwd,
                                      knn_dists[s:e], rev_i[s:e],
                                      rev_d[s:e], hop)
        ids, ds = topk_pool(ids, ds, n_candidates)
        pools_i.append(ids)
        pools_d.append(ds)
        evals.append(n_eval)
    return (torch.cat(pools_i), torch.cat(pools_d),
            int(torch.stack(evals).sum()))
