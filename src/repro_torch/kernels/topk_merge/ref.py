"""Plain PyTorch versions of the dedup + distance-top-k primitive (the
reference's ``topk_merge/ref.py``, stable sorts included)."""
from __future__ import annotations

import torch

INF = float("inf")


def _stable_order(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1, stable=True).indices


def mark_dups(ids: torch.Tensor) -> torch.Tensor:
    """True at positions holding a value already seen to the left, and at
    ids < 0 (the reference's ``build.prune.mark_dups``, kept here so the
    kernel's plain version stands alone)."""
    eq = ids[:, :, None] == ids[:, None, :]                   # (B, L, L)
    tri = torch.ones(eq.shape[-2:], dtype=torch.bool,
                     device=ids.device).tril(-1)
    return (eq & tri[None]).any(-1) | (ids < 0)


def topk_merge_ref(cur_i, cur_d, cur_f, cand_i, cand_d, k):
    """Merge (B, K) current rows with (B, M) candidates -> new top-k rows.

    Dedup keeps the *existing* copy of an id (fresh=False) so re-proposed
    neighbors are not resampled as new next round.
    """
    ids = torch.cat([cur_i, cand_i], 1)
    ds = torch.cat([cur_d, cand_d], 1)
    fresh = torch.cat([cur_f, torch.ones_like(cand_i, dtype=torch.bool)], 1)
    # lexsort by (id, fresh): stable sort on the secondary key first
    ord0 = _stable_order(fresh.to(torch.uint8))
    ids, ds, fresh = ids.gather(1, ord0), ds.gather(1, ord0), \
        fresh.gather(1, ord0)
    ord1 = _stable_order(ids)
    ids, ds, fresh = ids.gather(1, ord1), ds.gather(1, ord1), \
        fresh.gather(1, ord1)
    dup = torch.cat([torch.zeros_like(ids[:, :1], dtype=torch.bool),
                     ids[:, 1:] == ids[:, :-1]], 1)
    ds = torch.where(dup | (ids < 0), INF, ds)
    ord2 = _stable_order(ds + 0.0)[:, :k]
    out_i, out_d, out_f = ids.gather(1, ord2), ds.gather(1, ord2), \
        fresh.gather(1, ord2)
    out_i = torch.where(torch.isfinite(out_d), out_i, -1)
    return out_i, out_d, out_f & (out_i >= 0)


def topk_pool_ref(ids, ds, k):
    """Distance-sort, dedup (nearest copy of an id wins), truncate to k.

    -1 ids and non-finite dists come back as (-1, inf) tail padding.
    """
    ds = torch.where(ids < 0, INF, ds)
    order = _stable_order(ds + 0.0)
    ids, ds = ids.gather(1, order), ds.gather(1, order)
    dup = mark_dups(ids)
    ids = torch.where(dup, -1, ids)
    ds = torch.where(dup, INF, ds)
    order = _stable_order(ds + 0.0)[:, :k]
    out_i, out_d = ids.gather(1, order), ds.gather(1, order)
    return torch.where(torch.isfinite(out_d), out_i, -1), out_d
