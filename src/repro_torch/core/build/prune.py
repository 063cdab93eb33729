"""α-RNG occlusion pruning (the reference's ``core/build/prune.py``, the
part the build runs: ``alpha_prune`` and its chunked loop).

``alpha_prune`` generalizes NSG's MRNG edge-selection rule: scanning a
node's candidate pool nearest-first, candidate q is kept unless some
already-kept r occludes it — ``d(r, q) < alpha * d(p, q)`` on squared
distances. ``alpha = 1`` is the MRNG rule.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_dist import gather_dist
from repro_torch.kernels.topk_merge.ref import mark_dups as _mark_dups_block

# rows per block of ``mark_dups``: its (rows, L, L) bool temp stays small
_DUP_ROWS = 4096


def pairwise_rows_sqdist(q: torch.Tensor, data: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """(B, D) queries vs per-row gathered ids (B, K) -> (B, K) sq dists
    (diff-square form, +inf for ids < 0): the ``gather_dist`` function,
    so on the card it runs the kernel."""
    return gather_dist(q, data, ids)


def rows_sqdist_in_chunks(data: torch.Tensor, ids: torch.Tensor,
                          chunk: int = 2048) -> torch.Tensor:
    """Chunked ``pairwise_rows_sqdist`` of row i vs its (N, K) id table."""
    return torch.cat([pairwise_rows_sqdist(data[s:s + chunk], data,
                                           ids[s:s + chunk])
                      for s in range(0, ids.shape[0], chunk)])


def mark_dups(ids: torch.Tensor) -> torch.Tensor:
    """True at positions holding a value already seen to the left, and at
    ids < 0; row blocks bound the (rows, L, L) temp."""
    return torch.cat([_mark_dups_block(ids[s:s + _DUP_ROWS])
                      for s in range(0, ids.shape[0], _DUP_ROWS)])


def _alpha_scan(data, node_ids, cand_ids, cand_dists, degree, alpha):
    """The greedy α-RNG occlusion scan over a node block.

    Returns (keep (B, degree) ids, kept_mask (B, L) bool). The loop runs
    over the L candidate positions, all B nodes at once, with no host
    sync: kept rows are written by ``scatter`` whatever ``ok`` is.
    """
    b, L = cand_ids.shape
    dev = cand_ids.device
    keep = torch.full((b, degree), -1, dtype=torch.int32, device=dev)
    kept_vecs = torch.zeros((b, degree, data.shape[1]), dtype=torch.float32,
                            device=dev)
    mask = torch.zeros((b, L), dtype=torch.bool, device=dev)
    cnt = torch.zeros((b,), dtype=torch.int64, device=dev)
    slots = torch.arange(degree, device=dev)
    node_ids = node_ids.to(torch.int32)
    for j in range(L):
        q = cand_ids[:, j].to(torch.int32)
        dq = cand_dists[:, j]
        qv = data[q.clamp_min(0).long()].float()                   # (B, D)
        dr = ((kept_vecs - qv[:, None, :]) ** 2).sum(-1)          # (B, R)
        occupied = slots[None, :] < cnt[:, None]
        occluded = (occupied & (dr < alpha * dq[:, None])).any(1)
        dup = (occupied & (keep == q[:, None])).any(1)
        ok = ((q >= 0) & (q != node_ids) & (cnt < degree) & ~occluded
              & ~dup)
        slot = cnt.clamp_max(degree - 1)[:, None]                 # (B, 1)
        keep.scatter_(1, slot, torch.where(
            ok[:, None], q[:, None], keep.gather(1, slot)))
        vslot = slot[:, :, None].expand(-1, 1, data.shape[1])
        kept_vecs.scatter_(1, vslot, torch.where(
            ok[:, None, None], qv[:, None, :], kept_vecs.gather(1, vslot)))
        mask[:, j] = ok
        cnt += ok
    return keep, mask


def alpha_prune(data: torch.Tensor, node_ids: torch.Tensor,
                cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                degree: int, alpha: float = 1.0) -> torch.Tensor:
    """α-RNG edge selection for a block of nodes.

    node_ids: (B,); cand_ids/cand_dists: (B, L) distance-ascending candidate
    pools (-1 padded). Returns (B, degree) pruned neighbor ids.
    """
    return _alpha_scan(data, node_ids, cand_ids, cand_dists, degree,
                       alpha)[0]


def prune_in_chunks(data, node_ids, cand_ids, cand_dists, degree, chunk,
                    alpha: float = 1.0):
    """``alpha_prune`` over row chunks (bounds the block size)."""
    return torch.cat([
        alpha_prune(data, node_ids[s:s + chunk], cand_ids[s:s + chunk],
                    cand_dists[s:s + chunk], degree, alpha)
        for s in range(0, node_ids.shape[0], chunk)])
