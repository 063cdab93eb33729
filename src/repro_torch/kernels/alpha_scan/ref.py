"""Plain PyTorch version of the α-scan: the greedy α-RNG occlusion scan of
a node block (the reference's ``core/build/prune.py:_alpha_scan``).

The loop runs over the L candidate positions, all B nodes at once, with no
host sync: kept ids are written by ``scatter`` whatever ``ok`` is. The
distances from a candidate to the kept rows are one ``gather_dist`` block
over the kept ids (the kernel on CUDA; on the CPU its plain diff-square
version, the reference's arithmetic), so no (B, R, D) copy of the kept
rows is held.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels.gather_dist import gather_dist


def alpha_scan_ref(data: torch.Tensor, node_ids: torch.Tensor,
                   cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                   degree: int, alpha: Union[float, torch.Tensor]):
    """(N, D) data, (B,) node ids, (B, L) distance-ascending candidate ids
    (-1 padded) and their distances -> (keep (B, degree) int32, mask (B, L)
    bool).

    Scanning each row nearest-first, candidate q is kept unless it is -1,
    the node itself, already kept, past ``degree`` kept, or occluded: some
    kept r has ``d(q, r) < alpha * d(p, q)``. ``alpha`` is one slack for
    the block or a (B,) f32 tensor of one per row; either way the threshold
    is one f32 product. ``mask`` marks the kept positions: the ids in
    ``keep`` are ``cand_ids`` at its True positions, in order.
    """
    b, L = cand_ids.shape
    dev = cand_ids.device
    keep = torch.full((b, degree), -1, dtype=torch.int32, device=dev)
    mask = torch.zeros((b, L), dtype=torch.bool, device=dev)
    cnt = torch.zeros((b,), dtype=torch.int64, device=dev)
    slots = torch.arange(degree, device=dev)
    node_ids = node_ids.to(torch.int32)
    for j in range(L):
        q = cand_ids[:, j].to(torch.int32)
        dq = cand_dists[:, j]
        qv = data[q.clamp_min(0).long()].float()                   # (B, D)
        dr = gather_dist(qv, data, keep)                           # (B, R)
        occupied = slots[None, :] < cnt[:, None]
        occluded = (occupied & (dr < (alpha * dq)[:, None])).any(1)
        dup = (occupied & (keep == q[:, None])).any(1)
        ok = ((q >= 0) & (q != node_ids) & (cnt < degree) & ~occluded
              & ~dup)
        slot = cnt.clamp_max(degree - 1)[:, None]                 # (B, 1)
        keep.scatter_(1, slot, torch.where(
            ok[:, None], q[:, None], keep.gather(1, slot)))
        mask[:, j] = ok
        cnt += ok
    return keep, mask
