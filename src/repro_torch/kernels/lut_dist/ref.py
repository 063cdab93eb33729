"""Plain PyTorch version: gather code rows, pick each query's LUT entries
and add them over the sub-spaces strictly left to right (the order of the
reference's ``lut_dist/ref.py``, which its kernel and this port's kernels
reproduce bit for bit)."""
import torch


def lut_dist_ref(lut: torch.Tensor, codes: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """lut (Q, M, C) f32, codes (N, M) uint8, ids (Q, R) int -> (Q, R).

    d[q, r] = sum_m lut[q, m, codes[ids[q, r], m]], +inf for ids < 0.
    Codes above C - 1 read entry C - 1 (as the reference's clamped gather).
    """
    c = lut.shape[2]
    rows = codes[ids.clamp_min(0).long()].long().clamp_max(c - 1)  # (Q,R,M)
    picks = lut.float().gather(2, rows.transpose(1, 2))            # (Q,M,R)
    d = picks[:, 0]
    for mm in range(1, picks.shape[1]):
        d = d + picks[:, mm]
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
