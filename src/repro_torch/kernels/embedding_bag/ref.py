"""Plain PyTorch version of ``embedding_bag``: the reference's arithmetic as
it runs on the CPU, one bag member at a time.

Per column, acc starts at 0 and takes ``acc = fma(w_l, row_l, acc)`` for
l = 0..L-1 in order (XLA on the CPU contracts the reference's multiply-add
into that chain). Here the fma is ``(acc + w * row)`` in float64 rounded
once to float32: the product of two float32 values is exact in float64, so
only the sum rounds before the final cast. The mean divides by
``max(sum_l w_l, 1e-9)``, summed in l order in float32. One (B, D) slice
is gathered per step, never a (B, L, D) tensor.
"""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      combiner: str = "sum") -> torch.Tensor:
    """table (V, D), ids (B, L) (-1 pads), weights (B, L) or None ->
    (B, D) float32. Ids >= V read row V - 1 (XLA's gather clamps)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    w = (torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
         if weights is None else weights.float())
    w = torch.where(ids >= 0, w, torch.zeros_like(w))     # pads weigh 0
    safe = ids.long().clamp(0, table.shape[0] - 1)
    acc = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    denom = torch.zeros((ids.shape[0], 1), dtype=torch.float32,
                        device=table.device)
    for l in range(ids.shape[1]):
        row = table[safe[:, l]].double()
        acc = (acc.double() + w[:, l, None].double() * row).float()
        denom = denom + w[:, l, None]
    if combiner == "mean":
        acc = acc / denom.clamp_min(1e-9)
    return acc
