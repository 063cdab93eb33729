"""Plain PyTorch version of ``embedding_bag``: the reference's arithmetic as
it runs on the CPU, one bag member at a time.

Per column, acc starts at 0 and takes ``acc = fma(w_l, row_l, acc)`` for
l = 0..L-1 in order (XLA on the CPU contracts the reference's multiply-add
into that chain). ``_fma32`` forms that fma with one rounding: the product
of two float32 values is exact in float64, the float64 sum ``s`` and its
exact error ``e`` (TwoSum) hold the exact result ``s + e``, and ``s`` is
rounded to float32 to nearest, except where ``s`` is exactly a float32
midpoint and ``e`` is not 0: there the exact result lies on ``e``'s side of
the midpoint, and the rounding goes that way. The mean divides by
``max(sum_l w_l, 1e-9)``, summed in l order in float32. One (B, D) slice
is gathered per step, never a (B, L, D) tensor.
"""
from __future__ import annotations

from typing import Optional

import torch


def _fma32(w: torch.Tensor, row: torch.Tensor,
           acc: torch.Tensor) -> torch.Tensor:
    """float32 ``w * row + acc`` rounded once, as a fused multiply-add."""
    a = acc.double()
    p = w.double() * row.double()                  # exact
    s = a + p
    bb = s - a
    e = (a - (s - bb)) + (p - bb)                  # s + e == a + p exactly
    near = s.float()
    fd = near.double()
    # the other float32 neighbour of s; s is a midpoint when it lies
    # exactly halfway between the two
    other = torch.nextafter(near, torch.where(s > fd, torch.inf,
                                              -torch.inf).float())
    mid = (fd != s) & ((fd + other.double()) * 0.5 == s) & (e != 0)
    toward_other = (e > 0) == (other > near)
    return torch.where(mid & toward_other, other, near)


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
        acc = _fma32(w[:, l, None], table[safe[:, l]], acc)
        denom = denom + w[:, l, None]
    if combiner == "mean":
        acc = acc / denom.clamp_min(1e-9)
    return acc
