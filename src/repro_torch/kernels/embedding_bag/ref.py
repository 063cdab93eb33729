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

``bag_grouping_ref`` is the plain version of the grouping kernel: a
stable ``torch.sort`` of the flat ids (pads < 0 dropped, ids >= V folded
onto V - 1) into a ``BagPlan``. ``embedding_bag_backward_ref`` is the
plain version of the gradient with respect to the table, in the CUDA
kernel's order: the terms ``(g[b] / denom_b) * w[b, l]`` of the members
with ids >= 0, grouped by the plan, added into a zero (V, D) tensor in
ascending (b, l) order per row. It adds them rank by rank (the r-th member
of every id at once, through ``index_add_`` over ids that are then all
distinct), so no two additions into one row race on any device: each row
gets ((0 + t_0) + t_1) + ..., on the CPU and on the card alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class BagPlan:
    """The grouping of a flat id tensor over ``num_rows`` rows: pads (< 0)
    dropped, ids >= num_rows folded onto num_rows - 1, positions grouped
    stably by id.

    ids: (n,) int32, the ids as given (contiguous); order: the n_valid
    flat positions, ascending within each id; rows: the U distinct ids,
    ascending; starts: the U + 1 run starts (the last is n_valid); count:
    (2,) int32 ``[U, n_valid]`` on the plan's device. The card's plan
    (``bag_grouping_cuda``) keeps U on the device, so its ``order``,
    ``rows`` and ``starts`` hold n, min(n, V) and min(n, V) + 1 entries of
    which the first n_valid, U and U + 1 are used; the plain version's are
    exactly as long as used."""
    ids: torch.Tensor
    num_rows: int
    order: torch.Tensor
    rows: torch.Tensor
    starts: torch.Tensor
    count: torch.Tensor

    def used(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(order, rows, starts) cut to the entries in use (reads the count
        on the host)."""
        u, n_valid = (int(x) for x in self.count.tolist())
        return self.order[:n_valid], self.rows[:u], self.starts[:u + 1]


def bag_grouping_ref(ids: torch.Tensor, num_rows: int) -> BagPlan:
    """The plan of ``ids`` (any shape; flattened) over ``num_rows`` rows by
    a stable ``torch.sort`` of the folded ids, on the ids' device."""
    if num_rows <= 0:
        raise ValueError(f"bag_grouping: num_rows must be positive, got "
                         f"{num_rows}")
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    keys, perm = torch.sort(flat.long().clamp_max(num_rows - 1),
                            stable=True)
    keep = keys >= 0
    keys, perm = keys[keep], perm[keep]
    head = torch.ones_like(keys, dtype=torch.bool)
    head[1:] = keys[1:] != keys[:-1]
    n_valid = keys.numel()
    starts = torch.cat([torch.nonzero(head)[:, 0],
                        torch.tensor([n_valid], device=keys.device)])
    rows = keys[head]
    return BagPlan(ids=flat, num_rows=num_rows, order=perm.int(),
                   rows=rows.int(), starts=starts.int(),
                   count=torch.tensor([rows.numel(), n_valid],
                                      dtype=torch.int32, device=keys.device))


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
    for l in range(ids.shape[1]):
        acc = _fma32(w[:, l, None], table[safe[:, l]], acc)
    if combiner == "mean":
        acc = acc / bag_denoms(ids, w)[:, None]
    return acc


def bag_denoms(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,) max(sum_l w[b, l], 1e-9) over the members with ids >= 0,
    summed in l order in float32, as the forward sums it."""
    w = torch.where(ids >= 0, w, torch.zeros_like(w))
    denom = torch.zeros((ids.shape[0],), dtype=torch.float32,
                        device=ids.device)
    for l in range(ids.shape[1]):
        denom = denom + w[:, l]
    return denom.clamp_min(1e-9)


def embedding_bag_backward_ref(grad_out: torch.Tensor, ids: torch.Tensor,
                               weights: Optional[torch.Tensor],
                               combiner: str, num_rows: int,
                               plan: Optional[BagPlan] = None
                               ) -> torch.Tensor:
    """grad_out (B, D), ids (B, L) (-1 pads), weights (B, L) or None ->
    the (num_rows, D) float32 gradient of ``embedding_bag_ref(table, ids,
    weights, combiner)`` with respect to ``table``. Ids >= num_rows add
    into row num_rows - 1, as the forward reads it. ``plan``:
    ``bag_grouping_ref(ids, num_rows)`` (or the card's), built here when
    None."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    g = grad_out.float()
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    if plan is None:
        plan = bag_grouping_ref(ids, num_rows)
    order, rows, starts = plan.used()
    if order.numel() == 0:
        return out
    perm = order.long()
    lengths = (starts[1:] - starts[:-1]).long()
    keys = rows.long().repeat_interleave(lengths)
    rank = torch.arange(perm.numel(), device=perm.device) - \
        starts[:-1].long().repeat_interleave(lengths)
    bag = perm // ids.shape[1]
    terms = g[bag]
    if combiner == "mean":
        w = (torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
             if weights is None else weights.float())
        terms = terms / bag_denoms(ids, w)[bag, None]
    if weights is not None:
        terms = terms * weights.float().reshape(-1)[perm, None]
    for r in range(int(lengths.max())):
        at = rank == r
        out.index_add_(0, keys[at], terms[at])
    return out
