"""Device dispatch for EmbeddingBag (the recsys models' multi-hot lookup),
differentiable with respect to the table.

One ``torch.autograd.Function`` serves both devices. Its forward is the
CUDA kernel for CUDA tensors and the plain version for CPU tensors; its
backward is the backward kernel on CUDA and its plain version on the CPU,
each adding into a zero (V, D) float32 gradient in the same order, so the
two devices give the same gradient bits. Only a float32 table trains (a
bfloat16 table that requires grad raises); ``weights`` is not
differentiated.

The backward groups the ids first: ``bag_grouping`` (the grouping kernel
on CUDA, a stable ``torch.sort`` on the CPU) gives a ``BagPlan``, and the
backward kernel sums each row's terms over it, one warp a row. The plan
depends on the ids alone, so a caller that scatters by the same ids
several times builds it once and passes it as ``plan=`` to each call
(DimeNet: one plan per id array a step); without one, each backward builds
its own. On the card the planned path reaches no sort: a call costs a zero
fill and one sum launch.

``segment_sum`` is the same pair of kernels the other way round, for the
GNN's scatters (``jax.ops.segment_sum``): its forward is the backward
kernel with one id per row (ids (T, 1), sum), which sums each segment's
rows in ascending row order, with no float atomics; its gradient is the
bag (a row gather, L = 1). A row gather that trains, ``table[ids]``, is
``embedding_bag(table, ids[:, None])``, whose gradient is that
deterministic scatter. On the CPU both sides are the plain versions, which
sum in the same order, so the two devices give the same bits. An id of -1
is skipped both ways (its row gathers as 0).

On meta tensors (the dry run) every call takes the card's path, whose
wrappers allocate as for a launch, record each kernel's cost and launch
nothing; a plan's rows and starts are then at their bound min(n, V), as
the card allocates them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.embedding_bag.embedding_bag import \
    bag_grouping_cuda, check_plan, embedding_bag_backward_cuda, \
    embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import BagPlan, \
    bag_grouping_ref, embedding_bag_backward_ref, embedding_bag_ref


def bag_grouping(ids: torch.Tensor, num_rows: int) -> BagPlan:
    """The plan of ``ids`` (-1 pads) over ``num_rows`` rows, to pass as
    ``plan=`` to every ``embedding_bag`` / ``segment_sum`` call on those
    ids and rows: the grouping kernel for CUDA ids, its plain version for
    CPU ids."""
    if use_kernel(ids, None, "bag_grouping", meta=True):
        return bag_grouping_cuda(ids.to(torch.int32), num_rows)
    return bag_grouping_ref(ids, num_rows)


class EmbeddingBagFunction(torch.autograd.Function):
    """(table, ids, weights, combiner, on_card, plan) -> (B, D) bags."""

    @staticmethod
    def forward(ctx, table, ids, weights, combiner, on_card, plan):
        ctx.combiner, ctx.on_card, ctx.num_rows, ctx.plan = combiner, \
            on_card, table.shape[0], plan
        ctx.save_for_backward(ids, weights)
        if on_card:
            return embedding_bag_cuda(table, ids, weights, combiner)
        return embedding_bag_ref(table, ids, weights, combiner)

    @staticmethod
    def backward(ctx, grad_out):
        ids, weights = ctx.saved_tensors
        if ctx.on_card:
            grad = torch.zeros((ctx.num_rows, grad_out.shape[1]),
                               dtype=torch.float32, device=grad_out.device)
            embedding_bag_backward_cuda(grad_out.float().contiguous(), ids,
                                        weights, ctx.combiner, grad,
                                        ctx.plan, store=True)
        else:
            grad = embedding_bag_backward_ref(grad_out, ids, weights,
                                              ctx.combiner, ctx.num_rows,
                                              ctx.plan)
        return grad, None, None, None, None, None


def _planned_ids(ids: torch.Tensor, plan: Optional[BagPlan],
                 num_rows: int, on_card: bool, name: str) -> torch.Tensor:
    """``ids`` as the kernels take them (int32, contiguous on the card):
    the plan's copy when there is a plan."""
    if plan is not None:
        check_plan(plan, ids, num_rows, name)
        return plan.ids.reshape(ids.shape)
    return ids.to(torch.int32).contiguous() if on_card else ids


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  combiner: str = "sum",
                  backend: Optional[str] = None,
                  plan: Optional[BagPlan] = None) -> torch.Tensor:
    """table (V, D) f32/bf16, ids (B, L) (-1 pads), weights (B, L) or None
    -> (B, D) f32 weighted sum or mean of the rows: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors; differentiable with
    respect to a float32 table. ``plan``: ``bag_grouping(ids, V)``, which
    the backward then uses instead of grouping the ids itself."""
    if table.requires_grad and torch.is_grad_enabled() and \
            table.dtype != torch.float32:
        raise TypeError(f"embedding_bag: only a float32 table trains, got "
                        f"{table.dtype} with requires_grad")
    on_card = use_kernel(table, backend, "embedding_bag", meta=True)
    ids = _planned_ids(ids, plan, table.shape[0], on_card, "embedding_bag")
    if on_card and weights is not None:
        weights = weights.float().contiguous()
    return EmbeddingBagFunction.apply(table, ids, weights, combiner, on_card,
                                      plan)


class SegmentSumFunction(torch.autograd.Function):
    """(data, ids (T, 1), num_segments, on_card, plan) ->
    (num_segments, D)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, on_card, plan):
        ctx.on_card = on_card
        ctx.save_for_backward(ids)
        if on_card:
            out = torch.zeros((num_segments, data.shape[1]),
                              dtype=torch.float32, device=data.device)
            return embedding_bag_backward_cuda(data, ids, None, "sum", out,
                                               plan, store=True)
        return embedding_bag_backward_ref(data, ids, None, "sum",
                                          num_segments, plan)

    @staticmethod
    def backward(ctx, grad_out):
        ids, = ctx.saved_tensors
        g = grad_out.float().contiguous()
        if ctx.on_card:
            grad = embedding_bag_cuda(g, ids, None, "sum")
        else:
            grad = embedding_bag_ref(g, ids, None, "sum")
        return grad, None, None, None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                plan: Optional[BagPlan] = None) -> torch.Tensor:
    """data (T, D) float32, segment_ids (T,) (-1 skips a row) ->
    (num_segments, D) float32: out[s] = sum of data[t] over segment_ids[t]
    == s, added in ascending t: the backward kernel of the bag for CUDA
    tensors, its plain version for CPU tensors; differentiable with
    respect to ``data``. Ids >= num_segments are outside the contract
    (they add into the last segment). ``plan``: ``bag_grouping(
    segment_ids, num_segments)``, shared by every call on those ids."""
    if data.dtype != torch.float32 or data.dim() != 2:
        raise TypeError(f"segment_sum: data must be a 2-D float32 tensor, "
                        f"got {data.dtype} {tuple(data.shape)}")
    if segment_ids.shape != data.shape[:1]:
        raise ValueError(f"segment_sum: segment_ids "
                         f"{tuple(segment_ids.shape)} do not match data's "
                         f"{data.shape[0]} rows")
    if num_segments <= 0:
        raise ValueError(f"segment_sum: num_segments must be positive, got "
                         f"{num_segments}")
    on_card = use_kernel(data, None, "segment_sum", meta=True)
    ids = _planned_ids(segment_ids.reshape(-1, 1), plan, num_segments,
                       on_card, "segment_sum")
    if on_card:
        data = data.contiguous()
    return SegmentSumFunction.apply(data, ids, num_segments, on_card, plan)
