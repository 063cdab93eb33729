"""Device dispatch for EmbeddingBag (the recsys models' multi-hot lookup),
differentiable with respect to the table.

One ``torch.autograd.Function`` serves both devices. Its forward is the
CUDA kernel for CUDA tensors and the plain version for CPU tensors; its
backward is the backward kernel on CUDA and its plain version on the CPU,
each adding into a zero (V, D) float32 gradient in the same order, so the
two devices give the same gradient bits. Only a float32 table trains (a
bfloat16 table that requires grad raises); ``weights`` is not
differentiated.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.embedding_bag.embedding_bag import \
    embedding_bag_backward_cuda, embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import \
    embedding_bag_backward_ref, embedding_bag_ref


class EmbeddingBagFunction(torch.autograd.Function):
    """(table, ids, weights, combiner, on_card) -> (B, D) bags."""

    @staticmethod
    def forward(ctx, table, ids, weights, combiner, on_card):
        ctx.combiner, ctx.on_card, ctx.num_rows = combiner, on_card, \
            table.shape[0]
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
                                        weights, ctx.combiner, grad)
        else:
            grad = embedding_bag_backward_ref(grad_out, ids, weights,
                                              ctx.combiner, ctx.num_rows)
        return grad, None, None, None, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  combiner: str = "sum",
                  backend: Optional[str] = None) -> torch.Tensor:
    """table (V, D) f32/bf16, ids (B, L) (-1 pads), weights (B, L) or None
    -> (B, D) f32 weighted sum or mean of the rows: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors; differentiable with
    respect to a float32 table."""
    if table.requires_grad and torch.is_grad_enabled() and \
            table.dtype != torch.float32:
        raise TypeError(f"embedding_bag: only a float32 table trains, got "
                        f"{table.dtype} with requires_grad")
    on_card = use_kernel(table, backend, "embedding_bag")
    if on_card:
        ids = ids.to(torch.int32).contiguous()
        weights = None if weights is None else weights.float().contiguous()
    return EmbeddingBagFunction.apply(table, ids, weights, combiner, on_card)
