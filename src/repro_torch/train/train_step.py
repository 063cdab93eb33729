"""Generic train-step factory (the reference's ``train/train_step.py``):
the loss registry per family, gradient accumulation over microbatches and
optional int8 error-feedback gradient compression.

    step = make_train_step(loss_fn_for("recsys", cfg), mixed_optimizer(1e-3))
    model, opt_state, metrics = step(model, opt_state, batch)

``loss_fn_for("lm", cfg)`` is ``models.transformer.lm_loss``,
``loss_fn_for("gnn", cfg)`` ``models.dimenet.loss_fn``.

``params`` is an ``nn.Module`` or a ``{name: tensor}`` dict of tensors that
require grad; the step updates them in place (see ``optim.adamw``). The
reference runs its microbatches under a ``scan`` with the batch re-sharded
on the data axis; without a mesh that re-shard is a no-op, so here a
microbatch is a plain slice of axis 0.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.analysis import op_costs
from repro_torch.distributed import sharding as SH
from repro_torch.models import dimenet, recsys, transformer
from repro_torch.optim import Optimizer, compress_with_feedback, named


def loss_fn_for(family: str, cfg, lookup_fn=None, mesh=None) -> Callable:
    """(params, batch) -> (loss, metrics). ``mesh``: the LM's
    tensor-parallel loss (``params`` a ``sharding.ShardedLM``)."""
    if family == "lm":
        return lambda p, b: transformer.lm_loss(p, cfg, b, mesh=mesh)
    if family == "gnn":
        return lambda p, b: dimenet.loss_fn(p, cfg, b)
    if family == "recsys":
        fam = recsys.family_of(cfg)
        return lambda p, b: recsys.LOSS[fam](p, cfg, b, lookup_fn)
    raise KeyError(family)


def _slice(batch: Any, i: int, n: int) -> Any:
    """Microbatch i of n: axis 0 of every tensor cut into n equal parts."""
    if isinstance(batch, torch.Tensor):
        if batch.shape[0] % n:
            raise ValueError(f"batch of {batch.shape[0]} rows does not "
                             f"split into {n} microbatches")
        m = batch.shape[0] // n
        return batch[i * m:(i + 1) * m]
    if isinstance(batch, dict):
        return {k: _slice(v, i, n) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_slice(v, i, n) for v in batch)
    return batch


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    microbatches: int = 1, compress: bool = False,
                    mesh=None):
    """Returns step(params, opt_state, batch[, err_state]) ->
    (params, opt_state[, err_state], metrics).

    microbatches > 1 splits the batch on axis 0 and accumulates the
    gradients in the parameters' dtype (zeros, then one add per
    microbatch, then a division by the count, as the reference); the
    metrics are the last microbatch's. With a ``mesh`` (the LM's
    tensor-parallel loss over a ``ShardedLM``), each microbatch is split
    over the batch groups inside the loss, as the reference's split keeps
    it on the data axes; the groups' gradients meet in the leaves they
    share, and the step prices the reference's all-reduce of one device's
    gradients over the data axes once, before the optimizer."""

    def grads_of(params, batch):
        ps = named(params)
        loss, metrics = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(ps.items(), gs)}
        return grads, {k: v.detach() for k, v in metrics.items()}

    def accumulate(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        acc = {n: torch.zeros_like(p, requires_grad=False)
               for n, p in named(params).items()}
        # a meta dry run counts one microbatch times the count
        # (analysis.op_costs.loop)
        with op_costs.loop(microbatches, *acc.values()) as trips:
            for i in range(trips):
                g, metrics = grads_of(params,
                                      _slice(batch, i, microbatches))
                for n, a in acc.items():
                    a.add_(g[n])
                del g
        return {n: a.div_(microbatches) for n, a in acc.items()}, metrics

    if mesh is not None:
        inner = accumulate

        def accumulate(params, batch):
            grads, metrics = inner(params, batch)
            op_costs.in_split(1, _price_allreduce, mesh, params, grads)
            return grads, metrics

    if compress:
        def step(params, opt_state, batch, err_state):
            grads, metrics = accumulate(params, batch)
            grads, err_state = compress_with_feedback(grads, err_state)
            params, opt_state, om = optimizer.update(grads, opt_state,
                                                     params)
            return params, opt_state, err_state, {**metrics, **om}
        return step

    def step(params, opt_state, batch):
        grads, metrics = accumulate(params, batch)
        params, opt_state, om = optimizer.update(grads, opt_state, params)
        return params, opt_state, {**metrics, **om}

    return step



def _price_allreduce(mesh, params, grads) -> None:
    """The data axes' all-reduce of one device's gradients (its leaves of
    a ``ShardedLM``, each at its bytes), work every device does once."""
    names = params.device_names() if hasattr(params, "device_names") \
        else list(grads)
    SH.record_grad_allreduce(mesh, {n: grads[n] for n in names},
                             {n: () for n in names}, SH.batch_axes(mesh))
