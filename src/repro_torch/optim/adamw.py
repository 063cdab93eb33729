"""Optimizers (the reference's ``optim/adamw.py``): ``(init, update)``
pairs over a model's named parameters.

AdamW for dense parameters; row-wise Adagrad for embedding tables
(DLRM-style: one accumulator scalar per row, 4 bytes a row instead of two
full moments); ``mixed_optimizer`` picks per parameter by name.

    opt = mixed_optimizer(1e-3)
    state = opt.init(model)                      # or a {name: tensor} dict
    params, state, metrics = opt.update(grads, state, model)

``params`` is an ``nn.Module`` (its ``named_parameters()``) or a
``{name: tensor}`` dict; ``grads`` a ``{name: tensor}`` dict of the same
names. Unlike the reference's pure functions, ``update`` works in place:
it writes the new values into the parameters, the state's tensors and the
gradients (the clip scales them), and returns the same objects. At full
width a table is 14.35 GB and its gradient as much, so the table's update
runs over row chunks of ``TABLE_ROWS`` rows and allocates no table-sized
temporary; every element gets the value of the reference's whole-table
arithmetic. Scalars (the step, the learning rate, the clip scale) stay
0-dim float32 tensors on the parameters' device, so an update makes no
host sync, and round as the reference's float32 scalars do.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch
from torch import nn

Params = Union[nn.Module, Dict[str, torch.Tensor]]

TABLE_ROWS = 1 << 18          # rows per chunk of a table's update
_SQ_CHUNK = 1 << 26           # elements per partial sum of squares


class Optimizer(NamedTuple):
    init: Callable
    update: Callable        # (grads, state, params) -> (params, state, info)


def named(params: Params) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a module's parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _device(tensors) -> torch.device:
    return next(iter(tensors.values())).device


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2) in float32, over slices of _SQ_CHUNK elements (a table's
    square would be another table)."""
    flat = x.reshape(-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, flat.numel(), _SQ_CHUNK):
        c = flat[i:i + _SQ_CHUNK].float()
        total = total + torch.dot(c, c)
    return total


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = [_sq_sum(x) for x in tree.values()]
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float):
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)), in place;
    returns (tree, norm)."""
    n = global_norm(tree)
    scale = torch.clamp_max(_f32(max_norm, n.device) / n.clamp_min(1e-9),
                            1.0)
    for g in tree.values():
        g.mul_(scale)
    return tree, n


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """step -> lr: linear warmup to base_lr, then a cosine down to
    base_lr * min_ratio at ``total``; float32 as the reference."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * (step / max(warmup, 1)).clamp_max(1.0)
        t = ((step - warmup) / max(total - warmup, 1)).clamp(0, 1)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(_f32(math.pi, step.device) * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def _lr_fn(lr):
    return lr if callable(lr) else (lambda stepf: _f32(lr, stepf.device))


def _adam_leaf_(p, g, m, v, stepf, lr_t, b1, b2, eps, wd):
    """One AdamW update of one parameter, in place, in the reference's
    order: m, v, the bias corrections, delta, decay, p - lr * delta
    (under the caller's no_grad)."""
    g32 = g.float()
    m.mul_(b1).add_((1 - b1) * g32)
    v.mul_(b2).add_((1 - b2) * g32 * g32)
    mh = m / (1 - torch.pow(_f32(b1, p.device), stepf))
    vh = v / (1 - torch.pow(_f32(b2, p.device), stepf))
    delta = mh / (torch.sqrt(vh) + eps)
    if wd:
        delta = delta + wd * p.float()
    p.copy_((p.float() - lr_t * delta).to(p.dtype))


def _adagrad_rows_(p, g, acc, table_lr, eps, rows: int = TABLE_ROWS):
    """Row-wise Adagrad, in place over row chunks: acc += mean(g^2) per
    row, p -= g * table_lr / (sqrt(acc) + eps) (under the caller's
    no_grad)."""
    lr = _f32(table_lr, p.device)
    dims = tuple(range(1, g.dim()))
    for i in range(0, p.shape[0], rows):
        g32 = g[i:i + rows].float()
        a = acc[i:i + rows]
        sq = g32 * g32
        a.add_(sq.mean(dim=dims) if dims else sq)
        coef = lr / (torch.sqrt(a) + eps)
        delta = g32 * coef.reshape((-1,) + (1,) * len(dims))
        pc = p[i:i + rows]
        if pc.dtype == torch.float32:
            pc.sub_(delta)
        else:
            pc.copy_((pc.float() - delta).to(pc.dtype))


def _clip(grads, clip_norm):
    if clip_norm:
        return clip_by_global_norm(grads, clip_norm)[1]
    return global_norm(grads)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = 1.0
          ) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        ps = named(params)
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in ps.items()}
        return {"m": zeros, "v": {n: z.clone() for n, z in zeros.items()},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_device(ps))}

    @torch.no_grad()
    def update(grads, state, params):
        ps = named(params)
        gnorm = _clip(grads, clip_norm)
        state["step"] += 1
        stepf = state["step"].float()
        lr_t = lr_fn(stepf)
        for n, p in ps.items():
            _adam_leaf_(p, grads[n], state["m"][n], state["v"][n], stepf,
                        lr_t, b1, b2, eps, weight_decay)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


def is_table_name(name: str) -> bool:
    """The reference's default: a leaf whose path holds the key 'table'."""
    return "table" in name.split(".")


def mixed_optimizer(lr, table_lr: float = 0.01,
                    is_table: Optional[Callable[[str], bool]] = None,
                    **adamw_kw) -> Optimizer:
    """AdamW everywhere except embedding tables (row-wise Adagrad).

    is_table(name) -> bool decides per parameter; default: a name with
    the component 'table'."""
    is_table = is_table or is_table_name
    lr_fn = _lr_fn(lr)
    b1 = adamw_kw.get("b1", 0.9)
    b2 = adamw_kw.get("b2", 0.95)
    eps = adamw_kw.get("eps", 1e-8)
    wd = adamw_kw.get("weight_decay", 0.0)
    clip = adamw_kw.get("clip_norm", 1.0)

    def init(params):
        ps = named(params)

        def leaf_state(n, p):
            if is_table(n):
                return {"acc": torch.zeros((p.shape[0],),
                                           dtype=torch.float32,
                                           device=p.device)}
            return {"m": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device),
                    "v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"leaves": {n: leaf_state(n, p) for n, p in ps.items()},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_device(ps))}

    @torch.no_grad()
    def update(grads, state, params):
        ps = named(params)
        gnorm = _clip(grads, clip)
        state["step"] += 1
        stepf = state["step"].float()
        lr_t = lr_fn(stepf)
        for n, p in ps.items():
            s = state["leaves"][n]
            if "acc" in s:
                _adagrad_rows_(p, grads[n], s["acc"], table_lr, eps)
            else:
                _adam_leaf_(p, grads[n], s["m"], s["v"], stepf, lr_t, b1,
                            b2, eps, wd)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)
