"""Tensor parallelism over a mesh's ``model`` axis: the collectives XLA
inserts when it partitions the reference's LM under the Megatron rules
(``distributed.sharding.lm_rules``), as one process runs them.

A batch group (one row of ``sharding.columns(mesh)``) is a ``Group``: its
``model`` devices, shard s on device s. A tensor every device of the group
holds (the residual stream, a norm's output, the loss) is one tensor on the
group's first device (``home``); a tensor each shard holds its own part of
is a list, one entry per shard. Replicated work runs once, counted as the
first shard's (``Group.local``); shard s's work runs on its device, counted
as its own (``Group.run``), so a cost counter sees each device's program
apart (``analysis.op_costs.in_shard``).

Each collective is a ``torch.autograd.Function`` whose backward is the
matching collective (Megatron's f / g pair):

  * ``all_reduce``: the sum of the shards' partials, in shard order, on
    ``home`` (g: a row-parallel product, the vocabulary-parallel lookup);
    its backward hands each shard the gradient (no traffic).
  * ``fan_out``: each shard's copy of a replicated tensor (f: the input of
    a column-parallel product); its backward sums the copies' gradients,
    priced as an all-reduce (or, for a gathered tensor, a reduce-scatter
    of its parts).
  * ``all_gather``: the shards' parts side by side on ``home``; its
    backward hands each shard its slice (the consumer is replicated work,
    so every device holds the whole gradient: no traffic).
  * ``all_to_all``: shard r receives slice r of every shard's part (a
    sequence split traded for a column split); its backward is the
    inverse all-to-all.
  * ``all_reduce_max``: the elementwise max over the shards, on ``home``,
    without a gradient (a softmax's shift, whose gradient is zero).
  * ``out_cols``: a product whose weight is split on its output columns
    (the reference's rules on an MoE config's leading dense block): each
    shard its columns of a replicated input, all-gathered.

Two reductions run over the data axes instead, between batch groups (the
MoE router's statistics, ``models.moe``): ``data_all_reduce`` sums the
groups' partials in group order on the mesh's first device (its backward
hands each group the gradient), and ``data_scan`` prices the exclusive
prefix sum of the groups' integer counts that a dispatch group split over
batch groups needs, as an all-gather of every group's counts.

Each is priced once, at the bytes one device's result holds, by
``op_costs.record_collective`` with ``hlo.py``'s wire factors; its own
data movement (the ``.to()`` copies and sums onto ``home``) is not counted
as work. On a mesh of ``meta`` devices only the first shard's program runs
and stands in for every one (``sharding.shard_map``'s convention): a
collective then merges copies of that one part.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch.autograd import Function

from repro_torch.analysis import op_costs
from repro_torch.distributed import sharding as SH


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Group:
    """Batch group ``g`` of ``mesh``: its ``model`` devices and the shard
    programs that run (every shard, or the first alone on a meta mesh)."""

    def __init__(self, mesh, g: int = 0):
        self.mesh = mesh
        self.g = g
        self.devices = list(SH.columns(mesh)[g])
        self.size = len(self.devices)
        self.meta = SH.on_meta(mesh)
        self.shards = range(1 if self.meta else self.size)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def run(self, s: int, fn, *args):
        """``fn(*args)`` as shard s's work (and its backward)."""
        return op_costs.in_shard((self.g, s), fn, *args)

    def local(self, fn, *args):
        """``fn(*args)`` as replicated work: every device of the group does
        it, counted as the first shard's."""
        return self.run(0, fn, *args)


def _to(x: torch.Tensor, dev) -> torch.Tensor:
    """``x`` on ``dev``: a new tensor object either way (an autograd
    Function must not hand an input back as its output)."""
    return x.to(dev) if x.device != torch.device(dev) else x.view_as(x)


def _stand_in(parts: Sequence[torch.Tensor], n: int) -> list:
    """The shards' parts, the first repeated where it stands in for all."""
    return list(parts) if len(parts) == n else [parts[0]] * n


# --------------------------------------------------------------- g / f
class _AllReduce(Function):
    """The parts summed in order on ``home``, priced as an all-reduce over
    ``size`` devices; the backward hands each part the gradient."""

    @staticmethod
    def forward(ctx, home, size: int, *parts):
        ctx.devices = [p.device for p in parts]
        with op_costs.suspended():
            out = _to(parts[0], home)
            for p in parts[1:]:
                out = out + p.to(home)
        op_costs.record_collective("all-reduce", _nbytes(out), size)
        return out

    @staticmethod
    def backward(ctx, grad):
        with op_costs.suspended():
            return (None, None) + tuple(grad.to(d) for d in ctx.devices)


def all_reduce(grp: Group, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partials summed in shard order, on ``home``."""
    return grp.local(_AllReduce.apply, grp.home, grp.size, *parts)


class _Copy(Function):
    @staticmethod
    def forward(ctx, x, dev, op, nbytes: int, size: int):
        ctx.home, ctx.op, ctx.nbytes, ctx.size = x.device, op, nbytes, size
        with op_costs.suspended():
            return _to(x, dev)

    @staticmethod
    def backward(ctx, grad):
        if ctx.op is not None:
            op_costs.record_collective(ctx.op, ctx.nbytes, ctx.size)
        with op_costs.suspended():
            return grad.to(ctx.home), None, None, None, None


def fan_out(grp: Group, x: torch.Tensor, op: str = "all-reduce",
            nbytes: int = 0) -> List[torch.Tensor]:
    """Each running shard's copy of ``x`` (on ``home``). Autograd sums the
    copies' gradients onto ``x``, which is priced once as ``op`` of
    ``nbytes`` (default: ``x``'s bytes)."""
    nbytes = nbytes or _nbytes(x)
    return grp.local(lambda: [
        _Copy.apply(x, grp.devices[s], op if s == 0 else None, nbytes,
                    grp.size) for s in grp.shards])


def replicate(grp: Group, x: torch.Tensor) -> List[torch.Tensor]:
    """Each running shard's copy of ``x``, with no traffic priced either
    way (a value every device computed, or a decode step's input)."""
    return grp.local(lambda: [_Copy.apply(x, grp.devices[s], None, 0,
                                          grp.size) for s in grp.shards])


# ----------------------------------------------------------- all-gather
class _AllGather(Function):
    @staticmethod
    def forward(ctx, grp: Group, dim: int, *parts):
        ctx.devices = [p.device for p in parts]
        ctx.dim, ctx.n = dim, parts[0].shape[dim]
        with op_costs.suspended():
            out = torch.cat([p.to(grp.home)
                             for p in _stand_in(parts, grp.size)], dim=dim)
        op_costs.record_collective("all-gather", _nbytes(out), grp.size)
        return out

    @staticmethod
    def backward(ctx, grad):
        with op_costs.suspended():
            return (None, None) + tuple(
                grad.narrow(ctx.dim, s * ctx.n, ctx.n).to(d)
                for s, d in enumerate(ctx.devices))


def all_gather(grp: Group, parts: Sequence[torch.Tensor],
               dim: int) -> torch.Tensor:
    """The shards' parts side by side along ``dim``, on ``home``."""
    return grp.local(_AllGather.apply, grp, dim, *parts)


def all_gather_to_shards(grp: Group, parts: Sequence[torch.Tensor],
                         dim: int) -> List[torch.Tensor]:
    """The gathered tensor on every running shard, each consuming it in its
    own way: the backward sums the shards' gradients and hands each its
    slice, a reduce-scatter."""
    full = all_gather(grp, parts, dim)
    return fan_out(grp, full, "reduce-scatter", _nbytes(parts[0]))


# ----------------------------------------------------------- all-to-all
class _AllToAll(Function):
    @staticmethod
    def forward(ctx, grp: Group, split: int, cat: int, *parts):
        ctx.grp, ctx.split, ctx.cat = grp, split, cat
        return _all_to_all(grp, split, cat, parts)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + _all_to_all(ctx.grp, ctx.cat,
                                                ctx.split, grads)


def _all_to_all(grp: Group, split: int, cat: int, parts) -> tuple:
    n = grp.size
    with op_costs.suspended():
        pieces = [p.chunk(n, dim=split) for p in _stand_in(parts, n)]
        out = tuple(torch.cat([pieces[s][r].to(grp.devices[r])
                               for s in range(n)], dim=cat)
                    for r in range(len(parts)))
    op_costs.record_collective("all-to-all", _nbytes(out[0]), n)
    return out


def all_to_all(grp: Group, parts: Sequence[torch.Tensor], split: int,
               cat: int) -> List[torch.Tensor]:
    """Shard r receives slice r (along ``split``) of every shard's part,
    in shard order along ``cat``."""
    return list(grp.local(_AllToAll.apply, grp, split, cat, *parts))


# ------------------------------------------------------------ max
def all_reduce_max(grp: Group, parts: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    """The elementwise max of the shards' parts, on ``home``, detached."""
    return grp.local(_max, grp, parts)


@torch.no_grad()
def _max(grp: Group, parts) -> torch.Tensor:
    with op_costs.suspended():
        out = parts[0].to(grp.home)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(grp.home))
    op_costs.record_collective("all-reduce", _nbytes(out), grp.size)
    return out


def out_cols(grp: Group, ws: Sequence[torch.Tensor],
             x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a replicated ``x`` (on ``home``) and a weight split on
    its output columns (``ws[s]``: shard s's): each shard its columns,
    gathered on the last dim. The backward sums the shards' gradients of
    ``x`` (an all-reduce)."""
    xs = fan_out(grp, x)
    return all_gather(grp, [grp.run(i, torch.matmul, xs[k], ws[i])
                            for k, i in enumerate(grp.shards)], -1)


# ------------------------------------------------- over the data axes
def data_all_reduce(mesh, parts: Sequence[torch.Tensor],
                    size: int) -> torch.Tensor:
    """The batch groups' partials summed in group order on the mesh's
    first device, priced once as an all-reduce over ``size`` devices (the
    data axes' size where the batch split over them, else 1). On a meta
    mesh the first group's part stands in for the sum."""
    return _AllReduce.apply(mesh.devices.reshape(-1)[0], size, *parts)


def data_scan(mesh, counts: torch.Tensor, size: int) -> None:
    """Price one batch group's share of an exclusive prefix sum over the
    data axes: its integer ``counts`` all-gathered over ``size`` devices
    (each group then sums the ones before its own; one process has them
    already)."""
    op_costs.record_collective("all-gather", _nbytes(counts) * size, size)
