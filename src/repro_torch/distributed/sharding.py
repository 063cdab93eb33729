"""Sharding on a mesh (the reference's ``distributed/sharding.py``): the
ANN's row sharding, the per-family rules, and the batch, cache and ZeRO-1
specs.

``RowSharded`` is what the reference's ``NamedSharding(mesh, P("model",
...))`` array is here: a ``(S * m, ...)`` array held as S equal blocks,
block s placed on every device of mesh column s (replicated over the
other axes; a device named twice holds one copy). Nothing concatenates the
blocks except ``to_host`` — the flat read for counts and tests.

``shard_map`` plays the role of the reference's ``shard_map``: it runs a
per-shard body on the device that owns each shard, in one process, and
collects the results — row-sharded (one output block per shard) or
batch-major (the query batch split over the batch axes, each shard's
columns side by side in shard order). ``shard_sum`` splits tensors over
every device of the mesh and sums the programs' results (the
reference's ``psum`` over all axes: the GNN's edge partition). Each
(group, shard) program runs inside ``analysis.op_costs.in_shard``, and
each merge is priced as the reference's collective (an all-gather over
``model``, an all-reduce over every device), so a cost counter sees each
device's program apart. On a mesh of ``meta`` devices (the dry run)
every program has the same shapes, so only the first runs and stands in
for the others: the counted program is every device's, and a
production mesh of 256 or 512 devices costs one program's time.

Rules: (regex on a parameter's reference path, spec) pairs, first match
wins, a spec a tuple of mesh-axis names (or tuples of names) and None per
dimension, as the reference's ``PartitionSpec``. The regexes are the
reference's, matched on the reference's paths: ``carry.reference_path``
maps a port name back to its path, and an LM layer of the port is a slice
of the reference's stacked ``layers/...`` leaf (``carry.lm_reference_
path``), so its spec drops the stacked axis. ``tree_shardings`` gives
each leaf's spec with the reference's divisibility guard, ``shard_shape``
a leaf's per-device shape under one.

The LM's tensor- and expert-parallel program
(``distributed.tensor_parallel``, ``models.transformer``'s ``mesh=``) runs
on ``shard_lm``'s ``ShardedLM``: each parameter sliced as
``lm_param_shardings`` gives its spec, one slice per ``model`` shard (an
MoE layer's routed experts on their expert axis); a replicated parameter
is one leaf that every shard's module holds. ``batch_seq_spec`` is the
reference's ``shard_batch_seq`` rule, by which the programs split the
batch over the data axes and the sequence over ``model``;
``init_sharded_cache`` splits a KV cache as ``kv_cache_sharding`` says.

Left out: the reference's ``set_active_mesh``, ``maybe_shard`` and
``active_dp_axes`` (its ``:41-118``). They place tensors inside one XLA
program with ``with_sharding_constraint``; the port's programs take their
splits explicitly, as ``flags.py`` says of ``MOE_SHARD_CONSTRAINTS``.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.analysis import op_costs


def model_size(mesh) -> int:
    return mesh.shape["model"]


def columns(mesh) -> np.ndarray:
    """The mesh's devices as (groups, shards): row g is one batch group,
    column s the devices that hold shard s."""
    axis = mesh.axis_names.index("model")
    return np.moveaxis(mesh.devices, axis, -1).reshape(-1, model_size(mesh))


class RowSharded:
    """S equal row blocks, block s on the devices of mesh column s."""

    def __init__(self, mesh, blocks: Sequence[torch.Tensor]):
        s = model_size(mesh)
        if len(blocks) != s:
            raise ValueError(f"{len(blocks)} blocks for {s} `model` shards")
        shapes = {tuple(b.shape) for b in blocks}
        if len(shapes) > 1:
            raise ValueError(f"blocks must be equal-shape, got {shapes}")
        cols = columns(mesh)
        self.mesh = mesh
        # copies[s][device] = block s on that device
        self.copies: List[dict] = []
        for i, b in enumerate(blocks):
            per = {}
            for dev in cols[:, i]:
                if dev not in per:
                    per[dev] = b.to(dev)
            self.copies.append(per)

    @property
    def blocks(self) -> List[torch.Tensor]:
        """Each shard's block on the first device of its column."""
        return [next(iter(c.values())) for c in self.copies]

    def local(self, shard: int, device) -> torch.Tensor:
        return self.copies[shard][torch.device(device)]

    @property
    def shape(self) -> tuple:
        b = self.blocks[0]
        return (len(self.copies) * b.shape[0],) + tuple(b.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def nbytes(self) -> int:
        """The logical array's bytes (replicas not counted), as the
        reference's ``jax.Array.nbytes``."""
        b = self.blocks[0]
        return len(self.copies) * b.numel() * b.element_size()

    def to_host(self) -> torch.Tensor:
        """The flat ``(S * m, ...)`` array on the CPU (a host copy)."""
        return torch.cat([b.cpu() for b in self.blocks])

    def __array__(self, dtype=None, copy=None):
        a = self.to_host().numpy()
        return a if dtype is None else a.astype(dtype)


def put_row_sharded(mesh, x: torch.Tensor) -> RowSharded:
    """``x`` with its leading dim split over ``model`` (it must divide).
    The split's backward, which assembles ``x``'s gradient from the
    blocks', is counted as work on rows split over ``model``
    (``op_costs.in_split``): the reference keeps that gradient sharded."""
    s = model_size(mesh)
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} rows do not split over {s} shards")
    return RowSharded(mesh, list(op_costs.in_split(
        s, torch.split, x, x.shape[0] // s)))


def row_sharded_from_blocks(mesh, blocks) -> RowSharded:
    """Assemble a ``model``-row-sharded array from per-shard blocks, each
    placed straight on its column's devices (no ``(S * m, ...)`` array is
    ever built; trailing dims are never split)."""
    return RowSharded(mesh, list(blocks))


def _arg(a, shard: int, dev):
    return a.local(shard, dev) if isinstance(a, RowSharded) else a


def on_meta(mesh) -> bool:
    """A mesh of ``meta`` devices (the dry run's)."""
    return all(d.type == "meta" for d in mesh.devices.reshape(-1))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def shard_map(fn: Callable, mesh, *args, batch=None, out: str = "rows"):
    """Run ``fn`` once per shard on the device that owns it.

    ``args`` are ``RowSharded`` (each call gets its shard's block) or
    passed through unchanged. ``out="rows"``: ``fn(*blocks)`` runs once
    per shard on the first device of its column and its result (a tensor)
    becomes block s of a ``RowSharded``. ``out="batch"``: ``batch`` (a
    (Q, ...) tensor) is split into equal parts over the batch groups,
    ``fn(part, *blocks)`` runs on every (group, shard) device and returns
    a tuple of (Q_g, w) tensors; the shards' results sit side by side in
    shard order along axis 1 (an all-gather over ``model``), the groups'
    along axis 0, on ``batch``'s device. On a meta mesh the first program
    stands in for every one (module docstring).
    """
    cols = columns(mesh)
    n_groups, n_shards = cols.shape
    one = on_meta(mesh)
    if out == "rows":
        run = range(1 if one else n_shards)
        blocks = [op_costs.in_shard(
            (0, s), fn, *(_arg(a, s, cols[0, s]) for a in args))
            for s in run]
        return RowSharded(mesh, blocks * n_shards if one else blocks)
    if out != "batch":
        raise ValueError(f"out must be 'rows' or 'batch', got {out!r}")
    if batch.shape[0] % n_groups:
        raise ValueError(f"a batch of {batch.shape[0]} does not split over "
                         f"{n_groups} batch groups")
    home = batch.device
    parts = batch.split(batch.shape[0] // n_groups)
    if one:
        first = op_costs.in_shard((0, 0), fn, parts[0],
                                  *(_arg(a, 0, cols[0, 0]) for a in args))
        out = []
        for o in first:
            m = op_costs.stand_in(op_costs.stand_in(o, n_shards, dim=1),
                                  n_groups, dim=0)
            # every group's merge, as the loop below records them: the
            # common work's split over the groups gives a device its own
            op_costs.record_collective("all-gather", _nbytes(m), n_shards)
            out.append(m)
        return tuple(out)
    groups = []
    for g, part in enumerate(parts):
        per_shard = [
            op_costs.in_shard((g, s), fn, part.to(cols[g, s]),
                              *(_arg(a, s, cols[g, s]) for a in args))
            for s in range(n_shards)]
        with op_costs.suspended():
            merged = [_cat([o[j].to(home) for o in per_shard], dim=1)
                      for j in range(len(per_shard[0]))]
        for m in merged:
            op_costs.record_collective("all-gather", _nbytes(m), n_shards)
        groups.append(merged)
    with op_costs.suspended():
        return tuple(_cat([g_[j] for g_ in groups], dim=0)
                     for j in range(len(groups[0])))


def _cat(parts: List[torch.Tensor], dim: int) -> torch.Tensor:
    """``torch.cat``, except that one part is returned as it is."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def shard_sum(fn: Callable, mesh, *args):
    """Split each tensor of ``args`` evenly on axis 0 over every device of
    the mesh (row-major device order), run ``fn(*parts)`` per device and
    return the sum of the results in device order (the reference's
    ``psum`` over all axes, an all-reduce), on the first device. On a
    meta mesh the first program stands in for every one."""
    devs = list(mesh.devices.reshape(-1))
    n = len(devs)
    for a in args:
        if a.shape[0] % n:
            raise ValueError(f"{a.shape[0]} rows do not split over {n} "
                             f"devices")
    splits = [a.split(a.shape[0] // n) for a in args]
    run = 1 if on_meta(mesh) else n
    outs = [op_costs.in_shard((0, i), fn,
                              *(sp[i].to(devs[i]) for sp in splits))
            for i in range(run)]
    op_costs.record_collective("all-reduce", _nbytes(outs[0]), n)
    if run == 1:
        return outs[0]
    with op_costs.suspended():
        total = outs[0].to(devs[0])
        for o in outs[1:]:
            total = total + o.to(devs[0])
    return total


# ---------------------------------------------------------------------------
# rule machinery
# ---------------------------------------------------------------------------

Spec = Tuple
Rule = Tuple[str, Spec]


def path_str(path) -> str:
    """A path given as a string (returned as is) or a sequence of keys,
    joined with '/'."""
    if isinstance(path, str):
        return path
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def spec_for(rules: List[Rule], path, ndim: int) -> Spec:
    """The first rule matching ``path``, cut to ``ndim`` entries."""
    s = path_str(path)
    for pat, spec in rules:
        if re.search(pat, s):
            return tuple(spec[:ndim])
    return ()


def axes_size(mesh, axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.shape[a]
    return n


def guard(mesh, spec: Spec, shape) -> Spec:
    """The reference's divisibility guard: an entry whose axes do not
    divide its dimension becomes None; the spec is padded to the rank."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if ax is None or shape[d] % axes_size(mesh, ax) == 0
                 else None for d, ax in enumerate(spec))


def shard_shape(spec: Spec, shape, mesh) -> tuple:
    """The per-device shape of a ``shape`` leaf under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n if ax is None else n // axes_size(mesh, ax)
                 for n, ax in zip(shape, spec))


def shard_bytes(spec: Spec, t: torch.Tensor, mesh) -> int:
    return int(np.prod(shard_shape(spec, t.shape, mesh), dtype=np.int64)) \
        * t.element_size()


def _default_path(name: str):
    from repro_torch.carry import reference_path
    return reference_path(name), ()


def tree_shardings(mesh, leaves: Dict[str, torch.Tensor],
                   rules: List[Rule],
                   path_of: Optional[Callable] = None) -> Dict[str, Spec]:
    """{name: spec} of named leaves under ``rules``. ``path_of(name)`` ->
    (reference path, leading dims): a leaf that is a slice of a stacked
    reference leaf is matched and guarded with those dims in front, which
    its spec then drops (default: ``carry.reference_path``, no leading
    dims)."""
    path_of = path_of or _default_path
    out = {}
    for name, t in leaves.items():
        path, lead = path_of(name)
        shape = tuple(lead) + tuple(t.shape)
        spec = guard(mesh, spec_for(rules, path, len(shape)), shape)
        out[name] = spec[len(lead):]
    return out


# ---------------------------------------------------------------------------
# family rules (the reference's, verbatim)
# ---------------------------------------------------------------------------


def lm_rules(mesh) -> List[Rule]:
    # stacked layer params have a leading L axis -> specs shifted by one
    return [
        (r"embed$", ("model", None)),
        (r"lm_head$", (None, "model")),
        # attention (stacked under layers/, unstacked under dense_layers/N/)
        (r"layers.*attn/w[qkv]$", (None, None, "model")),
        (r"layers.*attn/wq_b$", (None, None, "model")),
        (r"layers.*attn/wkv_b$", (None, None, "model")),
        (r"layers.*attn/wo$", (None, "model", None)),
        (r"layers.*attn/b[qkv]$", (None, "model")),
        # MoE experts: EP on model
        (r"layers.*moe/w_(gate|up|down)$", (None, "model", None, None)),
        (r"layers.*moe/shared/w_(gate|up)$", (None, None, "model")),
        (r"layers.*moe/shared/w_down$", (None, "model", None)),
        (r"layers.*moe/router$", ()),
        # dense FFN: TP on model
        (r"layers.*ffn/w_(gate|up)$", (None, None, "model")),
        (r"layers.*ffn/w_down$", (None, "model", None)),
        # dense_layers are unstacked (no leading L): shift left
        (r"dense_layers.*attn/w[qkv]$", (None, "model")),
        (r"dense_layers.*attn/wo$", ("model", None)),
        (r"dense_layers.*(ffn|shared)/w_(gate|up)$", (None, "model")),
        (r"dense_layers.*(ffn|shared)/w_down$", ("model", None)),
        (r"dense_layers.*moe/w_(gate|up|down)$", ("model", None, None)),
        (r".*", ()),
    ]


def recsys_rules(mesh) -> List[Rule]:
    return [
        (r"(^|/)table$", ("model", None)),
        (r"top/layers/0/w$", (None, "model")),
        (r"top/layers/1/w$", ("model", None)),
        (r".*", ()),
    ]


def gnn_rules(mesh) -> List[Rule]:
    return [(r".*", ())]


def family_rules(family: str, mesh) -> List[Rule]:
    return {"lm": lm_rules, "recsys": recsys_rules,
            "gnn": gnn_rules}[family](mesh)


def lm_param_shardings(mesh, model, cfg) -> Dict[str, Spec]:
    """{port parameter name: spec} of a ``TransformerLM`` under
    ``lm_rules``: each layer as its slice of the reference's stacked leaf
    (``carry.lm_reference_path``)."""
    from repro_torch.carry import lm_reference_path
    return tree_shardings(mesh, dict(model.named_parameters()),
                          lm_rules(mesh),
                          lambda n: lm_reference_path(n, cfg))


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def lm_batch_sharding(mesh, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, Spec]:
    b = batch_axes(mesh)
    return {k: (b,) + (None,) * (x.dim() - 1) for k, x in batch.items()}


def kv_cache_sharding(mesh, cache, cfg) -> Dict[str, Spec]:
    """Cache (L, B, S, ...) : batch on the data axes; GQA kv-head dim on
    model when divisible, else the sequence dim. ``cache``: a ``KVCache``
    or a {name: tensor} dict."""
    b = batch_axes(mesh)
    items = cache._asdict() if hasattr(cache, "_asdict") else cache

    def one(x):
        if x.dim() == 5:                        # (L, B, S, KV, hd)
            if x.shape[3] % mesh.shape["model"] == 0:
                return (None, b, None, "model", None)
            return (None, b, "model", None, None)
        if x.dim() == 4:                        # (L, B, S, r) MLA latent
            return (None, b, "model", None)
        return (b,)                             # lengths (B,)
    return {k: one(x) for k, x in items.items()}


_GNN_EDGE = re.compile(r"src|dst|edge_mask|t_kj|t_ji")


def gnn_batch_sharding(mesh, graph: Dict[str, torch.Tensor]
                       ) -> Dict[str, Spec]:
    """Edges/triplets sharded across ALL axes; nodes replicated."""
    every = tuple(mesh.axis_names)
    out = {}
    for name, x in graph.items():
        if _GNN_EDGE.search(name):
            ax = every if x.shape[0] % axes_size(mesh, every) == 0 else None
            out[name] = (ax,) + (None,) * (x.dim() - 1)
        else:
            out[name] = (None,) * x.dim()
    return out


def recsys_batch_sharding(mesh, batch) -> dict:
    """The batch's leading dim on the data axes where they divide it;
    ``batch``'s structure kept (``sparse_ids`` is a list)."""
    b = batch_axes(mesh)

    def one(x):
        if x.dim() == 0:
            return ()
        ok = x.shape[0] % axes_size(mesh, b) == 0
        return (b if ok else None,) + (None,) * (x.dim() - 1)
    return {k: [one(x) for x in v] if isinstance(v, list) else one(v)
            for k, v in batch.items()}


def zero1_shardings(mesh, param_shardings, opt_state) -> dict:
    """ZeRO-1: shard optimizer moments' leading dim over DP axes when it
    divides evenly (``opt_state``: {"m": {name: t}, "v": ..., "step"})."""
    b = batch_axes(mesh)
    dp = axes_size(mesh, b)

    def one(x):
        if x.dim() >= 1 and x.shape[0] % dp == 0:
            return (b,) + (None,) * (x.dim() - 1)
        return ()
    return {k: ({n: one(x) for n, x in v.items()} if isinstance(v, dict)
                else one(v)) for k, v in opt_state.items()}


def batch_seq_spec(mesh, shape, batch_dim: int = 0,
                   seq_dim: Optional[int] = None) -> Spec:
    """The reference's ``shard_batch_seq`` rule for a ``shape`` tensor: the
    batch dim over the data axes, ``seq_dim`` (if given) over ``model``,
    each only where it divides."""
    b = batch_axes(mesh)
    spec = [None] * len(shape)
    if shape[batch_dim] % axes_size(mesh, b) == 0:
        spec[batch_dim] = b
    if seq_dim is not None and shape[seq_dim] % model_size(mesh) == 0:
        spec[seq_dim] = "model"
    return tuple(spec)


def record_grad_allreduce(mesh, grads: Dict[str, torch.Tensor],
                          specs: Dict[str, Spec],
                          work_axes: Tuple[str, ...]) -> None:
    """Price the reference's all-reduce of the weights' gradients: gradient
    n at its per-device bytes under ``specs[n]``, over the ``work_axes``
    that spec leaves unsharded (none left: no collective)."""
    for n, g in grads.items():
        used = {a for e in specs[n] if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        over = tuple(a for a in work_axes if a not in used)
        op_costs.record_collective("all-reduce", shard_bytes(specs[n], g,
                                                             mesh),
                                   axes_size(mesh, over))


# ---------------------------------------------------------------------------
# the tensor-parallel LM's weights and cache
# ---------------------------------------------------------------------------


def _model_dim(spec: Spec) -> Optional[int]:
    """The dimension a spec splits over ``model`` (None: replicated)."""
    for d, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return d
    return None


def _block(t: torch.Tensor, dim: Optional[int], s: int, n: int):
    return t if dim is None else t.narrow(dim, s * (t.shape[dim] // n),
                                          t.shape[dim] // n)


class ShardedLM(nn.Module):
    """A ``TransformerLM`` split over a mesh's ``model`` axis:
    ``shards[s]`` is a ``TransformerLM`` of shard s's slices (its column
    block of ``wq``, its rows of ``embed`` and ``wo`` ...), on the device of
    mesh column s, and a replicated parameter is the one leaf every shard
    module holds, so ``named_parameters()`` lists each leaf once.
    ``dims[name]``: the dimension that name's parameter splits over
    ``model`` (None: replicated)."""

    def __init__(self, cfg, mesh, shards, dims: Dict[str, Optional[int]]):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.shards = nn.ModuleList(shards)
        self.dims = dims

    def split(self, name: str) -> bool:
        return self.dims[name] is not None

    def device_names(self) -> List[str]:
        """The names of one device's leaves: shard 0's, replicated ones
        included."""
        return [f"shards.0.{n}" for n in self.dims]


def _set_param(module: nn.Module, name: str, param: nn.Parameter) -> None:
    *path, leaf = name.split(".")
    owner = module
    for k in path:
        owner = owner[int(k)] if k.isdigit() else getattr(owner, k)
    if isinstance(owner, nn.ParameterDict):
        owner[leaf] = param
    else:
        setattr(owner, leaf, param)


def shard_lm(model, mesh) -> ShardedLM:
    """``model`` (a ``TransformerLM``) split as ``lm_param_shardings``
    gives each parameter's spec, a dimension that does not divide
    replicated (the reference's guard). A shard's slice is a view of
    ``model``'s parameter where it already lies on the shard's device (an
    update of one is an update of the other), else a copy. Every device of
    a mesh column must be one device: a column's batch groups share its
    slices."""
    from repro_torch.carry import lm_from_named
    cfg = model.cfg
    cols = columns(mesh)
    for s in range(cols.shape[1]):
        if len(set(cols[:, s])) != 1:
            raise ValueError(f"mesh column {s} names several devices "
                             f"{sorted(map(str, set(cols[:, s])))}")
    n = model_size(mesh)
    specs = lm_param_shardings(mesh, model, cfg)
    dims = {name: _model_dim(spec) for name, spec in specs.items()}
    params = dict(model.named_parameters())
    shards = []
    for s in range(n):
        dev = cols[0, s]
        shards.append({name: nn.Parameter(
            _block(p.detach(), dims[name], s, n).to(dev),
            requires_grad=p.requires_grad) for name, p in params.items()})
    modules = [lm_from_named(named, cfg) for named in shards]
    first = dict(modules[0].named_parameters())
    for m in modules[1:]:
        for name, d in dims.items():
            if d is None:
                _set_param(m, name, first[name])
    return ShardedLM(cfg, mesh, modules, dims)


def unshard_lm(sharded: ShardedLM):
    """The ``TransformerLM`` a ``ShardedLM`` splits, its slices joined on
    shard 0's device (new tensors)."""
    from repro_torch.carry import lm_from_named
    dev = sharded.mesh.devices.reshape(-1)[0]
    per = [dict(m.named_parameters(remove_duplicate=False))
           for m in sharded.shards]
    named = {}
    for name, d in sharded.dims.items():
        if d is None:
            named[name] = per[0][name].detach().clone()
        else:
            named[name] = torch.cat([p[name].detach().to(dev) for p in per],
                                    dim=d)
    return lm_from_named(named, sharded.cfg)


class ShardedKVCache(NamedTuple):
    """A KV cache split as ``kv_cache_sharding`` says: ``blocks[g][s]`` =
    (a, b), batch group g's rows of the (Lyr, B, Smax, KV, hd) cache on
    device (g, s), their KV heads split over ``model`` or their positions
    (``cache_split``), or of an MLA cache's latent c_kv (Lyr, B, Smax, r)
    and rope key (Lyr, B, Smax, rd), their positions split; ``length``
    (B,) on the mesh's first device."""
    blocks: list
    length: torch.Tensor


def cache_split(cfg, mesh) -> str:
    """``kv_cache_sharding``'s choice: "heads" when the KV heads divide over
    ``model``, else "seq"; an MLA latent cache always "seq"."""
    if cfg.use_mla:
        return "seq"
    return "heads" if cfg.n_kv_heads % model_size(mesh) == 0 else "seq"


def init_sharded_cache(cfg, mesh, batch: int, max_len: int,
                       dtype: torch.dtype) -> ShardedKVCache:
    """A zero cache of ``batch`` rows and ``max_len`` positions split over
    ``mesh`` (each block allocated as its device's work)."""
    cols = columns(mesh)
    n_groups, n = cols.shape
    split = cache_split(cfg, mesh)
    for what, size, by in (("batch", batch, n_groups),
                           ("cache length", max_len, n if split == "seq"
                            else 1)):
        if size % by:
            raise ValueError(f"a {what} of {size} does not split over {by}")
    kv = cfg.n_kv_heads // n if split == "heads" else cfg.n_kv_heads
    seq = max_len // n if split == "seq" else max_len
    lead = (cfg.n_layers, batch // n_groups, seq)
    if cfg.use_mla:                 # the latent c_kv and the rope key
        shapes = (lead + (cfg.kv_lora_rank,), lead + (cfg.qk_rope_head_dim,))
    else:
        shapes = (lead + (kv, cfg.head_dim),) * 2

    def zeros(dev):
        return tuple(torch.zeros(sh, dtype=dtype, device=dev)
                     for sh in shapes)

    blocks = [[op_costs.in_shard((g, s), zeros, cols[g, s])
               for s in range(n)] for g in range(n_groups)]
    length = torch.zeros((batch,), dtype=torch.int32, device=cols[0, 0])
    return ShardedKVCache(blocks, length)
