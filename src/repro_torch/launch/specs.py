"""Dry-run cell builders (the reference's ``launch/specs.py``): for every
(arch x shape x mesh), the port's real step and its arguments.

``build_cell(arch, shape, mesh, device="meta")`` returns a ``Cell`` whose
``fn(*args)`` is the step the system runs for that cell: training cells
the train step (the LM's with the reference's microbatch rule and
``adamw(3e-4)``, the GNN's edge-partition loss, recsys with the row-sharded
lookup and ``mixed_optimizer``), prefill and decode cells the LM serve
steps (decode: one token against a full cache), serve / retrieval cells
the scoring steps, the ANN cells the sharded fixed-beam search
(``mode="fori"``) and the sharded brute-force kNN pass. On ``meta`` the
weights and inputs are shapes alone (nothing is allocated: the port's
counterpart of the reference's ``ShapeDtypeStruct`` args); on a card they
are made from ``seed`` by the port's own generators (random init,
``data.synthetic``, ``data.graph_sampler``).

The reference attaches shardings to one XLA program; the port runs one
process over its ``Mesh``. So a cell carries:

  * ``arg_bytes``: the arguments' bytes per device under the reference's
    rules (``distributed.sharding``): parameters, ZeRO-1 moments
    (``_opt_specs``), ``LM_FSDP``, batch, cache and index rows;
  * ``outside_split``: how the counter divides the work outside the
    shard programs over the devices (``analysis.op_costs``). The GNN,
    recsys and ANN cells run their real per-shard programs (the edge
    partition, the row-sharded lookup, the per-shard searches); the rest
    of a recsys or ANN step runs on the batch the reference splits over
    the data axes (``dp`` devices). The LMs run their tensor- and
    expert-parallel programs (``sharding.shard_lm``, ``mesh=`` on the
    steps): one per batch group, its shards' work and its collectives
    counted per device;
  * ``row_split``: (tensor, n) pairs the counter places (``op_costs.
    CostCounter.place``): a recsys table and its row accumulator, whose
    rows the rule ``model`` splits. The table's dense gradient (the
    lookup's ``put_row_sharded`` split, run backwards), the clip's sum
    over it and the row-wise Adagrad update are counted per device over
    ``model``, as the accumulator's bytes in ``arg_bytes`` are. A
    tensor-parallel LM's leaves and AdamW moments: a shard's slice over
    the mesh size (its ``model`` share, then ZeRO-1's over the data
    axes), a replicated leaf over the data axes.

A train cell also prices the reference's all-reduce of the weights'
gradients over the axes that split the step's work (recsys and the LMs:
the batch axes; dimenet: every axis, its edges and triplets split over the
whole mesh), once per step between the backward and the optimizer
(``_reduce_grads``; the LM's train step with its ``mesh``): each gradient
at its per-device bytes under its spec, over those of the axes its spec
leaves unsharded.

``model_flops`` are the reference's analytic formulas, copied as they
are.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch import flags
from repro_torch.analysis import op_costs
from repro_torch.analysis.roofline import lm_model_flops
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.distributed import ShardedIndexArrays, \
    input_specs_for_search, make_search_step, make_sharded_l2_topk, \
    row_norms
from repro_torch.distributed import sharding as SH
from repro_torch.models import dimenet, recsys, transformer
from repro_torch.models.recsys_common import make_sharded_lookup, \
    padded_rows
from repro_torch.optim import Optimizer, adamw, mixed_optimizer
from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step, \
    recsys_retrieval_step, recsys_score_step
from repro_torch.train.train_step import loss_fn_for, make_train_step


@dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: tuple
    kind: str
    model_flops: float = 0.0
    notes: str = ""
    arg_bytes: int = 0            # per device, under the rules
    outside_split: int = 1        # analysis.op_costs.CostCounter's
    partition: str = "shards"     # every cell runs its shards' programs
    row_split: tuple = ()         # (tensor, n): CostCounter.place


# ---------------------------------------------------------------- helpers
def _dp(mesh) -> Tuple[str, ...]:
    return SH.batch_axes(mesh)


def _dp_size(mesh) -> int:
    return SH.axes_size(mesh, _dp(mesh))


def _gen(device, seed: int) -> torch.Generator:
    """A CPU generator for meta (whose draws are free), else one on the
    device."""
    dev = torch.device(device)
    return torch.Generator("cpu" if dev.type == "meta" else dev) \
        .manual_seed(seed)


def _init_dev(device):
    """``device=`` for an init: meta explicitly, else the generator's."""
    return device if torch.device(device).type == "meta" else None


def _spec_bytes(mesh, pairs) -> int:
    """Per-device bytes of (tensor, spec) pairs."""
    return sum(SH.shard_bytes(spec, t, mesh) for t, spec in pairs)


def _add_dp(spec, shape, dp, dp_n) -> tuple:
    """Add the DP axes to the first unsharded, divisible dim (ZeRO/FSDP).
    No-op if any DP axis is already used (a mesh axis may appear once)."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            used.add(a)
    if any(a in used for a in dp):
        return tuple(spec)
    for d in range(len(shape)):
        if spec[d] is None and shape[d] % dp_n == 0 and shape[d] >= dp_n:
            spec[d] = dp
            break
    return tuple(spec)


def _opt_specs(mesh, param_specs: dict, params: dict) -> dict:
    """AdamW moments: the param's spec + ZeRO-1 over DP on the first
    divisible unsharded dim."""
    dp, dp_n = _dp(mesh), _dp_size(mesh)
    return {n: _add_dp(param_specs[n], tuple(p.shape), dp, dp_n)
            for n, p in params.items()}


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _reduce_grads(opt: Optimizer, mesh, specs: Dict[str, tuple],
                  work_axes: Tuple[str, ...]) -> Optimizer:
    """``opt``, whose update first prices the reference's all-reduce of
    the gradients (module docstring): gradient n at its per-device bytes
    under ``specs[n]``, over the ``work_axes`` that spec leaves unsharded
    (none left: no collective), as work every device does once."""
    def update(grads, state, params):
        op_costs.in_split(1, SH.record_grad_allreduce, mesh, grads, specs,
                          work_axes)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


# ===========================================================================
# LM cells
# ===========================================================================


def _lm_arg_specs(mesh, model, cfg) -> dict:
    """{name: (stacked shape, param spec, moment spec)}: each LM leaf as
    its slice of the reference's stacked leaf (``carry.lm_reference_
    path``), the specs on the stacked shape: the rules' (with ``LM_FSDP``:
    the DP axes added to a leaf of >= 32 MiB), and the moment's ZeRO-1
    over DP on the first divisible unsharded dim, the layer axis
    first."""
    from repro_torch.carry import lm_reference_path
    specs = SH.lm_param_shardings(mesh, model, cfg)
    dp, dp_n = _dp(mesh), _dp_size(mesh)
    out = {}
    for n, p in model.named_parameters():
        lead = lm_reference_path(n, cfg)[1]
        shape = tuple(lead) + tuple(p.shape)
        ps = (None,) * len(lead) + tuple(specs[n])
        if flags.LM_FSDP and math.prod(shape) * p.element_size() >= 32 << 20:
            ps = _add_dp(ps, shape, dp, dp_n)
        out[n] = (shape, ps, _add_dp(ps, shape, dp, dp_n))
    return out


def _slice_bytes(mesh, shape: tuple, spec: tuple, t: torch.Tensor) -> int:
    """Per-device bytes of ``t``, one slice of a stacked ``shape`` leaf
    under ``spec``: the stacked leaf's per-device bytes over its slices
    (so the L port leaves of one reference leaf sum to its bytes)."""
    per = math.prod(SH.shard_shape(spec, shape, mesh)) * t.element_size()
    return per * t.numel() // math.prod(shape)


def _lm_cell(spec, shape: ShapeConfig, mesh, device, seed: int) -> Cell:
    cfg = spec.config
    dp_n = _dp_size(mesh)
    g = _gen(device, seed)
    model = transformer.init_params(g, cfg, device=_init_dev(device))
    params = dict(model.named_parameters())
    specs = _lm_arg_specs(mesh, model, cfg)
    param_bytes = sum(_slice_bytes(mesh, *specs[n][:2], p)
                      for n, p in params.items())
    mf = lm_model_flops(cfg, shape, shape.kind)
    dp = _dp(mesh)
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device(device).type == "meta"
    # the tensor- and expert-parallel programs on the model's slices
    model = SH.shard_lm(model, mesh)

    def tokens(shape_):
        if meta:
            return _empty(shape_, torch.int32, device)
        return torch.randint(0, cfg.vocab_size, shape_, generator=g,
                             device=device, dtype=torch.int32)

    if shape.kind == "train":
        opt = adamw(3e-4)
        opt_state = opt.init(model)
        per_dev = shape.global_batch // dp_n
        micro = per_dev if cfg.d_model >= 4096 else max(1, per_dev // 4)
        step = make_train_step(loss_fn_for("lm", cfg, mesh=mesh), opt,
                               microbatches=micro, mesh=mesh)
        t = tokens((b, s))
        batch = {"tokens": t, "labels": torch.roll(t, -1, dims=1)}
        moment_bytes = 2 * sum(          # AdamW's moments are float32
            _slice_bytes(mesh, specs[n][0], specs[n][2],
                         _empty(p.shape, torch.float32, "meta"))
            for n, p in params.items())
        batch_bytes = _spec_bytes(mesh, ((x, (dp, None))
                                         for x in batch.values()))
        notes = f"microbatches={micro}, ZeRO-1 moments"
        if flags.LM_FSDP:
            notes += ", FSDP"
        if flags.GRAD_SHARD_CONSTRAINTS:
            notes += ", grad shardings (no placement in one process)"
        notes += "; gradients all-reduced over the batch axes"
        return Cell(spec.arch_id, shape.name, step,
                    (model, opt_state, batch), "train", mf, notes=notes,
                    arg_bytes=param_bytes + moment_bytes + 4 + batch_bytes,
                    row_split=_lm_placed(model, opt_state, mesh))

    if shape.kind == "prefill":
        t = tokens((b, s))
        return Cell(spec.arch_id, shape.name, lm_prefill_step(cfg, mesh),
                    (model, t), "prefill", mf,
                    notes="chunked (flash) attention",
                    arg_bytes=param_bytes + SH.shard_bytes((dp, None), t,
                                                           mesh))

    # decode: one token against a seq_len KV cache
    shapes = _cache_shapes(cfg, b, s)
    cache_specs = SH.kv_cache_sharding(mesh, dict(zip(
        ("a", "b", "length"), (_empty(x.shape, x.dtype, "meta")
                               for x in shapes))), cfg)
    cache_bytes = _spec_bytes(mesh, ((_empty(x.shape, x.dtype, "meta"),
                                      cache_specs[k]) for k, x in
                                     zip(("a", "b", "length"), shapes)))
    cache = SH.init_sharded_cache(cfg, mesh, b, s, shapes[0].dtype)
    tok = tokens((b,))
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=device) \
        if not meta else _empty((b,), torch.int32, device)
    notes = "absorbed-MLA latent cache" if cfg.use_mla else \
        "KV cache seq-sharded on model"
    return Cell(spec.arch_id, shape.name, lm_decode_step(cfg, mesh),
                (model, tok, cache, pos), "decode", mf, notes=notes,
                arg_bytes=param_bytes + cache_bytes + _spec_bytes(
                    mesh, ((tok, (dp,)), (pos, (dp,)))))


def _lm_placed(model, opt_state, mesh) -> tuple:
    """A ``ShardedLM``'s leaves and their AdamW moments, each with the
    devices its update is counted over (the ``row_split`` docstring)."""
    dims = {n: model.split(n.split(".", 2)[2])
            for n, _ in model.named_parameters()}
    out = []
    for n, p in model.named_parameters():
        k = mesh.size if dims[n] else _dp_size(mesh)
        out.extend((t, k) for t in (p, opt_state["m"][n],
                                    opt_state["v"][n]))
    return tuple(out)


def _cache_shapes(cfg, b: int, s: int):
    """``init_cache``'s three tensors as (shape, dtype) stand-ins."""
    from types import SimpleNamespace as NS
    from repro_torch.models.layers import lm_dtype
    dt = lm_dtype(cfg)
    lead = (cfg.n_layers, b, s)
    if cfg.use_mla:
        a, c = lead + (cfg.kv_lora_rank,), lead + (cfg.qk_rope_head_dim,)
    else:
        a = c = lead + (cfg.n_kv_heads, cfg.head_dim)
    return (NS(shape=a, dtype=dt), NS(shape=c, dtype=dt),
            NS(shape=(b,), dtype=torch.int32))


# ===========================================================================
# GNN cells
# ===========================================================================

EDGE_KEYS = ("src", "dst", "edge_mask", "t_kj", "t_ji")


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def gnn_graph_shapes(shape: ShapeConfig, mesh) -> Dict[str, tuple]:
    """{key: (shape, dtype)} of the cell's graph: edges and triplets
    padded to the mesh size; molecule as ``n_graphs`` copies of its
    graph."""
    n_sh = mesh.size
    if shape.name == "molecule":
        n_nodes = shape.n_nodes * shape.n_graphs
        n_edges = _pad_to(shape.n_edges * shape.n_graphs, n_sh)
        n_tri = _pad_to(shape.n_triplets * shape.n_graphs, n_sh)
        n_graphs = shape.n_graphs
    else:
        n_nodes = shape.n_nodes
        n_edges = _pad_to(shape.n_edges, n_sh)
        n_tri = _pad_to(shape.n_triplets, n_sh)
        n_graphs = 1
    i32, f32, b1 = torch.int32, torch.float32, torch.bool
    g = {"pos": ((n_nodes, 3), f32), "src": ((n_edges,), i32),
         "dst": ((n_edges,), i32), "edge_mask": ((n_edges,), b1),
         "t_kj": ((n_tri,), i32), "t_ji": ((n_tri,), i32),
         "node_mask": ((n_nodes,), b1), "graph_id": ((n_nodes,), i32)}
    if shape.d_feat:
        g["x"] = ((n_nodes, shape.d_feat), f32)
    else:
        g["z"] = ((n_nodes,), i32)
    if shape.name == "molecule":
        g["y_graph"] = ((n_graphs,), f32)
    else:
        g["y_node"] = ((n_nodes,), f32)
    return g


def _gnn_graph(shape: ShapeConfig, mesh, device, seed: int) -> dict:
    """The cell's graph: shapes alone on meta; on a card the batch
    ``data.graph_sampler`` makes from ``seed`` (minibatch_lg through the
    fan-out sampler), edges and triplets padded to the mesh (-1 / False)."""
    from repro_torch.data import graph_sampler as G
    want = gnn_graph_shapes(shape, mesh)
    if torch.device(device).type == "meta":
        return {k: _empty(s, dt, device) for k, (s, dt) in want.items()}
    if shape.name == "minibatch_lg":
        host = G.sampled_dimenet_batch(seed, shape)
    elif shape.name == "molecule":
        host = G.make_dimenet_batch(
            seed, n_nodes=shape.n_nodes * shape.n_graphs,
            n_edges=shape.n_edges * shape.n_graphs,
            n_triplets=shape.n_triplets * shape.n_graphs,
            n_graphs=shape.n_graphs)
    else:
        host = G.make_dimenet_batch(seed, shape.n_nodes, shape.n_edges,
                                    shape.n_triplets, d_feat=shape.d_feat,
                                    node_targets=True)
    graph = G.graph_to_device({k: host[k] for k in want}, device)
    for k in EDGE_KEYS:
        n = want[k][0][0] - graph[k].shape[0]
        if n:
            fill = False if k == "edge_mask" else \
                (0 if k in ("src", "dst") else -1)
            graph[k] = torch.cat([graph[k], torch.full(
                (n,), fill, dtype=graph[k].dtype, device=device)])
    for k, (s, dt) in want.items():
        if tuple(graph[k].shape) != s or graph[k].dtype != dt:
            raise ValueError(f"{shape.name}: {k} {tuple(graph[k].shape)} "
                             f"{graph[k].dtype}, the cell has {s} {dt}")
    return graph


def make_gnn_loss(cfg, mesh):
    """Edge-partition distributed loss: edges and triplets split over
    every device of the mesh, nodes replicated, the shards' node partials
    summed once (``sharding.shard_sum``: the reference's psum over all
    axes), then the readout on every device. Triplet ids are shard-local
    by construction (``graph_sampler.build_triplets_sharded``)."""
    def sharded_loss(model, graph):
        nodes = {k: v for k, v in graph.items() if k not in EDGE_KEYS}

        def local(*edges):
            return dimenet.node_messages(model, cfg,
                                         {**nodes, **dict(zip(EDGE_KEYS,
                                                              edges))})
        acc = SH.shard_sum(local, mesh, *(graph[k] for k in EDGE_KEYS))
        return dimenet.loss_of(graph, *dimenet.readout(model, graph, acc))

    return sharded_loss


def _gnn_cell(spec, shape: ShapeConfig, mesh, device, seed: int) -> Cell:
    cfg = spec.config
    g = _gen(device, seed)
    model = dimenet.init_params(g, cfg, d_feat=shape.d_feat,
                                device=_init_dev(device))
    params = dict(model.named_parameters())
    param_specs = SH.tree_shardings(mesh, params, SH.gnn_rules(mesh))
    opt = adamw(1e-3)
    opt_state = opt.init(model)
    moment_specs = _opt_specs(mesh, param_specs, params)
    step = make_train_step(make_gnn_loss(cfg, mesh), _reduce_grads(
        opt, mesh, param_specs, tuple(mesh.axis_names)))
    graph = _gnn_graph(shape, mesh, device, seed)
    g_specs = SH.gnn_batch_sharding(mesh, graph)
    arg_bytes = _spec_bytes(mesh, ((p, param_specs[n])
                                   for n, p in params.items())) \
        + 2 * _spec_bytes(mesh, ((p, moment_specs[n])
                                 for n, p in params.items())) + 4 \
        + _spec_bytes(mesh, ((x, g_specs[k]) for k, x in graph.items()))
    # model flops ~ triplet bilinear + edge MLPs (analytic, f32)
    h, nb = cfg.d_hidden, cfg.n_bilinear
    tri_flops = 2.0 * graph["t_kj"].shape[0] * (nb * h * h + nb * h)
    edge_flops = 2.0 * graph["src"].shape[0] * (6 * h * h)
    mf = 3.0 * cfg.n_blocks * (tri_flops + edge_flops)   # fwd+bwd
    return Cell(spec.arch_id, shape.name, step, (model, opt_state, graph),
                "train", mf,
                notes="edge-partition shard_sum; shard-local triplets; "
                      "gradients all-reduced over every axis",
                arg_bytes=arg_bytes, outside_split=1)


# ===========================================================================
# Recsys cells
# ===========================================================================


def _recsys_batch(cfg, batch: int, device, seed: int) -> Dict[str, Any]:
    """The reference's batch specs: shapes alone on meta, else
    ``data.synthetic.recsys_batch`` from ``seed``."""
    if torch.device(device).type != "meta":
        from repro_torch.data import recsys_batch
        return recsys_batch(_gen(device, seed + 1), batch, cfg)
    multi_hot = cfg.multi_hot or (1,) * cfg.n_sparse
    i32, f32 = torch.int32, torch.float32
    b: Dict[str, Any] = {
        "sparse_ids": [_empty((batch, m), i32, device) for m in multi_hot]}
    if cfg.n_dense:
        b["dense"] = _empty((batch, cfg.n_dense), f32, device)
    if cfg.seq_len and cfg.interaction in ("self-attn-seq", "target-attn"):
        b["history"] = _empty((batch, cfg.seq_len), i32, device)
        b["history_len"] = _empty((batch,), i32, device)
        b["target"] = _empty((batch,), i32, device)
    b["label"] = _empty((batch,), f32, device)
    return b


def _batch_bytes(mesh, batch: dict) -> int:
    specs = SH.recsys_batch_sharding(mesh, batch)
    pairs: List = []
    for k, v in batch.items():
        if isinstance(v, list):
            pairs.extend(zip(v, specs[k]))
        else:
            pairs.append((v, specs[k]))
    return _spec_bytes(mesh, pairs)


def _recsys_cell(spec, shape: ShapeConfig, mesh, device, seed: int) -> Cell:
    cfg = spec.config
    dp = _dp(mesh)
    fam = recsys.family_of(cfg)
    lookup = make_sharded_lookup(mesh, padded_rows(cfg.table_vocabs))
    g = _gen(device, seed)
    model = recsys.INIT[fam](g, cfg, device=_init_dev(device))
    params = dict(model.named_parameters())
    param_specs = SH.tree_shardings(mesh, params, SH.recsys_rules(mesh))
    param_bytes = _spec_bytes(mesh, ((p, param_specs[n])
                                     for n, p in params.items()))
    common = dict(outside_split=_dp_size(mesh))
    # analytic flops: lookups + mlps (order of magnitude, fwd only)
    d = cfg.embed_dim
    b = _recsys_batch(cfg, shape.batch, device, seed)

    if shape.kind == "train":
        opt = mixed_optimizer(1e-3)
        opt_state = opt.init(model)
        # the tables' row accumulators follow the rows; dense moments
        # replicated
        opt_bytes = sum(
            SH.shard_bytes(("model",) if k == "acc" else (), x, mesh)
            for leaf in opt_state["leaves"].values()
            for k, x in leaf.items()) + 4
        step = make_train_step(
            loss_fn_for("recsys", cfg, lookup_fn=lookup),
            _reduce_grads(opt, mesh, param_specs, dp))
        # a table and its accumulator: rows over the table's row rule
        row_split = tuple(
            (t, SH.axes_size(mesh, param_specs[n][0] or ()))
            for n, leaf in opt_state["leaves"].items() if "acc" in leaf
            for t in (params[n], leaf["acc"]))
        mf = 6.0 * shape.batch * (cfg.n_sparse + 10) * d * d
        return Cell(spec.arch_id, shape.name, step, (model, opt_state, b),
                    "train", mf,
                    notes="row-sharded tables (shard psum) + "
                          "rowwise-adagrad over model; gradients "
                          "all-reduced over the batch axes",
                    arg_bytes=param_bytes + opt_bytes
                    + _batch_bytes(mesh, b), row_split=row_split,
                    **common)

    if shape.kind == "serve":
        step = recsys_score_step(cfg, lookup_fn=lookup)
        mf = 2.0 * shape.batch * (cfg.n_sparse + 10) * d * d
        return Cell(spec.arch_id, shape.name, step, (model, b), "serve", mf,
                    arg_bytes=param_bytes + _batch_bytes(mesh, b), **common)

    # retrieval_cand: 1 query x 1M candidates
    step = recsys_retrieval_step(cfg, k=10, lookup_fn=lookup)
    if torch.device(device).type == "meta":
        cand = _empty((shape.n_candidates,), torch.int32, device)
    else:
        cand = torch.randint(0, cfg.table_vocabs[0], (shape.n_candidates,),
                             generator=g, device=device, dtype=torch.int32)
    mf = 2.0 * shape.n_candidates * d * d * 4
    return Cell(spec.arch_id, shape.name, step, (model, b, cand),
                "retrieval", mf,
                arg_bytes=param_bytes + _batch_bytes(mesh, b)
                + SH.shard_bytes((dp,), cand, mesh), **common)


# ===========================================================================
# ANN cells (the paper's own serving workload)
# ===========================================================================

_ANN_FILL_ROWS = 1 << 20       # rows drawn at a time on a card

_ANN_ROWS = {"base": ("model", None), "neighbors": ("model", None),
             "global_ids": ("model",), "centroids": ("model", None),
             "members": ("model",), "pca_mean": (),
             "pca_comp": (None, None), "base_norms": ("model",)}


def _ann_arrays(sp: dict, device, seed: int, n_shards: int) -> dict:
    """``input_specs_for_search``'s (meta) tensors: as they are for a meta
    cell; for a card, tensors of their shapes filled from ``seed``: random
    rows (drawn in blocks: no second full-size array), each row's
    neighbours uniform local ids of its shard, the entry members likewise,
    a random projection, the rows' norms."""
    arr = sp["arrays"]
    flat = {f: getattr(arr, f) for f in _ANN_ROWS}
    if torch.device(device).type == "meta":
        return {"queries": sp["queries"], **flat}
    g = _gen(device, seed)
    m = flat["base"].shape[0] // n_shards

    def ints(hi, like):
        return torch.randint(0, hi, like.shape, generator=g, device=device,
                             dtype=torch.int32)

    base = torch.empty(flat["base"].shape, dtype=flat["base"].dtype,
                       device=device)
    norms = torch.empty(flat["base_norms"].shape, device=device)
    for lo in range(0, base.shape[0], _ANN_FILL_ROWS):   # no full-size temp
        hi = min(lo + _ANN_FILL_ROWS, base.shape[0])
        rows = torch.randn((hi - lo, base.shape[1]), generator=g,
                           device=device)
        base[lo:hi] = rows
        norms[lo:hi] = row_norms(rows)         # of the f32 rows
    out = {
        "queries": torch.randn(sp["queries"].shape, generator=g,
                               device=device),
        "base": base,
        "neighbors": ints(m, flat["neighbors"]),
        "global_ids": torch.arange(flat["global_ids"].shape[0],
                                   dtype=torch.int32, device=device),
        "centroids": torch.randn(flat["centroids"].shape, generator=g,
                                 device=device),
        "members": ints(m, flat["members"]),
        "pca_mean": torch.zeros(flat["pca_mean"].shape, device=device),
        "pca_comp": torch.randn(flat["pca_comp"].shape, generator=g,
                                device=device)
        * flat["pca_comp"].shape[0] ** -0.5,
        "base_norms": norms,
    }
    return out


def _ann_cell(spec, shape: ShapeConfig, mesh, device, seed: int) -> Cell:
    cfg = spec.config
    n_shards = mesh.shape["model"]
    dp = _dp(mesh)
    common = dict(outside_split=_dp_size(mesh))
    if shape.kind == "retrieval":
        step = make_search_step(mesh, ef=cfg.ef_search, k=cfg.k,
                                mode="fori")
        sp = input_specs_for_search(cfg, shape.batch, shape.n_candidates,
                                    n_shards)           # shapes, on meta
        t = _ann_arrays(sp, device, seed, n_shards)
        arg_bytes = SH.shard_bytes((dp, None), t["queries"], mesh) + sum(
            SH.shard_bytes(_ANN_ROWS[f], t[f], mesh) for f in _ANN_ROWS)
        rows = {f: (SH.put_row_sharded(mesh, t[f])
                    if _ANN_ROWS[f][:1] == ("model",) else t[f])
                for f in _ANN_ROWS}
        del t["base"]
        arrays = ShardedIndexArrays(**rows)
        # beam: max_iters expansions x R gathered rows x D dims per query
        mf = (2.0 * shape.batch * 4 * cfg.ef_search * cfg.graph_degree
              * cfg.pca_dim)
        return Cell(spec.arch_id, shape.name, step, (t["queries"], arrays),
                    "retrieval", mf,
                    notes=f"{n_shards} sub-graphs, fixed-beam fori, "
                          f"ef={cfg.ef_search}",
                    arg_bytes=arg_bytes, **common)
    # build_knn: the sharded brute-force distance pass of the index build
    fn = make_sharded_l2_topk(mesh, k=cfg.build_knn_k)
    meta = torch.device(device).type == "meta"
    g = _gen(device, seed)

    def rows(n):
        if meta:
            return _empty((n, cfg.pca_dim), torch.float32, device)
        return torch.randn((n, cfg.pca_dim), generator=g, device=device)

    q, db = rows(shape.batch), rows(shape.n_candidates)
    if db.shape[0] % n_shards:
        raise ValueError(f"{db.shape[0]} rows do not split over "
                         f"{n_shards} shards")
    offs = torch.arange(0, db.shape[0], db.shape[0] // n_shards,
                        dtype=torch.int32, device=device) if not meta \
        else _empty((n_shards,), torch.int32, device)
    mf = 2.0 * shape.batch * shape.n_candidates * cfg.pca_dim
    arg_bytes = SH.shard_bytes((dp, None), q, mesh) + SH.shard_bytes(
        ("model", None), db, mesh) + SH.shard_bytes(("model",), offs, mesh)
    return Cell(spec.arch_id, shape.name, fn,
                (q, SH.put_row_sharded(mesh, db), offs), "build", mf,
                arg_bytes=arg_bytes, **common)


# ===========================================================================
# dispatch
# ===========================================================================


def build_cell(arch_id: str, shape_name: str, mesh, device="meta",
               seed: int = 0) -> Cell:
    """The cell's step and arguments on ``device`` (module docstring)."""
    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    reason = spec.skip_reason(shape_name)
    if reason:
        raise ValueError(f"cell skipped: {reason}")
    build = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
             "ann": _ann_cell}.get(spec.family)
    if build is None:
        raise KeyError(spec.family)
    return build(spec, shape, mesh, device, seed)
