"""DimeNet (directional message passing) on flat padded graphs (the
reference's ``models/dimenet.py``).

Graph encoding (one flat graph; batched molecules are flattened with
offsets), tensors as ``data.graph_sampler.graph_to_device`` makes them:
  x / z:      (N, F) features or (N,) atom numbers
  pos:        (N, 3)
  src, dst:   (E,) edge endpoints (message j->i has src=j, dst=i)
  t_kj, t_ji: (T,) triplet indices into the edge list (-1 padded)
  edge_mask:  (E,) bool; node_mask: (N,); graph_id: (N,) readout segments

The scatters and the gathers that train go through the port's
``embedding_bag`` kernels (``kernels/embedding_bag/ops.py``): the three
``jax.ops.segment_sum``s (triplets -> edges, the per-block node readout,
the graph readout) are ``segment_sum``, and the gathers of tensors that
require grad (``hnode[src]``, ``hnode[dst]``, ``(m @ w_kj)[t_kj]``, and
``embed[z]``) are bags of one id, whose gradient is that same
grouped scatter. Each id array is grouped once a step: ``bag_grouping``
builds one plan each for ``src``, ``dst``, ``t_kj`` and ``t_ji``, which
every call on those ids takes, and the calls on molecule batches' ``z``
and graph ids, one each, group inside the call; so the step groups 4 (6)
times for its 20 (22) scatters. So nothing on the path adds with float
atomics:
no ``index_add_``, ``scatter_add_`` or accumulating ``index_put_``, and
no advanced indexing of a tensor that requires grad (autograd would
transpose it into one). Gathers of geometry (``pos``, ``svec``, ``d``),
which needs no gradient, are plain indexing.

Padding is passed as id -1. The reference clamps a padded triplet's ids
to 0 and keeps a padded edge as src = dst = 0; their terms are exact
zeros (times ``tmask`` / ``emask``) that all land on row 0. A grouped
sum gives each run of one id to one warp (and its plain version loops
once per rank of a run), so such a hub would serialise the sum: at
minibatch_lg 96,345 of 168,960 edges are padding. Skipping those terms
gives the same sums, because each of them is an exact zero.

The dense products are ``torch.matmul`` in float32, as the reference
leaves them to XLA. The bilinear einsum ``"tb,th,bhg->tg"`` is one
(T, B * H) @ (B * H, G) product, never a (T, H, G) intermediate.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.kernels.embedding_bag import BagPlan, bag_grouping, \
    embedding_bag, segment_sum
from repro_torch.models.layers import MLP, dense_init, init_device, \
    mlp_init

N_ATOM_TYPES = 95


# -------------------------------------------------------------------- bases
def _ipow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ** k for a Python int k >= 1 by square-and-multiply, the order of
    XLA's integer power (the reference's ``d ** p``)."""
    acc, base = None, x
    while k:
        if k & 1:
            acc = base if acc is None else acc * base
        k >>= 1
        if k:
            base = base * base
    return acc


def envelope(d: torch.Tensor, p: int) -> torch.Tensor:
    """Smooth polynomial cutoff (Klicpera et al. eq. 8), d in [0, 1]."""
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    return 1.0 / torch.clamp_min(d, 1e-6) + a * _ipow(d, p - 1) \
        + b * _ipow(d, p) + c * _ipow(d, p + 1)


def _radial(d: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """(E,) -> (E, n_radial): envelope times sin(n pi x), x = d / cutoff
    clipped to [1e-6, 1]."""
    x = torch.clamp(d / cfg.cutoff, 1e-6, 1.0)
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                     device=d.device)
    env = envelope(x, cfg.envelope_p)
    return env[:, None] * torch.sin(n[None, :] * math.pi * x[:, None])


def radial_basis(d: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """(E,) -> (E, n_radial) sin-Bessel RBF with envelope."""
    return _radial(d, cfg) * (2.0 / cfg.cutoff) ** 0.5


def spherical_basis(d: torch.Tensor, angle: torch.Tensor,
                    cfg: GNNConfig) -> torch.Tensor:
    """(T,), (T,) -> (T, n_radial * n_spherical), radial-major."""
    rad = _radial(d, cfg)
    l = torch.arange(cfg.n_spherical, dtype=torch.float32, device=d.device)
    ang = torch.cos(l[None, :] * angle[:, None])
    return (rad[:, :, None] * ang[:, None, :]).reshape(
        d.shape[0], cfg.n_radial * cfg.n_spherical)


# ------------------------------------------------------------------- model
class Block(nn.Module):
    """One interaction block: the reference's ``blocks[i]`` dict."""

    def __init__(self, w_src, w_kj, rbf_gate, sbf_proj, bilinear,
                 update: MLP, out_node: MLP):
        super().__init__()
        self.w_src = nn.Parameter(w_src)
        self.w_kj = nn.Parameter(w_kj)
        self.rbf_gate = nn.Parameter(rbf_gate)
        self.sbf_proj = nn.Parameter(sbf_proj)
        self.bilinear = nn.Parameter(bilinear)
        self.update = update
        self.out_node = out_node


class DimeNet(nn.Module):
    """The reference's params tree as a module: ``embed``, ``rbf_proj``,
    ``msg_init``, ``out_final`` and ``blocks.<i>``."""

    def __init__(self, embed, rbf_proj, msg_init: MLP, out_final: MLP,
                 blocks):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.rbf_proj = nn.Parameter(rbf_proj)
        self.msg_init = msg_init
        self.out_final = out_final
        self.blocks = nn.ModuleList(blocks)


def init_params(generator: torch.Generator, cfg: GNNConfig,
                d_feat: int = 0, device=None) -> DimeNet:
    """Random weights with the reference's distributions, drawn on the
    generator's device (or ``device``): ``embed`` dense (d_feat, H) or
    (95, H) normal x 0.5, dense projections, zero-bias MLPs, ``bilinear``
    (B, H, H) normal x H^-0.5."""
    h, dev = cfg.d_hidden, init_device(generator, device)
    n_sbf = cfg.n_radial * cfg.n_spherical
    embed = (dense_init(generator, d_feat, h, dev) if d_feat else
             torch.randn((N_ATOM_TYPES, h), generator=generator,
                         device=dev) * 0.5)
    rbf_proj = dense_init(generator, cfg.n_radial, h, dev)
    msg_init = mlp_init(generator, (3 * h, h, h), dev)
    out_final = mlp_init(generator, (h, h, cfg.d_out), dev)
    blocks = [Block(dense_init(generator, h, h, dev),
                    dense_init(generator, h, h, dev),
                    dense_init(generator, cfg.n_radial, h, dev),
                    dense_init(generator, n_sbf, cfg.n_bilinear, dev),
                    torch.randn((cfg.n_bilinear, h, h), generator=generator,
                                device=dev) * h ** -0.5,
                    mlp_init(generator, (h, h, h), dev),
                    mlp_init(generator, (h, h, h), dev))
              for _ in range(cfg.n_blocks)]
    return DimeNet(embed, rbf_proj, msg_init, out_final, blocks)


# ----------------------------------------------------------------- forward
def _gather(table: torch.Tensor, ids: torch.Tensor,
            plan: Optional[BagPlan] = None) -> torch.Tensor:
    """table[ids] for a table that trains (-1 gathers a zero row): a bag
    of one id, whose gradient is the grouped scatter over ``plan``
    (``bag_grouping(ids, len(table))``)."""
    return embedding_bag(table, ids[:, None], plan=plan)


def _bilinear(a: torch.Tensor, m_kj: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """einsum("tb,th,bhg->tg", a, m_kj, w) as one (T, B H) @ (B H, G)
    product."""
    t, b = a.shape
    h = m_kj.shape[1]
    outer = (a[:, :, None] * m_kj[:, None, :]).reshape(t, b * h)
    return outer @ w.reshape(b * h, w.shape[2])


def node_messages(model: DimeNet, cfg: GNNConfig,
                  graph: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The message passing over the graph's edges and triplets -> the
    (N, H) node accumulator (the per-block node readouts summed). Over one
    shard's edges it is that shard's partial sum (``launch/specs.py``'s
    edge partition)."""
    pos = graph["pos"]
    src, dst = graph["src"].long(), graph["dst"].long()
    edge_mask = graph["edge_mask"]
    emask = edge_mask.float()
    n, e = pos.shape[0], src.shape[0]
    src_ids = torch.where(edge_mask, src, -1)      # padding skipped
    dst_ids = torch.where(edge_mask, dst, -1)
    src_plan, dst_plan = bag_grouping(src_ids, n), bag_grouping(dst_ids, n)

    # node embedding
    if "x" in graph:
        hnode = graph["x"] @ model.embed
    else:
        hnode = _gather(model.embed, graph["z"])

    # edge geometry (no gradient: plain indexing)
    svec = pos[dst] - pos[src]                                 # j -> i
    d = torch.sqrt(torch.clamp_min((svec * svec).sum(-1), 1e-12))
    rbf = radial_basis(d, cfg) * emask[:, None]

    # triplet geometry: angle between edge kj (k->j) and ji (j->i)
    t_kj_raw, t_ji_raw = graph["t_kj"].long(), graph["t_ji"].long()
    valid = (t_kj_raw >= 0) & (t_ji_raw >= 0)
    tmask = valid.float()
    t_kj, t_ji = t_kj_raw.clamp_min(0), t_ji_raw.clamp_min(0)
    kj_ids = torch.where(valid, t_kj_raw, -1)
    ji_ids = torch.where(valid, t_ji_raw, -1)
    kj_plan, ji_plan = bag_grouping(kj_ids, e), bag_grouping(ji_ids, e)
    v_ji = svec[t_ji]
    v_jk = -svec[t_kj]                                         # j -> k
    dot = (v_ji * v_jk).sum(-1)
    nrm = torch.clamp_min(torch.sqrt((v_ji * v_ji).sum(-1))
                          * torch.sqrt((v_jk * v_jk).sum(-1)), 1e-9)
    angle = torch.arccos(torch.clamp(dot / nrm, -1 + 1e-7, 1 - 1e-7))
    sbf = spherical_basis(d[t_kj], angle, cfg) * tmask[:, None]

    # initial directional messages
    m = model.msg_init(torch.cat([_gather(hnode, src_ids, src_plan),
                                  _gather(hnode, dst_ids, dst_plan),
                                  rbf @ model.rbf_proj], dim=-1))
    m = m * emask[:, None]

    node_out = torch.zeros((n, cfg.d_hidden), device=pos.device)
    for blk in model.blocks:
        # angular message: bilinear(sbf, m_kj) aggregated over triplets
        m_kj = _gather(m @ blk.w_kj, kj_ids, kj_plan) * tmask[:, None]
        a = sbf @ blk.sbf_proj                                 # (T, B)
        tri = _bilinear(a, m_kj, blk.bilinear)
        agg = segment_sum(tri * tmask[:, None], ji_ids, e, ji_plan)
        gate = F.silu(rbf @ blk.rbf_gate)
        m = m + F.silu(m @ blk.w_src) * gate + agg
        m = m + blk.update(F.silu(m))
        m = m * emask[:, None]
        # per-block node readout
        node_out = node_out + segment_sum(
            blk.out_node(m) * emask[:, None], dst_ids, n, dst_plan)
    return node_out


def readout(model: DimeNet, graph: Dict[str, torch.Tensor],
            node_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The node accumulator -> (graph_out (G, d_out), node_out (N,
    d_out)): the final MLP, the node mask, the graph sums."""
    node_mask = graph["node_mask"]
    node_out = model.out_final(F.silu(node_out))
    node_out = node_out * node_mask.float()[:, None]
    g = graph.get("graph_id")
    # the graph count is the label vector's length
    n_graphs = graph["y_graph"].shape[0] if "y_graph" in graph else 1
    if g is None or n_graphs == 1:
        graph_out = node_out.sum(0, keepdim=True)
    else:
        graph_out = segment_sum(node_out,
                                torch.where(node_mask, g.long(), -1),
                                n_graphs)
    return graph_out, node_out


def forward(model: DimeNet, cfg: GNNConfig, graph: Dict[str, torch.Tensor],
            node_reduce: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (graph_out (G, d_out), node_out (N, d_out)).

    node_reduce: optional reducer applied to the node accumulator before
    the final MLP (the reference's edge-partition hook: a psum of the
    shards' partial sums there)."""
    node_out = node_messages(model, cfg, graph)
    if node_reduce is not None:
        node_out = node_reduce(node_out)
    return readout(model, graph, node_out)


def loss_fn(model: DimeNet, cfg: GNNConfig, graph: Dict[str, torch.Tensor],
            node_reduce: Optional[Callable] = None):
    """-> (loss, {"loss": loss}): the mean squared error of the graph
    outputs against ``y_graph``, or of the masked node outputs against
    ``y_node`` over max(sum of the mask, 1)."""
    return loss_of(graph, *forward(model, cfg, graph, node_reduce))


def loss_of(graph: Dict[str, torch.Tensor], graph_out: torch.Tensor,
            node_out: torch.Tensor):
    """``loss_fn``'s loss of given outputs."""
    if "y_graph" in graph:
        err = graph_out[:, 0] - graph["y_graph"]
        loss = (err * err).mean()
    else:
        mask = graph["node_mask"].float()
        err = (node_out[:, 0] - graph["y_node"]) * mask
        loss = (err * err).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, {"loss": loss}
