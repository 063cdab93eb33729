"""Graph batch construction for DimeNet (the reference's
``data/graph_sampler.py``, numpy only): triplet index building, padded flat
graphs, and a real fanout neighbor sampler (minibatch_lg's 15-10 two-hop).

All outputs are fixed-shape (padded, -1 sentinels) so the same model serves
every cell. Every numpy generator call is the reference's, in its order, so
one seed gives the reference's arrays bit for bit. ``graph_to_device``
turns such a dict into tensors on a device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def build_triplets(src: np.ndarray, dst: np.ndarray, n_triplets: int,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Wedge indices (k->j, j->i) into the edge list, capped at n_triplets.

    When the full wedge count exceeds the budget we sample uniformly (the
    capped angular budget for web-scale graphs); molecular graphs fit
    completely.
    """
    rng = rng or np.random.default_rng(0)
    e = len(src)
    by_dst: Dict[int, list] = {}
    for idx in range(e):
        by_dst.setdefault(int(dst[idx]), []).append(idx)
    kj_list, ji_list = [], []
    for ji in range(e):
        j = int(src[ji])
        for kj in by_dst.get(j, ()):
            if src[kj] == dst[ji]:
                continue                       # exclude k == i backtrack
            kj_list.append(kj)
            ji_list.append(ji)
    kj = np.asarray(kj_list, np.int32)
    ji = np.asarray(ji_list, np.int32)
    if len(kj) > n_triplets:
        sel = rng.choice(len(kj), n_triplets, replace=False)
        kj, ji = kj[sel], ji[sel]
    pad = n_triplets - len(kj)
    kj = np.pad(kj, (0, pad), constant_values=-1)
    ji = np.pad(ji, (0, pad), constant_values=-1)
    return kj, ji


def random_geometric_graph(rng: np.random.Generator, n_nodes: int,
                           avg_degree: int, box: float = 3.0):
    """Positions + kNN-ish directed edges (both directions)."""
    pos = rng.normal(size=(n_nodes, 3)) * box
    k = max(1, avg_degree // 2)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1)[:, :k]
    src = np.repeat(np.arange(n_nodes), k)
    dst = nbr.reshape(-1)
    # symmetrize: message passing needs both directions
    s = np.concatenate([src, dst]).astype(np.int32)
    t = np.concatenate([dst, src]).astype(np.int32)
    uniq = np.unique(np.stack([s, t], 1), axis=0)
    return pos.astype(np.float32), uniq[:, 0], uniq[:, 1]


def make_dimenet_batch(seed: int, n_nodes: int, n_edges: int,
                       n_triplets: int, d_feat: int = 0, n_graphs: int = 1,
                       node_targets: bool = False) -> Dict[str, np.ndarray]:
    """Padded flat (multi-)graph with geometry, triplets, masks, labels."""
    rng = np.random.default_rng(seed)
    per = n_nodes // n_graphs
    pos_l, src_l, dst_l, gid_l = [], [], [], []
    for gi in range(n_graphs):
        nn = per
        pos, s, t = random_geometric_graph(rng, nn, max(2, n_edges // n_nodes))
        pos_l.append(pos)
        src_l.append(s + gi * per)
        dst_l.append(t + gi * per)
        gid_l.append(np.full(nn, gi, np.int32))
    pos = np.concatenate(pos_l)
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    if len(src) > n_edges:
        sel = rng.choice(len(src), n_edges, replace=False)
        src, dst = src[sel], dst[sel]
    epad = n_edges - len(src)
    emask = np.concatenate([np.ones(len(src), bool), np.zeros(epad, bool)])
    kj, ji = build_triplets(src, dst, n_triplets, rng)
    src = np.pad(src, (0, epad)).astype(np.int32)
    dst = np.pad(dst, (0, epad)).astype(np.int32)

    g: Dict[str, np.ndarray] = {
        "pos": pos.astype(np.float32),
        "src": src, "dst": dst,
        "edge_mask": emask,
        "t_kj": kj, "t_ji": ji,
        "node_mask": np.ones(n_nodes, bool),
        "graph_id": np.concatenate(gid_l),
    }
    if d_feat:
        g["x"] = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    else:
        g["z"] = rng.integers(1, 10, n_nodes).astype(np.int32)
    if node_targets:
        g["y_node"] = rng.normal(size=(n_nodes,)).astype(np.float32)
    else:
        g["y_graph"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    return g


def build_triplets_sharded(src: np.ndarray, dst: np.ndarray,
                           n_triplets: int, n_shards: int,
                           e_per_shard: int,
                           rng: Optional[np.random.Generator] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Shard-local wedges with SHARD-LOCAL edge indices.

    Edge block s owns rows [s*m, (s+1)*m); only wedges whose both edges fall
    in the same block are kept (locality-restricted angular sampling — the
    distributed analogue of the capped triplet budget), and
    indices are rebased to the block. Triplet block s (size n_triplets /
    n_shards) aligns with edge block s under identical sharding.
    """
    rng = rng or np.random.default_rng(0)
    assert n_triplets % n_shards == 0
    t_per = n_triplets // n_shards
    kj_all = np.full(n_triplets, -1, np.int32)
    ji_all = np.full(n_triplets, -1, np.int32)
    for s in range(n_shards):
        lo, hi = s * e_per_shard, min((s + 1) * e_per_shard, len(src))
        if lo >= len(src):
            break
        kj, ji = build_triplets(src[lo:hi], dst[lo:hi], t_per, rng)
        kj_all[s * t_per:(s + 1) * t_per] = kj
        ji_all[s * t_per:(s + 1) * t_per] = ji
    return kj_all, ji_all


# ---------------------------------------------------------------------------
# Fanout neighbor sampler (minibatch_lg)
# ---------------------------------------------------------------------------


class CSRGraph:
    """Compressed adjacency for host-side sampling."""

    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray):
        order = np.argsort(src, kind="stable")
        self.dst = dst[order].astype(np.int32)
        counts = np.bincount(src, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        self.n_nodes = n_nodes

    def neighbors(self, u: int) -> np.ndarray:
        return self.dst[self.offsets[u]: self.offsets[u + 1]]


def fanout_sample(graph: CSRGraph, seeds: np.ndarray,
                  fanouts: Sequence[int], rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GraphSAGE-style layered sampling.

    Returns (nodes: original ids, src, dst: LOCAL ids of sampled edges);
    nodes[0:len(seeds)] are the seeds.
    """
    local: Dict[int, int] = {int(s): i for i, s in enumerate(seeds)}
    nodes = [int(s) for s in seeds]
    edges_s, edges_d = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for u in frontier:
            nb = graph.neighbors(int(u))
            if len(nb) == 0:
                continue
            take = nb if len(nb) <= f else rng.choice(nb, f, replace=False)
            for v in take:
                v = int(v)
                if v not in local:
                    local[v] = len(nodes)
                    nodes.append(v)
                    nxt.append(v)
                # message flows v -> u
                edges_s.append(local[v])
                edges_d.append(local[u])
        frontier = nxt
    return (np.asarray(nodes, np.int64), np.asarray(edges_s, np.int32),
            np.asarray(edges_d, np.int32))


def sampled_dimenet_batch(seed: int, shape_cfg, base_nodes: int = 8192,
                          base_degree: int = 16) -> Dict[str, np.ndarray]:
    """minibatch_lg path: sample a 2-hop subgraph from a synthetic big graph,
    then pad to the cell's fixed shapes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, base_nodes, base_nodes * base_degree)
    dst = (src + 1 + rng.integers(0, base_nodes - 1,
                                  src.shape[0])) % base_nodes
    g = CSRGraph(base_nodes, src.astype(np.int32), dst.astype(np.int32))
    seeds = rng.choice(base_nodes, min(shape_cfg.batch_nodes, base_nodes),
                       replace=False)
    nodes, es, ed = fanout_sample(g, seeds, shape_cfg.fanout, rng)
    n, e = shape_cfg.n_nodes, shape_cfg.n_edges
    nodes = nodes[:n]
    keep = (es < len(nodes)) & (ed < len(nodes))
    es, ed = es[keep][:e], ed[keep][:e]
    epad = e - len(es)
    emask = np.concatenate([np.ones(len(es), bool), np.zeros(epad, bool)])
    kj, ji = build_triplets(es, ed, shape_cfg.n_triplets, rng)
    out = {
        "pos": rng.normal(size=(n, 3)).astype(np.float32),
        "x": rng.normal(size=(n, shape_cfg.d_feat)).astype(np.float32),
        "src": np.pad(es, (0, epad)).astype(np.int32),
        "dst": np.pad(ed, (0, epad)).astype(np.int32),
        "edge_mask": emask,
        "t_kj": kj, "t_ji": ji,
        "node_mask": (np.arange(n) < len(nodes)),
        "graph_id": np.zeros(n, np.int32),
        "y_node": rng.normal(size=(n,)).astype(np.float32),
    }
    return out


def graph_to_device(graph: Dict[str, np.ndarray], device) -> Dict:
    """A graph dict of numpy arrays -> tensors on ``device``: integer
    arrays as int32 ids, bool arrays as bool masks, float arrays as
    float32 features; any other value is passed through."""
    out = {}
    for k, v in graph.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        if v.dtype == np.bool_:
            t = torch.from_numpy(v)
        elif np.issubdtype(v.dtype, np.integer):
            t = torch.from_numpy(v.astype(np.int32))
        else:
            t = torch.from_numpy(v.astype(np.float32))
        out[k] = t.to(device)
    return out
