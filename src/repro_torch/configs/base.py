"""Config dataclasses of the paper's ANN workload (copied from the
reference's ``configs/base.py``; the model-family configs are not ported)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ANNConfig:
    """The paper's workload: tuned graph index over D0-dim embeddings."""

    name: str
    dim: int = 768                   # D0 (LAION CLIP dim)
    n_database: int = 300_000
    k: int = 10
    # --- the paper's three tunable knobs + search width ---
    pca_dim: int = 768               # D  (<= dim)
    antihub_keep: float = 1.0        # alpha
    ep_clusters: int = 1             # k-means entry points (1 = medoid)
    ef_search: int = 64              # beam width
    # --- graph build ---
    graph_degree: int = 32           # R (NSG out-degree budget)
    build_knn_k: int = 32
    build_candidates: int = 64       # MRNG candidate pool L
    prune_alpha: float = 1.0         # α-RNG occlusion slack (1.0 = MRNG)
    knn_backend: str = "auto"        # exact | nndescent | auto (core.build)
    finish_backend: str = "auto"     # host | device | auto (build.finish)
    dist_backend: str = "f32"        # f32 | pq | int8 (core.quant serving)
    pq_m: int = 0                    # PQ sub-quantizers (0 = auto by dim)
    rerank: int = 64                 # exact-rerank depth of quantized tail
    hop_backend: str = "auto"        # staged | fused | auto (beam hop)
    patience: int = 0                # adaptive-termination hops (0 = off)
    eps: float = 0.0                 # top-k progress threshold for patience
    compact_every: int = 0           # compaction slice length (0 = off)
    dtype: str = "float32"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode | serve | retrieval | graph
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # GNN
    n_nodes: int = 0
    n_edges: int = 0
    n_triplets: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0    # batched small graphs
    # Recsys
    batch: int = 0
    n_candidates: int = 0
