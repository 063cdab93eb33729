"""The paper's own workload: LAION-style 768-d vectors through the tuned
NSG pipeline (SISAP 2023 Task A)."""
from repro_torch.configs.base import ANNConfig, ArchSpec, ShapeConfig

CONFIG = ANNConfig(
    name="ann-laion",
    dim=768,
    n_database=300_000,
    k=10,
    pca_dim=600,           # paper Fig 3a best
    antihub_keep=0.9,      # paper Fig 3b best
    ep_clusters=64,
    ef_search=64,
    graph_degree=32,       # "NSG32"
)

ANN_SHAPES = {
    "search_300k": ShapeConfig("search_300k", "retrieval", batch=1024,
                               n_candidates=300_000),
    "search_10m": ShapeConfig("search_10m", "retrieval", batch=1024,
                              n_candidates=10_000_000),
    "search_30m": ShapeConfig("search_30m", "retrieval", batch=1024,
                              n_candidates=30_000_000),
    "build_knn": ShapeConfig("build_knn", "train", batch=4096,
                             n_candidates=300_000),
}

SPEC = ArchSpec(
    arch_id="ann-laion",
    family="ann",
    config=CONFIG,
    shapes=ANN_SHAPES,
    source="[SISAP23 Task A / arXiv:2309.00472; paper]",
    notes="The paper's pipeline (TunedGraphIndex); search_10m and "
          "search_30m exceed one card's memory at 768-d and are served "
          "row-sharded (core.distributed: ShardedIndex over a mesh, "
          "StreamedShardedIndex from pinned host memory on one card).",
)
