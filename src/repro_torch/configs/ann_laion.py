"""The paper's own workload: LAION-style 768-d vectors through the tuned
NSG pipeline (SISAP 2023 Task A)."""
from repro_torch.configs.base import ANNConfig, ShapeConfig

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
