"""two-tower-retrieval: dual-encoder with sampled softmax.
[RecSys'19 (YouTube); unverified]"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES

# tables: (user_id, user_history_items, item_id, item_category)
CONFIG = RecsysConfig(
    name="two-tower-retrieval",
    interaction="dot",
    embed_dim=256,
    table_vocabs=(10_000_000, 2_000_000, 2_000_000, 10_000),
    tower_mlp=(1024, 512, 256),
    seq_len=32,                       # history bag length
    multi_hot=(1, 32, 1, 1),
)

SMOKE = RecsysConfig(
    name="two-tower-smoke",
    interaction="dot",
    embed_dim=32,
    table_vocabs=(1009, 503, 503, 97),
    tower_mlp=(64, 48, 32),
    seq_len=8,
    multi_hot=(1, 8, 1, 1),
)

SPEC = ArchSpec(
    arch_id="two-tower-retrieval",
    family="recsys",
    config=CONFIG,
    shapes=RECSYS_SHAPES,
    smoke_config=SMOKE,
    source="[RecSys'19 (YouTube); unverified]",
    notes="In-batch sampled softmax with logQ correction; retrieval_cand is "
          "the ANN-relevant cell — also servable through the paper's tuned "
          "NSG index (retrieval through TunedGraphIndex over the item "
          "tower's embeddings).",
)
