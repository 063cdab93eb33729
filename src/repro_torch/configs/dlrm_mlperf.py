"""dlrm-mlperf: MLPerf DLRM benchmark config (Criteo 1TB).
[arXiv:1906.00091; paper]"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES

# Criteo-1TB per-table cardinalities as used by the MLPerf reference.
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

CONFIG = RecsysConfig(
    name="dlrm-mlperf",
    interaction="dot",
    embed_dim=128,
    table_vocabs=CRITEO_VOCABS,
    n_dense=13,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
)

SMOKE = RecsysConfig(
    name="dlrm-smoke",
    interaction="dot",
    embed_dim=16,
    table_vocabs=(211, 97, 53, 31, 17, 3, 127, 61, 11, 199,
                  151, 103, 7, 41, 89, 29, 4, 23, 13, 179,
                  167, 193, 71, 37, 19, 5),
    n_dense=13,
    bot_mlp=(32, 24, 16),
    top_mlp=(64, 32, 1),
)

SPEC = ArchSpec(
    arch_id="dlrm-mlperf",
    family="recsys",
    config=CONFIG,
    shapes=RECSYS_SHAPES,
    smoke_config=SMOKE,
    source="[arXiv:1906.00091; paper]",
    notes="26 row-sharded tables (~187M rows x 128 = 95GB fp32 -> sharded on "
          "model axis); dot-interaction over 27 vectors; binary CTR loss.",
)
