"""din: deep interest network with target attention. [arXiv:1706.06978; paper]"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES

# tables: (goods_id, category_id); history is a bag of (goods, cate) pairs.
CONFIG = RecsysConfig(
    name="din",
    interaction="target-attn",
    embed_dim=18,
    table_vocabs=(1_000_000, 10_000),
    attn_mlp=(80, 40),
    top_mlp=(200, 80),
    seq_len=100,
)

SMOKE = RecsysConfig(
    name="din-smoke",
    interaction="target-attn",
    embed_dim=8,
    table_vocabs=(503, 53),
    attn_mlp=(16, 8),
    top_mlp=(24, 12),
    seq_len=10,
)

SPEC = ArchSpec(
    arch_id="din",
    family="recsys",
    config=CONFIG,
    shapes=RECSYS_SHAPES,
    smoke_config=SMOKE,
    source="[arXiv:1706.06978; paper]",
    notes="Local activation unit: attn MLP over (target, hist, target-hist, "
          "target*hist) -> weighted sum-pool of history; sigmoid CTR head.",
)
