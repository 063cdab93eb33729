"""sasrec: self-attentive sequential recommendation. [arXiv:1808.09781; paper]"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES

# Item vocabulary sized for production posture (paper datasets are small);
# the table is row-sharded on the model axis.
CONFIG = RecsysConfig(
    name="sasrec",
    interaction="self-attn-seq",
    embed_dim=50,
    table_vocabs=(1_000_000,),   # item id table
    seq_len=50,
    n_blocks=2,
    n_heads=1,
)

SMOKE = RecsysConfig(
    name="sasrec-smoke",
    interaction="self-attn-seq",
    embed_dim=16,
    table_vocabs=(997,),
    seq_len=12,
    n_blocks=2,
    n_heads=1,
)

SPEC = ArchSpec(
    arch_id="sasrec",
    family="recsys",
    config=CONFIG,
    shapes=RECSYS_SHAPES,
    smoke_config=SMOKE,
    source="[arXiv:1808.09781; paper]",
    notes="Causal self-attention over the behaviour sequence; next-item "
          "sampled-softmax loss; retrieval_cand scores the final hidden "
          "state against 1M item embeddings.",
)
