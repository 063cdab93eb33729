"""qwen2-1.5b: dense 28L GQA decoder with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, reduced_lm

CONFIG = LMConfig(
    name="qwen2-1.5b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SPEC = ArchSpec(
    arch_id="qwen2-1.5b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    smoke_config=reduced_lm(CONFIG, qkv_bias=True),
    source="[arXiv:2407.10671; hf]",
    notes="GQA kv=2, QKV bias, tied embeddings.",
)
