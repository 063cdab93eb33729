"""qwen3-32b: dense 64L GQA decoder with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, reduced_lm

CONFIG = LMConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,            # explicit head_dim (n_heads*head_dim != d_model)
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1e6,
)

SPEC = ArchSpec(
    arch_id="qwen3-32b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    smoke_config=reduced_lm(CONFIG),
    source="[hf:Qwen/Qwen3-8B; hf]",
    notes="qk_norm RMSNorm on per-head q/k; GQA kv=8.",
)
