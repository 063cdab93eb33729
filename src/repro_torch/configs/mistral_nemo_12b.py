"""mistral-nemo-12b: dense 40L GQA decoder, 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, reduced_lm

CONFIG = LMConfig(
    name="mistral-nemo-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    qk_norm=False,
    qkv_bias=False,
    rope_theta=1e6,
)

SPEC = ArchSpec(
    arch_id="mistral-nemo-12b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    smoke_config=reduced_lm(CONFIG),
    source="[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
    notes="head_dim=128 (not d_model/n_heads); 128k context window.",
)
