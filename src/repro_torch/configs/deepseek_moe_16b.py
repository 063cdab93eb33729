"""deepseek-moe-16b: fine-grained MoE, 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, reduced_lm

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,           # MHA
    head_dim=128,
    d_ff=10944,              # dense FFN width (first layer)
    vocab_size=102400,
    rope_theta=1e4,
    moe=True,
    n_routed_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    dense_d_ff=10944,
)

SPEC = ArchSpec(
    arch_id="deepseek-moe-16b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    smoke_config=reduced_lm(CONFIG),
    source="[arXiv:2401.06066; hf]",
    notes="Fine-grained expert segmentation; 2 shared + 64 routed, top-6.",
)
