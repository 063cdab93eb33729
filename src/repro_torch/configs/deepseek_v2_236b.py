"""deepseek-v2-236b: MLA (kv_lora=512) + fine-grained MoE 160e top-6.
[arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, reduced_lm

CONFIG = LMConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA decompresses to full MHA
    head_dim=192,            # qk_nope + qk_rope
    d_ff=12288,              # dense FFN width (first layer)
    vocab_size=102400,
    rope_theta=1e4,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_routed_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    dense_d_ff=12288,
)

SPEC = ArchSpec(
    arch_id="deepseek-v2-236b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    smoke_config=reduced_lm(CONFIG),
    source="[arXiv:2405.04434; hf]",
    notes="MLA kv_lora=512 (KV cache stores the 512+64 latent), "
          "2 shared + 160 routed experts, top-6, first layer dense.",
)
