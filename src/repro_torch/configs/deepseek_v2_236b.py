"""deepseek-v2-236b — DeepSeek-V2 MoE with MLA [arXiv:2405.04434].

60L, d_model=5120, 128 heads, MLA (kv_lora_rank=512, q_lora_rank=1536,
qk_nope=128, qk_rope=64, v=128). MoE: 160 routed experts top-6 +
2 shared experts, expert d_ff=1536; layer 0 keeps a dense FFN (d_ff=12288).
vocab=102400.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,     # MLA: per-head latent expansion; kv grouping n/a
    d_ff=12288,           # dense FFN used for layer 0
    vocab_size=102400,
    attn_kind="mla",
    head_dim=128,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared_experts=2,
        d_ff_shared=1536,
        capacity_factor=1.25,
        first_moe_layer=1,
    ),
    rope_theta=10_000.0,
    source="arXiv:2405.04434",
)

REDUCED = CONFIG.replace(
    name="deepseek-v2-236b-reduced",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    head_dim=32,
    mla=MLAConfig(
        kv_lora_rank=64,
        q_lora_rank=96,
        qk_nope_head_dim=32,
        qk_rope_head_dim=16,
        v_head_dim=32,
    ),
    moe=MoEConfig(
        num_experts=4,
        top_k=2,
        d_ff_expert=128,
        num_shared_experts=1,
        d_ff_shared=128,
        first_moe_layer=1,
    ),
    remat="none",
)
