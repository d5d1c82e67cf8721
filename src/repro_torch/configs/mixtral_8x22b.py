"""mixtral-8x22b — Mixtral 8x22B sparse MoE [arXiv:2401.04088].

56L, d_model=6144, 48 heads, GQA kv=8, expert d_ff=16384, vocab=32768,
8 experts top-2, sliding-window attention.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    window=4096,           # SWA per the assignment
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_ff_expert=16384,
        capacity_factor=1.25,
    ),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)

REDUCED = CONFIG.replace(
    name="mixtral-8x22b-reduced",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    window=128,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    remat="none",
)
