"""granite-34b — IBM Granite 34B code model [arXiv:2405.04324].

Llama-style dense decoder with multi-query attention (kv=1).
88L, d_model=6144, 48 heads, d_ff=24576, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10_000.0,
    source="arXiv:2405.04324",
)

REDUCED = CONFIG.replace(
    name="granite-34b-reduced",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    remat="none",
)
