"""llama3-8b — Llama 3 8B dense decoder [arXiv:2407.21783].

32L, d_model=4096, 32 heads, GQA kv=8, d_ff=14336, vocab=128256,
rope_theta=500000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)

REDUCED = CONFIG.replace(
    name="llama3-8b-reduced",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    remat="none",
)
