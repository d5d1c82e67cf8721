"""recurrentgemma-2b — Griffin-style hybrid [arXiv:2402.19427].

26L, d_model=2560, 10 heads (MQA kv=1, head_dim 256), d_ff=7680,
vocab=256000. Temporal mixing pattern 2 RG-LRU : 1 local attention
(window 2048).
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    window=2048,                       # local attention window
    layer_pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, chunk=256),
    rope_theta=10_000.0,
    source="arXiv:2402.19427",
)

REDUCED = CONFIG.replace(
    name="recurrentgemma-2b-reduced",
    num_layers=3,                      # one full pattern period
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    window=64,
    rglru=RGLRUConfig(lru_width=256, conv_width=4, chunk=32),
    remat="none",
)
