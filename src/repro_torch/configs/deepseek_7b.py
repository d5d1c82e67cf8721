"""deepseek-7b — DeepSeek LLM 7B [arXiv:2401.02954].

Llama-style dense decoder with full MHA: 30L, d_model=4096, 32 heads
(kv=32), d_ff=11008, vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    source="arXiv:2401.02954",
)

REDUCED = CONFIG.replace(
    name="deepseek-7b-reduced",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    remat="none",
)
