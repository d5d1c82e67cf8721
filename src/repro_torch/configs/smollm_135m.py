"""smollm-135m — SmolLM 135M [hf:HuggingFaceTB/SmolLM-135M].

Llama-style small dense decoder: 30L, d_model=576, 9 heads, GQA kv=3,
d_ff=1536, vocab=49152. Default ACAR probe model in this framework.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

REDUCED = CONFIG.replace(
    name="smollm-135m-reduced",
    num_layers=2,
    d_model=192,
    num_heads=3,
    num_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    remat="none",
)
