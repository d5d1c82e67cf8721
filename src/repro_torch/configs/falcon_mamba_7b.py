"""falcon-mamba-7b — attention-free Mamba-1 SSM [arXiv:2410.05355].

64L, d_model=4096, d_inner=8192 (expand=2), ssm_state=16, vocab=65024.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,          # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    attn_kind="none",
    use_rope=False,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, chunk=256),
    tie_embeddings=False,
    source="arXiv:2410.05355",
)

REDUCED = CONFIG.replace(
    name="falcon-mamba-7b-reduced",
    num_layers=2,
    d_model=256,
    vocab_size=512,
    ssm=SSMConfig(state_dim=8, conv_width=4, expand=2, chunk=64),
    remat="none",
)
