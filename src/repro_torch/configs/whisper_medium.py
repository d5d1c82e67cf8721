"""whisper-medium — encoder-decoder ASR transformer [arXiv:2212.04356].

24L encoder + 24L decoder, d_model=1024, 16 heads (MHA), d_ff=4096,
vocab=51865. The mel-spectrogram + conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, d_model).
Whisper uses learned positional embeddings (no RoPE).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    use_rope=False,
    max_position=448,   # real whisper decoder context; the dry-run
                        # resizes this to the shape's seq_len
    encoder=EncoderConfig(num_layers=24, num_frames=1500, d_frontend=1024),
    frontend="audio",
    source="arXiv:2212.04356",
)

REDUCED = CONFIG.replace(
    name="whisper-medium-reduced",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    max_position=128,
    encoder=EncoderConfig(num_layers=2, num_frames=64, d_frontend=256),
    remat="none",
)
