"""llava-next-mistral-7b — LLaVA-NeXT on a Mistral-7B backbone
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The TRANSFORMER BACKBONE only (Mistral-7B: 32L, d_model=4096, 32 heads,
GQA kv=8, d_ff=14336, vocab=32000, native sliding window 4096). The
ViT/SigLIP vision encoder + projector are a STUB: input_specs() provides
precomputed patch embeddings (anyres tiling -> num_patches prefix tokens).
"""
from repro_torch.configs.base import ModelConfig

# anyres: base 576 patches + 4 tiles x 576 = 2880 max; we use a 1152-token
# prefix (2 tiles) so train_4k keeps a meaningful text budget.
NUM_PATCHES = 1152

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    window=4096,            # Mistral native SWA
    rope_theta=1_000_000.0,
    frontend="vision",
    num_patches=NUM_PATCHES,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

REDUCED = CONFIG.replace(
    name="llava-next-mistral-7b-reduced",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    window=128,
    num_patches=16,
    remat="none",
)
