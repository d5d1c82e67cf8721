"""Plain PyTorch oracles for the port's kernels, under the reference's
names (``repro/kernels/ref.py``).

Each oracle is defined beside its kernel's wrapper, in the kernel's own
module, and re-exported here: the CPU tests hold the oracles against
the reference's, and ``chip_smoke.py`` holds each kernel against its
oracle on the card. Math in f32 with ``-inf`` masking, as in the
reference; the int8 dense-cache oracle is the reference's jnp quant
path (``-1e30`` masking), which is what its op runs off the TPU.
"""
from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention_plain as chunked_prefill_attention_ref)
from repro_torch.kernels.decode_attention import (
    decode_attention_plain as decode_attention_ref)
from repro_torch.kernels.decode_attention_quant import (
    decode_attention_quant_plain as decode_attention_quant_ref)
from repro_torch.kernels.fused_swiglu import (
    fused_swiglu_plain as fused_swiglu_ref)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_plain as paged_decode_attention_ref)
from repro_torch.kernels.paged_decode_attention_quant import (
    paged_decode_attention_quant_plain as paged_decode_attention_quant_ref)
from repro_torch.kernels.rglru_scan import (
    rglru_scan_plain as rglru_scan_ref)
from repro_torch.kernels.selective_scan import (
    selective_scan_plain as selective_scan_ref)

__all__ = ["chunked_prefill_attention_ref", "decode_attention_quant_ref",
           "decode_attention_ref", "fused_swiglu_ref",
           "paged_decode_attention_quant_ref", "paged_decode_attention_ref",
           "rglru_scan_ref", "selective_scan_ref"]
