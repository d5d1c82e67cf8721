"""Dispatch for the port's kernels.

The model code calls these. A tensor on the CPU runs the kernel's plain
PyTorch version; a CUDA tensor launches the hand-written Hopper kernel,
and any failure to build or launch it raises — there is no fallback
that would hide the kernel.
"""
from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention_quant import (
    decode_attention_quant)
from repro_torch.kernels.fused_swiglu import (
    fused_swiglu, swiglu_down, swiglu_gate_up)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention)
from repro_torch.kernels.paged_decode_attention_quant import (
    paged_decode_attention_quant)
from repro_torch.kernels.projection import projection
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.selective_scan import (
    selective_scan, selective_scan_bwd)

# each launcher with a ``launches`` count: the forward wrappers, the
# SwiGLU's two stages called on their own (tensor parallelism), the
# backward kernels the two scans' autograd Functions launch, and the
# column-invariant projection (no TPU counterpart)
KERNELS = (paged_decode_attention, chunked_prefill_attention,
           fused_swiglu, decode_attention, paged_decode_attention_quant,
           decode_attention_quant, selective_scan, selective_scan_bwd,
           rglru_scan, rglru_scan_bwd, swiglu_gate_up, swiglu_down,
           projection)


# the wrappers that count their float32 calls apart (kernels 2 and 3)
F32_COUNTED = (chunked_prefill_attention, fused_swiglu, swiglu_gate_up,
               swiglu_down)


class LaunchCounts(dict):
    """Kernel launches per wrapper; ``f32`` holds the float32 calls among
    them of the wrappers in ``F32_COUNTED``."""

    def __init__(self, counts: dict, f32: dict):
        super().__init__(counts)
        self.f32 = f32


def launch_counts() -> LaunchCounts:
    """Kernel launches per wrapper since the counts were last reset."""
    return LaunchCounts({k.__name__: k.launches for k in KERNELS},
                        {k.__name__: k.f32_launches for k in F32_COUNTED})


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in F32_COUNTED:
        k.f32_launches = 0


__all__ = ["F32_COUNTED", "KERNELS", "LaunchCounts",
           "chunked_prefill_attention", "decode_attention",
           "decode_attention_quant", "fused_swiglu", "launch_counts",
           "paged_decode_attention", "paged_decode_attention_quant",
           "projection", "reset_launch_counts", "rglru_scan",
           "selective_scan", "swiglu_down", "swiglu_gate_up"]
