"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).rsplit(".", 1)[-1]


def bound_s(bytes_moved: float, flops: float, dtype) -> float:
    """The least time the card can take for a call: the larger of its
    bytes over the memory bandwidth and its operations over the peak of
    its dtype."""
    return max(bytes_moved / HBM_BYTES_PER_S,
               flops / PEAK_FLOPS[dtype_name(dtype)])


def bound_term(bytes_moved: float, flops: float, dtype) -> str:
    """Which of the two terms of ``bound_s`` is the larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name(dtype)]
    return "bytes" if t_bytes >= t_ops else "operations"
