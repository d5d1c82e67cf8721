"""Process-wide settings for running the port on the card."""
from __future__ import annotations

import os

import torch


def deterministic_cuda() -> None:
    """Full-precision float32 matmuls (TF32 off for matmuls and cuDNN)
    and deterministic algorithms, so a rerun of a stream reproduces its
    answers and a rerun of a training step its losses and params."""
    # cuBLAS is deterministic only with a fixed workspace configuration,
    # read when its first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``, refusing a CUDA device when no
    card is visible: the entry points run on the card unless the caller
    asks for the CPU, and never fall back to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                           "device is visible; pass --device cpu to run "
                           "on the CPU")
    return dev
