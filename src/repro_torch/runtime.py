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
