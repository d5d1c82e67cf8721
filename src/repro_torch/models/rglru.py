"""RG-LRU recurrent block (RecurrentGemma / Griffin): the full-sequence
forward.

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) with
a_t = exp(-c * softplus(Lambda) * r_t), r_t/i_t sigmoid gates of the
conv output. The port of ``repro/models/rglru.py``'s ``rglru_block`` on
its kernel path (the reference's ``use_pallas`` branch): the scan goes
through ``kernels.ops.rglru_scan``, the hand-written Hopper kernel on
the card and its plain version on the CPU, and is differentiable. The
serving functions (``rglru_prefill``, the step functions) are not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d

_C = 8.0  # Griffin's fixed recurrence sharpness constant


def _gates(p: dict, xc: torch.Tensor):
    """xc: (..., w) conv output -> (a, gated input) in f32."""
    xf = xc.float()
    r = torch.sigmoid(torch.matmul(xf, p["w_a"].float()) + p["b_a"].float())
    i = torch.sigmoid(torch.matmul(xf, p["w_i"].float()) + p["b_i"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalisation, clipped for stability
    beta = torch.sqrt(torch.clamp(1.0 - torch.square(a), 1e-12, 1.0))
    return a, beta * i * xf


def rglru_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (B, S, d_model)."""
    xb = torch.matmul(x, p["w_x"])
    gb = torch.matmul(x, p["w_g"])
    xc = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    a, u = _gates(p, xc)
    y, _ = ops.rglru_scan(a, u)
    # jax.nn.gelu defaults to the tanh approximation
    y = y * F.gelu(gb.float(), approximate="tanh")
    return torch.matmul(y.to(x.dtype), p["w_out"])
