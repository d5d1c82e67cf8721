"""RG-LRU recurrent block (RecurrentGemma / Griffin): the full-sequence
forward.

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) with
a_t = exp(-c * softplus(Lambda) * r_t), r_t/i_t sigmoid gates of the
conv output. The port of ``repro/models/rglru.py``. ``rglru_block``
takes the reference's kernel path (its ``use_pallas`` branch): the scan
goes through ``kernels.ops.rglru_scan``, the hand-written Hopper kernel
on the card and its plain version on the CPU, and is differentiable.
The serving functions follow the reference's own path, which reaches no
Pallas kernel: ``rglru_prefill`` runs the plain associative scan
(``rglru_scan``, reference ``rglru.py:80``) and ``rglru_block_step`` one
recurrence step, both as torch ops on whatever device holds the
tensors. Routing the prefill through the RG-LRU kernel, which computes
the same recurrence, is later performance work.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    causal_conv1d, causal_conv1d_step, linear_recurrence_scan)

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


def _gated_out(p: dict, y: torch.Tensor, gb: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The block's output from the recurrence's f32 y: the gelu gate
    (jax.nn.gelu's default, the tanh approximation) and the output
    projection."""
    y = y * F.gelu(gb.float(), approximate="tanh")
    return torch.matmul(y.to(dtype), p["w_out"])


def rglru_scan(p: dict, xc: torch.Tensor, h0=None):
    """xc: (B, S, w) conv output. Returns y (B, S, w) f32 and h_final
    (B, w) f32: the reference's associative scan of the gated
    recurrence, a carried state folded in as a step before t=0."""
    a, u = _gates(p, xc)
    if h0 is not None:
        u = u.clone()
        u[:, 0] = u[:, 0] + a[:, 0] * h0
    _, hs = linear_recurrence_scan(a, u, dim=1)
    return hs, hs[:, -1]


def rglru_step(p: dict, x_t: torch.Tensor, h: torch.Tensor):
    """x_t: (B, w) conv output; h: (B, w) f32 state -> (y, h_new)."""
    a, u = _gates(p, x_t)
    h_new = a * h + u
    return h_new, h_new


def rglru_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (B, S, d_model)."""
    xb = torch.matmul(x, p["w_x"])
    gb = torch.matmul(x, p["w_g"])
    xc = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    a, u = _gates(p, xc)
    y, _ = ops.rglru_scan(a, u)
    return _gated_out(p, y, gb, x.dtype)


def rglru_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Like ``rglru_block`` but through the plain associative scan, also
    returning the decode state {conv: the last width-1 pre-conv inputs
    (B, width-1, w) in the model dtype, h: (B, w) f32}."""
    width = cfg.rglru.conv_width
    xb = torch.matmul(x, p["w_x"])
    gb = torch.matmul(x, p["w_g"])
    xc = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    y, h = rglru_scan(p, xc)
    return (_gated_out(p, y, gb, x.dtype),
            {"conv": xb[:, -(width - 1):, :], "h": h})


def rglru_block_step(cfg: ModelConfig, p: dict, x_t: torch.Tensor,
                     state: dict):
    """One decode step. x_t: (B, d_model); state {conv, h}. Returns
    (out (B, d_model), new state)."""
    xb = torch.matmul(x_t, p["w_x"])
    gb = torch.matmul(x_t, p["w_g"])
    xc, conv_state = causal_conv1d_step(xb, state["conv"], p["conv_w"],
                                        p["conv_b"])
    y, h = rglru_step(p, xc, state["h"])
    return _gated_out(p, y, gb, x_t.dtype), {"conv": conv_state, "h": h}
