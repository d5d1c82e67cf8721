"""Mamba-1 selective state-space block: the full-sequence forward.

The port of ``repro/models/ssm.py``'s ``mamba_block`` on its kernel
path (the reference's ``use_pallas`` branch): the scan goes through
``kernels.ops.selective_scan``, the hand-written Hopper kernel on the
card and its plain version on the CPU, and is differentiable, so
training runs through it. The serving functions (``mamba_prefill``,
``mamba_step``) and the chunked associative scan are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    assert s is not None
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.state_dim


def _proj_inputs(cfg: ModelConfig, p: dict, xc: torch.Tensor):
    """Shared dt/B/C projection from the conv output; dt in f32."""
    d_in, dt_rank, n = ssm_dims(cfg)
    xdb = torch.matmul(xc, p["w_xproj"])
    dt_low = xdb[..., :dt_rank]
    b_in = xdb[..., dt_rank:dt_rank + n]
    c_in = xdb[..., dt_rank + n:]
    dt = F.softplus(torch.matmul(dt_low, p["w_dt"]).float()
                    + p["b_dt"].float())
    return dt, b_in, c_in


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba block. x: (B, S, d_model)."""
    xb = torch.matmul(x, p["w_in_x"])
    z = torch.matmul(x, p["w_in_z"])
    xc = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    dt, b_in, c_in = _proj_inputs(cfg, p, xc)
    y, _ = ops.selective_scan(xc, dt, p["a_log"], b_in.contiguous(),
                              c_in.contiguous())
    y = y.float()
    y = y + xc.float() * p["d_skip"].float()
    y = y * F.silu(z.float())
    return torch.matmul(y.to(x.dtype), p["w_out"])
