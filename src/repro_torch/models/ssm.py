"""Mamba-1 selective state-space block: the full-sequence forward, the
serving prefill and the decode step.

The port of ``repro/models/ssm.py``. ``mamba_block`` takes the
reference's kernel path (its ``use_pallas`` branch): the scan goes
through ``kernels.ops.selective_scan``, the hand-written Hopper kernel
on the card and its plain version on the CPU, and is differentiable, so
training runs through it. The serving functions follow the reference's
own path, which reaches no Pallas kernel: ``mamba_prefill`` runs the
plain chunked scan (``selective_scan``: a sequential walk over chunks,
an associative scan inside each, reference ``ssm.py:136``) and
``mamba_step`` one recurrence step, both as torch ops on whatever
device holds the tensors. Routing the prefill through the selective
scan kernel, which computes the same recurrence, is later performance
work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    causal_conv1d, causal_conv1d_step, linear_recurrence_scan)


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    assert s is not None
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.state_dim


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b_in: torch.Tensor, c_in: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective scan, the reference's plain version.

    x, dt: (B, S, D); a_log: (D, N); b_in, c_in: (B, S, N); h0: an
    optional (B, D, N) initial state. Chunks of ``chunk`` steps (the
    whole sequence when S is off that grid) are walked in order; inside
    a chunk the recurrence runs as the reference's associative scan.
    Returns y (B, S, D) and h_final (B, D, N), all f32."""
    bsz, s, d = x.shape
    n = a_log.shape[1]
    if s % chunk != 0:
        chunk = s
    a = -torch.exp(a_log.float())                          # (D, N), < 0
    xf, dtf, bf, cf = x.float(), dt.float(), b_in.float(), c_in.float()
    h = (torch.zeros((bsz, d, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xb, dtb, bb, cb = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        dta = torch.exp(dtb[..., None] * a)                # (B, c, D, N)
        u = (dtb * xb)[..., None] * bb[:, :, None, :]      # (B, c, D, N)
        a_s, u_s = linear_recurrence_scan(dta, u, dim=1)
        hs = a_s * h[:, None] + u_s
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, cb))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def selective_scan_step(x_t: torch.Tensor, dt_t: torch.Tensor,
                        a_log: torch.Tensor, b_t: torch.Tensor,
                        c_t: torch.Tensor, h: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t, dt_t: (B, D); b_t, c_t: (B, N); h:
    (B, D, N) f32. Returns (y (B, D), h_new), f32."""
    a = -torch.exp(a_log.float())
    dta = torch.exp(dt_t.float()[..., None] * a)                # (B, D, N)
    u = (dt_t * x_t).float()[..., None] * b_t.float()[:, None, :]
    h_new = dta * h + u
    y = torch.einsum("bdn,bn->bd", h_new, c_t.float())
    return y, h_new


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


def _gated_out(p: dict, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The block's output from the scan's f32 y: the skip term, the
    silu(z) gate and the output projection."""
    y = y + xc.float() * p["d_skip"].float()
    y = y * F.silu(z.float())
    return torch.matmul(y.to(dtype), p["w_out"])


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba block. x: (B, S, d_model)."""
    xb = torch.matmul(x, p["w_in_x"])
    z = torch.matmul(x, p["w_in_z"])
    xc = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    dt, b_in, c_in = _proj_inputs(cfg, p, xc)
    y, _ = ops.selective_scan(xc, dt, p["a_log"], b_in.contiguous(),
                              c_in.contiguous())
    return _gated_out(p, y.float(), xc, z, x.dtype)


def mamba_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Like ``mamba_block`` but through the plain chunked scan, also
    returning the decode state {conv: the last width-1 pre-activation
    taps (B, width-1, d_in) in the model dtype, h: (B, d_in, N) f32}."""
    width = cfg.ssm.conv_width
    xb = torch.matmul(x, p["w_in_x"])
    z = torch.matmul(x, p["w_in_z"])
    xc = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    dt, b_in, c_in = _proj_inputs(cfg, p, xc)
    y, h = selective_scan(xc, dt, p["a_log"], b_in, c_in,
                          chunk=cfg.ssm.chunk)
    out = _gated_out(p, y, xc, z, x.dtype)
    return out, {"conv": xb[:, -(width - 1):, :], "h": h}


def mamba_step(cfg: ModelConfig, p: dict, x_t: torch.Tensor, state: dict):
    """One decode step. x_t: (B, d_model); state {conv, h}. Returns
    (out (B, d_model), new state)."""
    xb = torch.matmul(x_t, p["w_in_x"])
    z = torch.matmul(x_t, p["w_in_z"])
    xc, conv_state = causal_conv1d_step(xb, state["conv"], p["conv_w"],
                                        p["conv_b"])
    xc = F.silu(xc.float()).to(x_t.dtype)
    dt, b_t, c_t = _proj_inputs(cfg, p, xc)
    y, h = selective_scan_step(xc, dt, p["a_log"], b_t, c_t, state["h"])
    return _gated_out(p, y, xc, z, x_t.dtype), {"conv": conv_state, "h": h}
