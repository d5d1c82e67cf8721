"""A Mamba-1 stack (falcon-mamba-7b's registered widths,
arXiv:2410.05355): per layer x + out(y), with y the selective scan of
the block's input after an RMS norm, the in-projection's two halves,
the causal depthwise convolution and silu, the dt / B / C projection
(dt through softplus), the recurrence h_t = exp(dt A) h_(t-1) + dt x B,
the D skip and the silu(z) gate. The recurrence runs step by step in
float32 (no associative scan), one fused multiply-add a step over all
channels and states. The published model's extra RMS norms on B, C and
dt are not in the registered config, so neither side has them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import head, layer, mm, rms_norm


def _dims(m: dict):
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    dt_rank = s.get("dt_rank") or -(-m["d_model"] // 16)
    return d_in, dt_rank, s["state_dim"], s["conv_width"]


def block(m: dict, p: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    d_in, dt_rank, n, width = _dims(m)
    s = h.shape[0]
    xb = mm(h, p["w_in_x"], precision)                     # (S, D)
    z = mm(h, p["w_in_z"], precision)
    conv_w = p["conv_w"].float()
    xc = p["conv_b"].float().expand(s, d_in).clone()
    for k in range(width):
        shift = width - 1 - k                  # tap k sees x[t - shift]
        xc[shift:] += xb[:s - shift] * conv_w[k]
    xc = F.silu(xc)
    xdb = mm(xc, p["w_xproj"], precision)
    dt = F.softplus(mm(xdb[:, :dt_rank], p["w_dt"], precision)
                    + p["b_dt"].float())                  # (S, D)
    b_in, c_in = xdb[:, dt_rank:dt_rank + n], xdb[:, dt_rank + n:]
    a = -torch.exp(p["a_log"].float())                    # (D, N)
    decay = torch.exp(dt[:, :, None] * a)                 # (S, D, N)
    drive = (dt * xc)[:, :, None] * b_in[:, None, :]      # (S, D, N)
    hs = torch.empty_like(decay)
    hs[0] = drive[0]
    for t in range(1, s):
        torch.addcmul(drive[t], decay[t], hs[t - 1], out=hs[t])
    y = torch.einsum("sdn,sn->sd", hs, c_in)
    y = (y + xc * p["d_skip"].float()) * F.silu(z)
    return mm(y, p["w_out"], precision)


@torch.no_grad()
def logits(m: dict, w: dict, tokens: torch.Tensor, n_last: int,
           precision: str = "f32") -> torch.Tensor:
    """Logits (n_last, V) at the last ``n_last`` positions of the
    sequence ``tokens`` (S,)."""
    x = w["embedding"][tokens.long()].float()
    for i in range(m["num_layers"]):
        p = layer(w["layers"], i)
        x = x + block(m, p["ssm"], rms_norm(x, p["norm"]["scale"],
                                            m["norm_eps"]), precision)
    return head(m, w, x[-n_last:], precision)
