"""A Llama-style dense decoder (deepseek-7b, arXiv:2401.02954): RMS
norms before attention and MLP, rotary embeddings on the two halves of
each head, causal softmax attention, a SwiGLU MLP, an untied head.
float32 throughout (``common.mm``), one layer at a time."""
from __future__ import annotations

import math

import torch

from perfbench.reference.common import head, layer, mm, rms_norm


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (S, H, D): the first and second halves of each head rotated by
    the angle position / theta^(i / (D/2))."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: dict, p: dict, h: torch.Tensor, precision: str):
    s = h.shape[0]
    nh, kv = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // nh
    pos = torch.arange(s, device=h.device)
    q = rope(mm(h, p["wq"], precision).view(s, nh, hd), pos,
             m["rope_theta"])
    k = rope(mm(h, p["wk"], precision).view(s, kv, hd), pos,
             m["rope_theta"])
    v = mm(h, p["wv"], precision).view(s, kv, hd)
    k = k.repeat_interleave(nh // kv, dim=1)
    v = v.repeat_interleave(nh // kv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, nh * hd)
    return mm(o, p["wo"], precision)


def mlp(p: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    g = mm(h, p["w_gate"], precision)
    u = mm(h, p["w_up"], precision)
    return mm(torch.nn.functional.silu(g) * u, p["w_down"], precision)


@torch.no_grad()
def logits(m: dict, w: dict, tokens: torch.Tensor, n_last: int,
           precision: str = "f32") -> torch.Tensor:
    """Logits (n_last, V) at the last ``n_last`` positions of the
    sequence ``tokens`` (S,)."""
    x = w["embedding"][tokens.long()].float()
    eps = m["norm_eps"]
    for i in range(m["num_layers"]):
        p = layer(w["layers"], i)
        x = x + attention(m, p["attn"], rms_norm(x, p["attn_norm"]["scale"],
                                                 eps), precision)
        x = x + mlp(p["mlp"], rms_norm(x, p["mlp_norm"]["scale"], eps),
                    precision)
    return head(m, w, x[-n_last:], precision)
