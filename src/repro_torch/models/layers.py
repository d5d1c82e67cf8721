"""Shared neural-net layers: norms, RoPE, MLPs, the causal conv,
embeddings.

Pure functions over plain dict params (torch tensors), mirroring the
reference's ``repro/models/layers.py`` so each counterpart is found by
name.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.blocking import blocked_rows
from repro_torch.sharding.tp import tp_all_gather


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The reference's formula in f32: the mean, then the mean of the
    squared deviations, then ``rsqrt(var + eps)`` (not
    ``F.layer_norm``, whose reduction differs)."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32, device=device) / half
    # a Python-scalar base: no host-to-device copy (which would
    # synchronise the stream on every call)
    return 1.0 / torch.pow(float(theta), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, device=x.device)   # (half,)
    ang = positions[..., None].float() * inv                # (..., seq, half)
    sin = torch.sin(ang)[..., None, :]                      # (..., seq, 1, half)
    cos = torch.cos(ang)[..., None, :]
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                    dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# projections against column-split weights
# ----------------------------------------------------------------------
def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) for a weight that tensor parallelism splits
    by columns (``sharding/tp.py``'s ``_COL_PARALLEL``: wq, wk, wv, the
    decode MLP's w_gate / w_up, an untied lm_head): every such product
    goes through ``ops.projection``, whose kernel gives a column the
    same bits whatever the columns beside it, so one device and each
    model column of the mesh compute the same values. On the CPU it is
    ``torch.matmul``."""
    return ops.projection(x, w)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------
def swiglu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SwiGLU MLP: params {w_gate, w_up, w_down}; x (..., d).

    Runs over fixed-shape token blocks (``models.blocking``) so each
    token's bits are independent of batch composition. The decode MLP
    takes this path; the prefill MLP goes through the fused kernel
    (``transformer.mlp_apply``). g and u are ``project``'s (column-split
    weights); silu(g) rounds to x's dtype before the multiply by u.
    """
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]

    def blk(xb: torch.Tensor) -> torch.Tensor:
        g = project(xb, wg)
        u = project(xb, wu)
        h = torch.nn.functional.silu(g.float()).to(xb.dtype) * u
        # under tensor parallelism w_gate/w_up are column-split and
        # w_down is replicated: gather the hidden back to full d_ff so
        # the down-projection contracts full-length (bit-exact)
        h = tp_all_gather(h)
        return torch.matmul(h, wd)

    xt = x.reshape(-1, x.shape[-1])
    return blocked_rows(blk, xt).reshape(x.shape)


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """2-matmul GELU MLP (whisper): params {w_in, b_in, w_out, b_out};
    x (..., d). The GELU is the tanh form in f32 (``jax.nn.gelu``'s
    default, not torch's erf default), cast back to x's dtype."""
    h = torch.matmul(x, params["w_in"]) + params["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, params["w_out"]) + params["b_out"]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv via shifted adds, summed in f32 and cast to
    x's dtype at the end.

    x: (B, S, C); w: (width, C); bias: (C,).
    """
    width = w.shape[0]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(width):
        shift = width - 1 - k   # tap k sees x[t - shift]
        xs = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xs.float() * w[k].float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None):
    """Single decode step. x_t: (B, C); conv_state: (B, width-1, C)
    holding the previous taps. Returns (out (B, C) in x_t's dtype, new
    state (B, width-1, C)). The taps sum in f32 in tap order, an
    elementwise loop, so a row's bits never depend on the batch."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)
    wf = w.float()
    out = window[:, 0].float() * wf[0]
    for k in range(1, w.shape[0]):
        out = out + window[:, k].float() * wf[k]
    if bias is not None:
        out = out + bias.float()
    return out.to(x_t.dtype), window[:, 1:, :]


def linear_recurrence_scan(a: torch.Tensor, u: torch.Tensor,
                           dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t * h_{t-1} + u_t (h_{-1} = 0) along
    ``dim``: returns (prod of a up to t, h_t), both a's shape.

    The same odd/even recursion ``jax.lax.associative_scan`` runs with
    the combine (al, ul), (ar, ur) -> (al * ar, ul * ar + ur): pairs are
    combined, the half-length sequence is scanned, and the even
    positions are filled in, so every element takes the reference's
    sequence of multiplies and adds. Elementwise ops only."""
    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    def comb(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    def scan(el):
        n = el[0].shape[dim]
        if n < 2:
            return el
        odd = scan(comb([sl(e, 0, -1, 2) for e in el],
                        [sl(e, 1, None, 2) for e in el]))
        left = [sl(e, 0, -1) for e in odd] if n % 2 == 0 else odd
        even = comb(left, [sl(e, 2, None, 2) for e in el])
        out = []
        for e, ev, od in zip(el, even, odd):
            full = torch.empty_like(e)
            sl(full, 0, None, 2).copy_(torch.cat([sl(e, 0, 1), ev], dim))
            sl(full, 1, None, 2).copy_(od)
            out.append(full)
        return out

    a_s, h = scan([a, u])
    return a_s, h


def embed_tokens(embedding: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """embedding (V, d); tokens (...) int -> (..., d)."""
    return embedding[tokens.long()]


def lm_head(params: dict, x: torch.Tensor,
            tie_embeddings: bool) -> torch.Tensor:
    if tie_embeddings:
        return torch.matmul(x, params["embedding"].t())
    # an untied lm_head is vocab-column-split under tensor parallelism;
    # tied logits contract the replicated embedding and are already
    # full-vocab
    return tp_all_gather(project(x, params["lm_head"]))
