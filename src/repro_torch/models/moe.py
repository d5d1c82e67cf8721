"""Mixture-of-experts FFN: the capacity dispatch, the capacity-free
gather dispatch and the per-token decode dispatch.

The port of ``repro/models/moe.py`` on one device (the reference's
``moe_shards`` is 1 there, so the capacity dispatch runs one shard of
every token). Three dispatches compute the same routed SwiGLU mixture:

- ``moe_ffn`` (training and the prefill of capacity configs): each
  (token, choice) takes a slot in its expert's bucket of ``cap`` rows in
  token order; choices past the capacity are dropped. The slot of a
  token depends on every earlier token, so rows are coupled.
- ``moe_ffn_gather`` (``MoEConfig.impl == "gather"``, prefill and
  decode): every expert's SwiGLU runs over every token, through
  ``kernels.ops.fused_swiglu`` (the hand-written kernel on the card, its
  plain version on the CPU), and each token combines its own top k by
  gather. A token's bits depend only on its own hidden state.
- ``moe_ffn_token`` (the decode of capacity configs): each token
  gathers its k experts' weights and runs them alone.

The k expert outputs of a token are summed in choice order (a left
fold from the first choice), as the reference's reduction over the k
axis does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.models.blocking import blocked_rows
from repro_torch.sharding.tp import tp_all_gather, tp_size


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_capacity(mcfg: MoEConfig, tokens_per_shard: int) -> int:
    cap = int(mcfg.top_k * tokens_per_shard / mcfg.num_experts
              * mcfg.capacity_factor)
    return max(_round_up(max(cap, 1), 8), 8)


def _sum_k(t: torch.Tensor) -> torch.Tensor:
    """Sum over axis -2 (the k choices) left to right: (..., k, d) ->
    (..., d)."""
    out = t[..., 0, :]
    for j in range(1, t.shape[-2]):
        out = out + t[..., j, :]
    return out


def router_topk(probs: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs: (..., E) -> (gates (..., k), idx (..., k)); gates renormed.

    ``jax.lax.top_k`` orders equal values by index, lower first; a
    stable descending sort does the same (``torch.topk`` promises no
    order among ties)."""
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    total = gates[..., 0]
    for j in range(1, k):
        total = total + gates[..., j]
    gates = gates / torch.clamp_min(total, 1e-9)[..., None]
    return gates, idx


def load_balance_aux(probs: torch.Tensor, idx: torch.Tensor,
                     num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (f over top-1 choice)."""
    p_mean = probs.reshape(-1, num_experts).mean(dim=0)
    top1 = idx[..., 0].reshape(-1)
    # counts by comparison, not ``bincount``: deterministic on the card
    experts = torch.arange(num_experts, device=idx.device)
    counts = (top1[:, None] == experts).sum(dim=0)
    f = counts.float() / top1.shape[0]
    return num_experts * torch.sum(f * p_mean)


def _router_probs(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """Router softmax in f32 over (T, d) tokens: the products of the
    model dtype summed in f32 (the reference's preferred_element_type)."""
    return torch.softmax(torch.matmul(x.float(), router.float()), dim=-1)


def _swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor) -> torch.Tensor:
    """Plain SwiGLU over the last axis, silu in f32 rounded to x's
    dtype: the reference's einsum math for shared experts and the
    capacity and per-token dispatches."""
    g = torch.matmul(x, wg)
    u = torch.matmul(x, wu)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, wd)


def moe_ffn(cfg: ModelConfig, p: dict,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch. x: (B, S, d) -> (y (B, S, d), aux scalar)."""
    mcfg = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mcfg.num_experts, mcfg.top_k
    cap = moe_capacity(mcfg, t)
    xs = x.reshape(t, d)

    probs = _router_probs(xs, p["router"])
    gates, eidx = router_topk(probs, k)                    # (t, k)
    aux = load_balance_aux(probs, eidx, e)

    # position of each (token, choice) within its expert, in token order
    eflat = eidx.reshape(t * k)
    onehot = torch.nn.functional.one_hot(eflat, e)         # (t*k, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos_in_e, 1, eflat[:, None])[:, 0]
    keep = pos < cap
    sink = torch.full_like(eflat, e * cap)
    slot = torch.where(keep, eflat * cap + pos, sink)      # overflow -> sink

    xrep = xs[:, None, :].expand(t, k, d).reshape(t * k, d)
    # every kept slot receives exactly one row (added to zero, as the
    # reference's scatter-add); dropped rows pile into the sink row
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((slot,), xrep, accumulate=True)
    ebuf = buf[:e * cap].reshape(e, cap, d)

    gate_h = torch.bmm(ebuf, p["w_gate"])
    up_h = torch.bmm(ebuf, p["w_up"])
    h = torch.nn.functional.silu(gate_h.float()).to(x.dtype) * up_h
    out = torch.bmm(h, p["w_down"])                        # (E, cap, d)

    oflat = torch.cat([out.reshape(e * cap, d),
                       torch.zeros((1, d), dtype=out.dtype,
                                   device=out.device)])    # sink row
    yrep = oflat[slot]                                     # (t*k, d)
    w = (gates.reshape(t * k) * keep).to(x.dtype)
    y = _sum_k((yrep * w[:, None]).reshape(t, k, d)).reshape(b, s, d)

    if mcfg.num_shared_experts:
        y = y + _swiglu(x, p["shared_w_gate"], p["shared_w_up"],
                        p["shared_w_down"])
    return y, aux


def _expert_swiglu(xt: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor) -> torch.Tensor:
    """One expert's SwiGLU over flattened tokens xt: (T, d), through
    ``ops.fused_swiglu``.

    A token's bits must not depend on the other tokens of the call.
    The card's kernel tiles rows in fixed blocks whatever T is, so it
    runs once over all T rows; the plain version's matrix products
    choose their tiling by shape, so on the CPU it runs over fixed
    8-row blocks (``models.blocking``), as the reference does
    everywhere.

    Under tensor parallelism w_gate/w_up are column-split and w_down
    replicated, so the hidden must be gathered to full d_ff before the
    down product: the kernel's two stages run around ``tp_all_gather``
    (gate_up on this column's slice, then down with the whole w_down),
    with the same row blocking."""
    cpu = xt.device.type == "cpu"

    def by_rows(fn, a):
        return blocked_rows(fn, a) if cpu else fn(a.contiguous())

    if tp_size() > 1:
        h = tp_all_gather(by_rows(
            lambda xb: ops.swiglu_gate_up(xb, wg, wu), xt))
        return by_rows(lambda hb: ops.swiglu_down(hb, wd), h)
    return by_rows(lambda xb: ops.fused_swiglu(xb, wg, wu, wd), xt)


def moe_ffn_gather(cfg: ModelConfig, p: dict,
                   x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-free top-k MoE for (B, S, d) token batches: every
    expert's SwiGLU over every token, each token combining its own top k
    by gather. Per-token outputs are a function of that token's hidden
    state alone, so they are bit-identical under any batch composition
    or row permutation. Returns (y (B, S, d), aux scalar)."""
    mcfg = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = blocked_rows(lambda xb: _router_probs(xb, p["router"]), xt)
    gates, eidx = router_topk(probs, mcfg.top_k)           # (T, k)
    aux = load_balance_aux(probs, eidx, mcfg.num_experts)

    ye = torch.stack([
        _expert_swiglu(xt, p["w_gate"][i], p["w_up"][i], p["w_down"][i])
        for i in range(mcfg.num_experts)])                 # (E, T, d)
    t = xt.shape[0]
    ysel = ye[eidx, torch.arange(t, device=x.device)[:, None]]  # (T,k,d)
    y = _sum_k(ysel * gates[..., None].to(x.dtype))

    if mcfg.num_shared_experts:
        y = y + _expert_swiglu(xt, p["shared_w_gate"], p["shared_w_up"],
                               p["shared_w_down"])
    return y.reshape(b, s, d), aux


def moe_ffn_token(cfg: ModelConfig, p: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """Decode of capacity configs: each token of x (B, d) gathers its
    top-k experts' weights and runs them alone. Returns (B, d)."""
    mcfg = cfg.moe
    probs = _router_probs(x, p["router"])
    gates, eidx = router_topk(probs, mcfg.top_k)           # (B, k)
    wg = p["w_gate"][eidx]                                 # (B, k, d, f)
    wu = p["w_up"][eidx]
    wd = p["w_down"][eidx]                                 # (B, k, f, d)
    gh = torch.einsum("bd,bkdf->bkf", x, wg)
    uh = torch.einsum("bd,bkdf->bkf", x, wu)
    h = torch.nn.functional.silu(gh.float()).to(x.dtype) * uh
    # tensor parallelism: the gathered experts' w_gate/w_up slices are
    # column-split; gather the hidden to full d_ff_expert before the
    # (replicated) down-projection contracts it
    h = tp_all_gather(h)
    out = torch.einsum("bkf,bkfd->bkd", h, wd)
    y = _sum_k(out * gates[..., None].to(x.dtype))
    if mcfg.num_shared_experts:
        y = y + _swiglu(x, p["shared_w_gate"], p["shared_w_up"],
                        p["shared_w_down"])
    return y


__all__ = ["load_balance_aux", "moe_capacity", "moe_ffn", "moe_ffn_gather",
           "moe_ffn_token", "router_topk"]
