"""GQA attention: full-sequence attention for training, one-shot
prefill over the whole prompt, single-token decode against a contiguous
cache (dense or int8, linear or ring), and the paged variants the
step-level loop runs (chunked prefill and decode over dense or int8
pages, decode over ring pages).

The port of the GQA and MLA functions of ``repro/models/attention.py``
(MLA: DeepSeek-V2's multi-head latent attention, full-sequence and the
absorbed-form decode over its latent cache, both plain PyTorch as the
reference leaves them outside any kernel; and whisper's cross-attention
over the encoder's K/V, plain PyTorch too).
Linear-cache decode and chunked-prefill attention go through
``kernels.ops``: the hand-written Hopper kernels on the card, their
plain PyTorch versions on the CPU. One-shot prefill attention and ring
(sliding-window) decode are plain PyTorch on every device, as the
reference leaves them to XLA outside any kernel (its ring decode takes
the plain path, reference ``attention.py:284``).

Caches and pages are updated in place: where the reference returns new
arrays from ``dynamic_update_slice`` or ``.at[].set``, the port writes
the token's (or the chunk's) K/V into the given tensors and returns
them. The write and the kernel that reads it run on one stream, so the
write is complete before the kernel reads it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, project, rms_norm
from repro_torch.sharding.tp import tp_all_gather

_NEG_INF = -1e30
# one-shot prefill switches to blockwise online softmax at this block
# (flash_attention); chunked prefill is held to the one-shot path only
# off that grid (transformer.prefill_chunk_paged)
_FLASH_BLOCK = 512


def _inv_sqrt(dk: int) -> float:
    """1/sqrt(dk) in f32, as the reference computes its scale; a Python
    scalar keeps the call free of host-to-device copies."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dk)))


# ======================================================================
# core attention math
# ======================================================================
def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Reference path for short sequences.

    q: (B,Sq,H,Dk); k: (B,Sk,KV,Dk); v: (B,Sk,KV,Dv);
    mask: (Sq,Sk) or (B,Sq,Sk) bool (True = attend).
    Returns (B,Sq,H,Dv).
    """
    b, sq, h, dk = q.shape
    kv = k.shape[2]
    g = h // kv
    qr = q.reshape(b, sq, kv, g, dk)
    # scores accumulate in f32 (the reference's preferred_element_type)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr.float(),
                          k.float()) * _inv_sqrt(dk)
    m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = scores.masked_fill(~m, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    *, causal: bool = True, window: Optional[int] = None,
                    block: int = _FLASH_BLOCK) -> torch.Tensor:
    """Blockwise online-softmax attention over key blocks of ``block``
    positions; a key axis off that grid (or within one block) takes
    ``full_attention``, as in the reference.

    q: (B,Sq,H,Dk); k: (B,Sk,KV,Dk); v: (B,Sk,KV,Dv);
    q_positions: (Sq,) int; k_positions: (Sk,) int.
    """
    b, sq, h, dk = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kv
    if sk % block != 0 or sk <= block:
        mask = _make_mask(q_positions, k_positions, causal, window)
        return full_attention(q, k, v, mask)

    qr = q.reshape(b, sq, kv, g, dk).float() * _inv_sqrt(dk)
    m = torch.full((b, kv, g, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros((b, kv, g, sq), dtype=torch.float32,
                        device=q.device)
    acc = torch.zeros((b, kv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for j in range(sk // block):
        sl = slice(j * block, (j + 1) * block)
        kb, vb, kp = k[:, sl], v[:, sl], k_positions[sl]
        s = torch.einsum("bqkgd,bskd->bkgqs", qr, kb.float())
        s = s.masked_fill(~_make_mask(q_positions, kp, causal, window),
                          _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vb.float())
        m = m_new
    out = acc / torch.clamp_min(l_sum, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def _make_mask(q_positions: torch.Tensor, k_positions: torch.Tensor,
               causal: bool, window: Optional[int]) -> torch.Tensor:
    m = torch.ones((q_positions.shape[0], k_positions.shape[0]),
                   dtype=torch.bool, device=q_positions.device)
    if causal:
        m &= q_positions[:, None] >= k_positions[None, :]
    if window is not None:
        m &= (q_positions[:, None] - k_positions[None, :]) < window
    return m


# ======================================================================
# int8 KV cache (symmetric per-vector quantization over head_dim)
# ======================================================================
def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 codes (..., D), f32 scale (...,)).

    Symmetric per-vector quantisation: scale = max|x| * (1/127) over the
    head dim (a multiply by the f32 reciprocal, as the reference keeps
    it, never a divide by 127), codes = round-half-even(x / scale)
    clipped to +-127.
    """
    xf = x.float()
    amax = torch.abs(xf).amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) * float(np.float32(1.0 / 127.0))
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def gqa_project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B,S,d) -> q (B,S,H,Dh), k/v (B,S,KV,Dh)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = project(x, p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = project(x, p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = project(x, p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def gqa_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence GQA attention (training and scoring). x: (B,S,d);
    positions: (S,) int. Plain PyTorch, as the reference leaves it to
    XLA outside any kernel."""
    q, k, v = gqa_project_qkv(cfg, p, x)
    if cfg.use_rope:
        q = apply_rope(q, positions[None], cfg.rope_theta)
        k = apply_rope(k, positions[None], cfg.rope_theta)
    out = flash_attention(q, k, v, positions, positions, causal=causal,
                          window=window)
    b, s = x.shape[:2]
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return torch.matmul(out, p["wo"])


def _decode_qkv(cfg: ModelConfig, p: dict, x_t: torch.Tensor,
                positions: torch.Tensor):
    """Project one token per row and rope it: x_t (B, d) ->
    q (B, H, Dh), k/v (B, KV, Dh); positions broadcasts to (B, 1)."""
    b = x_t.shape[0]
    hd = cfg.resolved_head_dim
    q = project(x_t, p["wq"]).reshape(b, cfg.num_heads, hd)
    k = project(x_t, p["wk"]).reshape(b, cfg.num_kv_heads, hd)
    v = project(x_t, p["wv"]).reshape(b, cfg.num_kv_heads, hd)
    if cfg.use_rope:
        q = apply_rope(q[:, None], positions, cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], positions, cfg.rope_theta)[:, 0]
    return q, k, v


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_positions: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a cache whose slots hold the
    absolute positions ``k_positions``: the reference's plain
    ``decode_attention``, the path of its ring (sliding-window) decode,
    which reaches no Pallas kernel (reference ``attention.py:284``).

    q: (B,H,Dk); k_cache: (B,S,KV,Dk); v_cache: (B,S,KV,Dv);
    k_positions: (S,) or (B,S) int — the absolute position each slot
    holds (negative = empty); pos: scalar or (B,) int current position.
    A slot attends when 0 <= its position <= pos. As in the reference,
    the scaled query is rounded to the cache dtype and the
    probabilities to the value dtype before each f32 contraction.
    Returns (B,H,Dv)."""
    b, h, dk = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    qr = (q.reshape(b, kv, g, dk).float() * _inv_sqrt(dk)).to(
        k_cache.dtype)
    scores = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float())
    kp = k_positions if k_positions.dim() == 2 else k_positions[None]
    p_col = pos[:, None] if pos.dim() else pos
    valid = (kp >= 0) & (kp <= p_col)                     # (1|B, S)
    scores = scores.masked_fill(~valid[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, v_cache.shape[-1]).to(q.dtype)


def decode_attention_quant(q: torch.Tensor, k_codes: torch.Tensor,
                           k_scale: torch.Tensor, v_codes: torch.Tensor,
                           v_scale: torch.Tensor, k_positions: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """``decode_attention`` against an int8 cache, the reference's plain
    ``decode_attention_quant`` (its ring path for an int8 cache): the
    scales fold into the scores and the probabilities.

    q: (B,H,Dk); k_codes/v_codes: (B,S,KV,D) int8; k_scale/v_scale:
    (B,S,KV) f32; k_positions: (S,) int; pos: scalar or (B,) int."""
    b, h, dk = q.shape
    kv = k_codes.shape[2]
    g = h // kv
    qr = q.reshape(b, kv, g, dk).float() * _inv_sqrt(dk)
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k_codes.float())
    scores = scores * k_scale.permute(0, 2, 1)[:, :, None, :]
    p_col = pos[:, None] if pos.dim() else pos
    valid = (k_positions[None] >= 0) & (k_positions[None] <= p_col)
    scores = scores.masked_fill(~valid[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    pv = probs * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", pv, v_codes.float())
    return out.reshape(b, h, v_codes.shape[-1]).to(q.dtype)


def ring_positions(pos_rows: torch.Tensor, cache_len: int) -> torch.Tensor:
    """The absolute position each slot of a ring of ``cache_len`` slots
    holds at (B,) positions ``pos_rows`` (slot = position mod
    cache_len): (B, cache_len)."""
    slots = torch.arange(cache_len, device=pos_rows.device)[None]
    p = pos_rows.long()[:, None]
    return p - torch.remainder(p - slots, cache_len)


def gqa_decode(cfg: ModelConfig, p: dict, x_t: torch.Tensor, cache: dict,
               pos: int, *, ring: bool = False
               ) -> Tuple[torch.Tensor, dict]:
    """Single-token GQA decode over a contiguous cache.

    x_t: (B, d); cache: one layer's {k, v} (B, S, KV, Dh) in the model
    dtype, or the int8 cache {k, v} int8 codes plus {k_scale, v_scale}
    (B, S, KV) f32, updated in place; pos: the wave's current position
    (a Python int, one for every row). A linear cache takes the token's
    K/V (quantised by ``quantize_kv`` for the int8 cache) at slot
    ``pos`` and attends the ``pos + 1`` valid slots through the
    dense-cache kernel or the int8 one. With ``ring=True`` (a
    sliding-window layer, cache length min(seq_len, window)) the slot
    is ``pos mod S`` and attention masks by the absolute position each
    slot holds, through the plain ``decode_attention`` (or
    ``decode_attention_quant``), as the reference's ring path runs with
    no kernel. Returns (y (B, d), cache).
    """
    b = x_t.shape[0]
    hd = cfg.resolved_head_dim
    pos = int(pos)
    positions = torch.full((1, 1), pos, dtype=torch.int64,
                           device=x_t.device)
    q, k, v = _decode_qkv(cfg, p, x_t, positions)
    q = q.contiguous()
    s_cache = cache["k"].shape[1]
    slot = pos % s_cache if ring else pos
    if ring:
        k_positions = ring_positions(positions[0], s_cache)[0]
        pos_t = positions[0, 0]
    if "k_scale" in cache:                 # int8-quantised cache
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache["k"][:, slot] = kq
        cache["v"][:, slot] = vq
        cache["k_scale"][:, slot] = ks
        cache["v_scale"][:, slot] = vs
        if ring:
            out = decode_attention_quant(
                q, cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], k_positions, pos_t)
        else:
            out = ops.decode_attention_quant(
                q, cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], pos + 1)
    else:
        cache["k"][:, slot] = k.to(cache["k"].dtype)
        cache["v"][:, slot] = v.to(cache["v"].dtype)
        if ring:
            out = decode_attention(q, cache["k"], cache["v"], k_positions,
                                   pos_t)
        else:
            out = ops.decode_attention(q, cache["k"], cache["v"], pos + 1)
    y = torch.matmul(out.reshape(b, cfg.num_heads * hd), p["wo"])
    return y, cache


def _page_slots(block_table: torch.Tensor, pos_rows: torch.Tensor,
                page_size: int):
    """(page id, slot) of each row's write position."""
    pos_l = pos_rows.long()
    page_ids = torch.gather(block_table.long(), 1,
                            (pos_l // page_size)[:, None])[:, 0]
    return page_ids, pos_l % page_size


def gqa_decode_paged(cfg: ModelConfig, p: dict, x_t: torch.Tensor,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     block_table: torch.Tensor, pos: torch.Tensor, *,
                     cache_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token GQA decode against a paged KV cache.

    x_t: (B, d); k_pages/v_pages: (P, page_size, KV, Dh) — one layer's
    slice of the page pool, updated in place; block_table: (B, NB)
    int32 page ids; pos: scalar, or (B,) per-row positions (step-level
    serving mixes rows at different depths in one decode batch);
    cache_len: the dense-equivalent cache length (prompt + max_new),
    kept for the reference's signature — the kernel masks by
    ``pos + 1`` per row. Returns (y (B, d), k_pages, v_pages).
    """
    b = x_t.shape[0]
    hd = cfg.resolved_head_dim
    pos_rows = pos.expand(b) if pos.dim() == 0 else pos
    q, k, v = _decode_qkv(cfg, p, x_t, pos_rows[:, None])
    page_ids, slot = _page_slots(block_table, pos_rows, k_pages.shape[1])
    k_pages[page_ids, slot] = k.to(k_pages.dtype)
    v_pages[page_ids, slot] = v.to(v_pages.dtype)

    lengths = (pos_rows + 1).to(torch.int32).contiguous()
    out = ops.paged_decode_attention(q.contiguous(), k_pages, v_pages,
                                     block_table, lengths)
    # tensor parallelism: gather head-local attention outputs to the
    # full head axis before the replicated output projection
    out = tp_all_gather(out.reshape(b, cfg.num_heads * hd))
    y = torch.matmul(out, p["wo"])
    return y, k_pages, v_pages


def gqa_decode_quant_paged(cfg: ModelConfig, p: dict, x_t: torch.Tensor,
                           pages: dict, block_table: torch.Tensor,
                           pos: torch.Tensor, *, cache_len: int
                           ) -> Tuple[torch.Tensor, dict]:
    """Single-token GQA decode against int8-quantised KV pages.

    x_t: (B, d); pages: one layer's slice of the quant pool — {k, v}
    (P, page_size, KV, Dh) int8 codes and {k_scale, v_scale}
    (P, page_size, KV) f32 per-vector scales, updated in place;
    block_table: (B, NB) int32 page ids; pos: scalar or (B,) per-row
    positions; cache_len: kept for the reference's signature. The
    token's K/V quantise through the same ``quantize_kv`` as the dense
    int8 cache; the int8 paged kernel reads codes and scales in place
    and masks by ``pos + 1`` per row. Returns (y (B, d), pages).
    """
    b = x_t.shape[0]
    hd = cfg.resolved_head_dim
    pos_rows = pos.expand(b) if pos.dim() == 0 else pos
    q, k, v = _decode_qkv(cfg, p, x_t, pos_rows[:, None])
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    page_ids, slot = _page_slots(block_table, pos_rows,
                                 pages["k"].shape[1])
    pages["k"][page_ids, slot] = kq
    pages["v"][page_ids, slot] = vq
    pages["k_scale"][page_ids, slot] = ks
    pages["v_scale"][page_ids, slot] = vs

    lengths = (pos_rows + 1).to(torch.int32).contiguous()
    out = ops.paged_decode_attention_quant(
        q.contiguous(), pages["k"], pages["k_scale"], pages["v"],
        pages["v_scale"], block_table, lengths)
    out = tp_all_gather(out.reshape(b, cfg.num_heads * hd))
    y = torch.matmul(out, p["wo"])
    return y, pages


def gqa_decode_ring_paged(cfg: ModelConfig, p: dict, x_t: torch.Tensor,
                          pages: dict, block_table: torch.Tensor,
                          pos: torch.Tensor, *, cache_len: int
                          ) -> Tuple[torch.Tensor, dict]:
    """Single-token sliding-window GQA decode against ring pages.

    x_t: (B, d); pages: one layer's {k, v} (P, page_size, KV, Dh),
    updated in place; block_table: (B, NB) page ids covering exactly
    ceil(cache_len / page_size) pages; pos: scalar or (B,) positions;
    cache_len: the ring length, min(prompt + max_new, window). The
    pages hold the ring the contiguous path keeps (slot = position mod
    cache_len): the token's K/V land at each row's slot, the row's pages
    are gathered to a (B, cache_len) view and attended through the plain
    ``decode_attention`` by the absolute position each slot holds, as
    the reference's ring path runs with no kernel. Ring pages are
    private to their lane (forked whole, never shared), so the write in
    place is safe. Returns (y (B, d), pages)."""
    b = x_t.shape[0]
    hd = cfg.resolved_head_dim
    kv = cfg.num_kv_heads
    pos_rows = pos.expand(b) if pos.dim() == 0 else pos
    q, k, v = _decode_qkv(cfg, p, x_t, pos_rows[:, None])
    ps = pages["k"].shape[1]
    slot = torch.remainder(pos_rows.long(), cache_len)
    page_ids = torch.gather(block_table.long(), 1,
                            (slot // ps)[:, None])[:, 0]
    offset = slot % ps
    pages["k"][page_ids, offset] = k.to(pages["k"].dtype)
    pages["v"][page_ids, offset] = v.to(pages["v"].dtype)

    table = block_table.long()
    k_cache = pages["k"][table].reshape(b, -1, kv, hd)[:, :cache_len]
    v_cache = pages["v"][table].reshape(b, -1, kv, hd)[:, :cache_len]
    out = decode_attention(q, k_cache, v_cache,
                           ring_positions(pos_rows, cache_len), pos_rows)
    out = tp_all_gather(out.reshape(b, cfg.num_heads * hd))
    y = torch.matmul(out, p["wo"])
    return y, pages


def gqa_prefill_chunk_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                            k_pages: torch.Tensor, v_pages: torch.Tensor,
                            block_table: torch.Tensor,
                            start_pos: torch.Tensor, *, prompt_len: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One layer's chunked-prefill GQA attention against paged KV.

    x: (B, C, d) hidden states of each row's chunk covering absolute
    positions [start_pos[b], start_pos[b] + C); start_pos: (B,) per-row
    chunk offsets, so rows at different prefill depths share one
    launch; k_pages/v_pages: (P, page_size, KV, Dh) one layer's
    page-pool slice, updated in place; block_table: (B, NB) int32 page
    ids covering at least ``prompt_len`` positions. Writes the chunk's
    rope'd K/V into the pages, then attends the chunk queries causally
    over the pages up to the static ``prompt_len``. Returns
    (y (B, C, d), k_pages, v_pages).
    """
    b, c, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = (start_pos.long()[:, None]
                 + torch.arange(c, device=x.device)[None])     # (B, C)
    q, k, v = gqa_project_qkv(cfg, p, x)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    # the chunk's K/V go into the pages first, so attention reads every
    # key (prefix and self) from the storage the decode steps will read
    ps = k_pages.shape[1]
    page_ids = torch.gather(block_table.long(), 1, positions // ps)
    slots = positions % ps
    k_pages[page_ids, slots] = k.to(k_pages.dtype)
    v_pages[page_ids, slots] = v.to(v_pages.dtype)

    out = ops.chunked_prefill_attention(
        q.contiguous(), k_pages, v_pages, block_table,
        positions.to(torch.int32), prompt_len=prompt_len)
    out = tp_all_gather(out.reshape(b, c, cfg.num_heads * hd))
    y = torch.matmul(out, p["wo"])
    return y, k_pages, v_pages


# ======================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
# ======================================================================
def _mla_dims(cfg: ModelConfig):
    m = cfg.mla
    return (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim)


def mla_project_q(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (..., d) -> q_nope (..., H, nope), q_rope (..., H, rope)."""
    _, _, nope, rope, _ = _mla_dims(cfg)
    q_a = rms_norm(torch.matmul(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = torch.matmul(q_a, p["wq_b"])
    q = q.reshape(*x.shape[:-1], cfg.num_heads, nope + rope)
    return q[..., :nope], q[..., nope:]


def mla_project_kv_latent(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (..., d) -> c_kv (..., kv_lora) [normed], k_rope (..., rope)."""
    _, kvl, _, _, _ = _mla_dims(cfg)
    kv_a = torch.matmul(x, p["wkv_a"])
    c_kv = rms_norm(kv_a[..., :kvl], p["kv_norm"], cfg.norm_eps)
    return c_kv, kv_a[..., kvl:]


def mla_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA (training and prefill): per-head K/V expanded
    from the latent, then causal attention (``flash_attention``) with
    head dims dk = nope + rope for q and k and dv for v, scaled by
    1/sqrt(nope + rope). x: (B, S, d); positions: (S,) int."""
    _, _, nope, rope, vdim = _mla_dims(cfg)
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = mla_project_q(cfg, p, x)
    q_rope = apply_rope(q_rope, positions[None], cfg.rope_theta)
    c_kv, k_rope = mla_project_kv_latent(cfg, p, x)
    k_rope = apply_rope(k_rope[:, :, None], positions[None],
                        cfg.rope_theta)                     # (B,S,1,rope)
    k_nope = torch.matmul(c_kv, p["wk_b"]).reshape(b, s, h, nope)
    v = torch.matmul(c_kv, p["wv_b"]).reshape(b, s, h, vdim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
    out = flash_attention(q, k, v, positions, positions, causal=True)
    return torch.matmul(out.reshape(b, s, h * vdim), p["wo"])


def mla_decode(cfg: ModelConfig, p: dict, x_t: torch.Tensor, cache: dict,
               pos: int) -> Tuple[torch.Tensor, dict]:
    """Absorbed-form MLA decode against the latent cache, in f32 as the
    reference computes it: W_uk is folded into the query and W_uv
    applied after the latent context, so per-head K/V of the history are
    never formed.

    x_t: (B, d); cache: {c_kv (B, S, kv_lora), k_rope (B, S, rope)},
    written in place at ``pos`` (one Python int for the batch). Slots
    past ``pos`` are masked. Returns (y (B, d), cache)."""
    _, kvl, nope, rope, vdim = _mla_dims(cfg)
    b = x_t.shape[0]
    h = cfg.num_heads
    pos_b = torch.full((1, 1), pos, dtype=torch.long, device=x_t.device)
    q_nope, q_rope = mla_project_q(cfg, p, x_t)             # (B,H,.)
    q_rope = apply_rope(q_rope[:, None], pos_b, cfg.rope_theta)[:, 0]
    c_kv_t, k_rope_t = mla_project_kv_latent(cfg, p, x_t)   # (B,.)
    k_rope_t = apply_rope(k_rope_t[:, None, None], pos_b,
                          cfg.rope_theta)[:, 0, 0]
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    c_cache[:, pos] = c_kv_t.to(c_cache.dtype)
    r_cache[:, pos] = k_rope_t.to(r_cache.dtype)

    wk_b = p["wk_b"].reshape(kvl, h, nope).float()
    wv_b = p["wv_b"].reshape(kvl, h, vdim).float()
    q_c = torch.einsum("bhn,khn->bhk", q_nope.float(), wk_b)
    c32 = c_cache.float()
    scores = (torch.einsum("bhk,bsk->bhs", q_c, c32)
              + torch.einsum("bhr,bsr->bhs", q_rope.float(),
                             r_cache.float())) * _inv_sqrt(nope + rope)
    valid = torch.arange(c_cache.shape[1], device=x_t.device) <= pos
    scores = scores.masked_fill(~valid[None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx_c = torch.einsum("bhs,bsk->bhk", probs, c32)        # (B,H,kv_lora)
    out = torch.einsum("bhk,khv->bhv", ctx_c, wv_b)         # (B,H,vdim)
    out = out.reshape(b, h * vdim).to(x_t.dtype)
    return torch.matmul(out, p["wo"]), cache


# ======================================================================
# Cross attention (whisper decoder)
# ======================================================================
def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor
                    ) -> torch.Tensor:
    """Decoder queries over the encoder's K/V, every frame attended
    (``full_attention`` with an all-true mask; plain PyTorch, as the
    reference leaves it outside any kernel). x: (B, S, d) or (B, d);
    enc_k/enc_v: (B, F, KV, Dh), precomputed by ``cross_kv``."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, None]
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = project(x, p["wq"]).reshape(b, s, cfg.num_heads, hd)
    mask = torch.ones((s, enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = full_attention(q, enc_k, enc_v, mask)
    y = torch.matmul(out.reshape(b, s, cfg.num_heads * hd), p["wo"])
    return y[:, 0] if squeeze else y


def cross_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor):
    """Cross-attention K/V (B, F, KV, Dh) each from the encoder's output
    (B, F, d)."""
    b, f, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = project(enc_out, p["wk"]).reshape(b, f, cfg.num_kv_heads, hd)
    v = project(enc_out, p["wv"]).reshape(b, f, cfg.num_kv_heads, hd)
    return k, v
