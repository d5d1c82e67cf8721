"""GQA attention against paged KV: projections, chunked prefill and
single-token decode.

The port of the dense GQA functions of ``repro/models/attention.py``
that the step-level serving loop runs. Attention itself goes through
``kernels.ops``: the hand-written Hopper kernels on the card, their
plain PyTorch versions on the CPU.

Pages are updated in place: where the reference returns new page arrays
from ``.at[].set``, the port writes the token's (or the chunk's) K/V
into the layer's page slice with ``index_put_`` and returns the same
tensors. The write and the kernel that reads it run on one stream, so
the write is complete before the kernel reads the pages.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope

# one-shot prefill switches to blockwise online softmax at this block
# (the reference's flash_attention); chunked prefill is held to the
# one-shot path only off that grid (transformer.prefill_chunk_paged)
_FLASH_BLOCK = 512


def gqa_project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B,S,d) -> q (B,S,H,Dh), k/v (B,S,KV,Dh)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = torch.matmul(x, p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = torch.matmul(x, p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


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
    kv = cfg.num_kv_heads
    q = torch.matmul(x_t, p["wq"]).reshape(b, cfg.num_heads, hd)
    k = torch.matmul(x_t, p["wk"]).reshape(b, kv, hd)
    v = torch.matmul(x_t, p["wv"]).reshape(b, kv, hd)
    pos_rows = pos.expand(b) if pos.dim() == 0 else pos
    if cfg.use_rope:
        q = apply_rope(q[:, None], pos_rows[:, None], cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], pos_rows[:, None], cfg.rope_theta)[:, 0]

    ps = k_pages.shape[1]
    pos_l = pos_rows.long()
    page_ids = torch.gather(block_table.long(), 1,
                            (pos_l // ps)[:, None])[:, 0]       # (B,)
    slot = pos_l % ps                                           # (B,)
    k_pages[page_ids, slot] = k.to(k_pages.dtype)
    v_pages[page_ids, slot] = v.to(v_pages.dtype)

    lengths = (pos_rows + 1).to(torch.int32).contiguous()
    out = ops.paged_decode_attention(q.contiguous(), k_pages, v_pages,
                                     block_table, lengths)
    out = out.reshape(b, cfg.num_heads * hd)
    y = torch.matmul(out, p["wo"])
    return y, k_pages, v_pages


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
    out = out.reshape(b, c, cfg.num_heads * hd)
    y = torch.matmul(out, p["wo"])
    return y, k_pages, v_pages
