"""Paged transformer forward passes for the step-level serving loop:
one prefill chunk, and one decode step, over the page pool.

The port of the dense-layout paged path of
``repro/models/transformer.py``. The reference scans the stacked layer
params (``stack_scan``); here a Python loop walks the stacked tensors
layer by layer, and each layer's page slice is updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_tokens, lm_head, rms_norm, swiglu_mlp)

Pages = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------
def norm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if "bias" in p:
        raise NotImplementedError(
            "layer norm (the audio family) is not ported yet")
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _check_dense_mlp(p: dict) -> None:
    if "router" in p or "w_in" in p:
        raise NotImplementedError(
            "MoE and GELU MLPs are not ported yet")


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Prefill MLP: the fused SwiGLU kernel over every token of the
    chunk (x (..., d))."""
    _check_dense_mlp(p)
    t = x.reshape(-1, x.shape[-1]).contiguous()
    y = ops.fused_swiglu(t, p["w_gate"], p["w_up"], p["w_down"])
    return y.reshape(x.shape)


def mlp_apply_token(cfg: ModelConfig, p: dict,
                    x: torch.Tensor) -> torch.Tensor:
    """Decode MLP: the blocked SwiGLU (x (B, d)), as the reference runs
    it outside any kernel."""
    _check_dense_mlp(p)
    return swiglu_mlp(p, x)


def _embed_inputs(cfg: ModelConfig, params: dict,
                  tokens: torch.Tensor) -> torch.Tensor:
    if cfg.frontend is not None:
        raise NotImplementedError("frontends are not ported yet")
    return embed_tokens(params["embedding"], tokens)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = norm_apply(cfg, params["final_norm"], x)
    return lm_head(params, x, cfg.tie_embeddings)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s params: a view of every stacked leaf at index i."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ----------------------------------------------------------------------
# paged KV-cache path (serving/kv_pool.py page pool + block tables)
# ----------------------------------------------------------------------
def resolve_layout(cfg: ModelConfig) -> Optional[str]:
    """Page-pool layout descriptor for ``cfg``, or None when only the
    dense (contiguous-cache) path can serve it.

    - ``"dense"``: K/V pages in the model dtype, linear cache, COW tail
      pages — the one layout the port serves so far.
    - ``"quant"``: int8 code pages + per-vector f32 scale planes.
    - ``"ring"``: sliding-window layers wrap their pages in place.
    - ``"lanes"``: fixed-size recurrent-state lanes for SSM members.

    The descriptor matches the reference's ``resolve_layout`` for every
    config; ``serving.kv_pool.PagedKVServer`` rejects the layouts not
    yet ported.
    """
    if cfg.family == "ssm":
        return "lanes"
    moe_ok = cfg.moe is None or (cfg.moe.impl == "gather"
                                 and cfg.moe.first_moe_layer == 0)
    if not (cfg.family in ("dense", "moe") and cfg.attn_kind == "gqa"
            and moe_ok and cfg.frontend is None):
        return None
    if cfg.kv_quant:
        return "quant" if cfg.window is None else None
    if cfg.window is not None:
        return "ring"
    return "dense"


def prefill_chunk_paged(cfg: ModelConfig, params: dict,
                        tokens: torch.Tensor, pages: Pages,
                        block_table: torch.Tensor,
                        start_pos: torch.Tensor, *, prompt_len: int
                        ) -> Tuple[torch.Tensor, Pages]:
    """One chunk of a paged prompt prefill (dense layout only).

    tokens: (B, C) — each row's prompt slice covering absolute
    positions [start_pos[b], start_pos[b] + C); start_pos: (B,) per-row
    offsets (rows at different prefill depths share one launch);
    pages: {k, v} (L, P, page_size, KV, Dh), written in place;
    block_table: (B, NB) int32 page ids covering at least
    ``prompt_len`` positions, with every chunk before a row's
    ``start_pos`` already written by earlier calls. Returns
    (last-chunk-position logits (B, V), pages).
    """
    if resolve_layout(cfg) != "dense":
        raise ValueError(f"{cfg.name}: chunked prefill needs the dense "
                         "page layout")
    # the reference's one-shot prefill switches to blockwise online
    # softmax exactly when prompt_len is a multiple of the flash block;
    # its chunked prefill keeps the plain masked softmax and would
    # drift there — the port keeps the reference's refusal
    if not (prompt_len <= attn._FLASH_BLOCK
            or prompt_len % attn._FLASH_BLOCK != 0):
        raise ValueError(
            f"chunked prefill is bit-exact only off the flash-block grid "
            f"(prompt_len={prompt_len} is a multiple of "
            f"{attn._FLASH_BLOCK}); use one-shot prefill")
    x = _embed_inputs(cfg, params, tokens)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = norm_apply(cfg, lp["attn_norm"], x)
        a, _, _ = attn.gqa_prefill_chunk_paged(
            cfg, lp["attn"], h, pages["k"][i], pages["v"][i], block_table,
            start_pos, prompt_len=prompt_len)
        x = x + a
        h = norm_apply(cfg, lp["mlp_norm"], x)
        x = x + mlp_apply(cfg, lp["mlp"], h)
    return _logits(cfg, params, x[:, -1]), pages


def decode_step_paged(cfg: ModelConfig, params: dict, pages: Pages,
                      block_table: torch.Tensor, token: torch.Tensor,
                      pos: torch.Tensor, *, cache_len: int
                      ) -> Tuple[torch.Tensor, Pages]:
    """One decode step over the paged state (dense layout). token: (B,)
    int; pos: scalar, or (B,) per-row positions; cache_len: static
    dense-equivalent cache length (prompt + max_new). Each layer writes
    the token's K/V at ``pos`` into the row's block-table page, in
    place. Returns (logits (B, V), pages)."""
    if resolve_layout(cfg) != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only the dense page layout is ported")
    x = embed_tokens(params["embedding"], token)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = norm_apply(cfg, lp["attn_norm"], x)
        a, _, _ = attn.gqa_decode_paged(
            cfg, lp["attn"], h, pages["k"][i], pages["v"][i], block_table,
            pos, cache_len=cache_len)
        x = x + a
        h = norm_apply(cfg, lp["mlp_norm"], x)
        x = x + mlp_apply_token(cfg, lp["mlp"], h)
    return _logits(cfg, params, x), pages
