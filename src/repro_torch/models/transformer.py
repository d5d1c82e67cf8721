"""Transformer forward for training, and prefill and decode for
serving, over every family of the zoo (dense, MoE, ssm, hybrid, audio
and vision): the full-sequence
forward; one-shot prefill into a contiguous cache (linear, ring or
recurrent state) or into pool pages (dense, quant, ring) or lanes; one
chunk of a paged prefill; and one decode step over a contiguous cache
or over the page pool in any layout.

The port of ``repro/models/transformer.py``. The reference scans the
stacked layer params (``stack_scan``); here a Python loop walks the
stacked tensors layer by layer, and each layer's cache, page or lane
slice is updated in place. MoE MLPs dispatch on ``MoEConfig.impl``
(``models.moe``); MLA attention layers (DeepSeek-V2) keep a latent
cache {c_kv, k_rope}; a MoE stack's leading dense layers
(``first_moe_layer``) are unrolled ``layer_{i:02d}`` subtrees before the
stacked ``layers``. The audio family (whisper) runs a non-causal encoder
over frame embeddings and a decoder with learned positions whose layers
cross-attend the encoder's K/V; its cache is {"dec_layers": self K/V,
"cross": the cross K/V written once at prefill}. The vision family
(llava) puts patch embeddings in the first positions of the prompt.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_rope, embed_tokens, gelu_mlp, layer_norm, lm_head, rms_norm,
    swiglu_mlp)
from repro_torch.models.params import torch_dtype
from repro_torch.sharding.tp import tp_all_gather, tp_size

Pages = Dict[str, torch.Tensor]
Cache = Dict[str, Dict[str, torch.Tensor]]
# the dense-cache decode kernel's block (repro/kernels/decode_attention.py)
DECODE_BLOCK_S = 512


# ----------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------
def norm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence and prefill MLP over x (B, S, d): returns (y, the
    router's aux loss, None for a dense MLP). A MoE MLP runs the gather
    dispatch (``impl == "gather"``: every expert through the fused
    SwiGLU kernel) or the capacity dispatch; the audio family's GELU
    MLP plain PyTorch (no kernel in the reference either); a dense one
    the fused SwiGLU kernel over every token — or, under tensor
    parallelism (``tp_size() > 1``), the kernel's two stages around the
    gather of h: gate_up on this column's slice of Wg and Wu, then down
    with the whole Wd (``sharding/tp.py``)."""
    if "router" in p:
        if cfg.moe.impl == "gather":
            return moe_mod.moe_ffn_gather(cfg, p, x)
        return moe_mod.moe_ffn(cfg, p, x)
    if "w_in" in p:
        return gelu_mlp(p, x), None
    t = x.reshape(-1, x.shape[-1]).contiguous()
    if tp_size() > 1:
        h = tp_all_gather(ops.swiglu_gate_up(t, p["w_gate"], p["w_up"]))
        return ops.swiglu_down(h, p["w_down"]).reshape(x.shape), None
    y = ops.fused_swiglu(t, p["w_gate"], p["w_up"], p["w_down"])
    return y.reshape(x.shape), None


def mlp_apply_token(cfg: ModelConfig, p: dict,
                    x: torch.Tensor) -> torch.Tensor:
    """Decode MLP over x (B, d): the gather MoE (the same code path and
    bits as its prefill), the per-token MoE of capacity configs, or the
    blocked SwiGLU or the GELU MLP, as the reference runs a dense decode
    MLP outside any kernel."""
    if "router" in p:
        if cfg.moe.impl == "gather":
            return moe_mod.moe_ffn_gather(cfg, p, x[:, None])[0][:, 0]
        return moe_mod.moe_ffn_token(cfg, p, x)
    if "w_in" in p:
        return gelu_mlp(p, x)
    return swiglu_mlp(p, x)


def _embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Token embeddings (B, S, d); a vision config given patch
    embeddings (B, P, d) puts them, cast to the model dtype, in the
    first P positions (P <= S). Without patches a vision model embeds
    the tokens alone, as the serving engine runs it."""
    x = embed_tokens(params["embedding"], tokens)
    if cfg.frontend == "vision" and frontend_embeds is not None:
        p = frontend_embeds.shape[1]
        if p > tokens.shape[1]:
            raise ValueError(f"{cfg.name}: {p} patch embeddings need a "
                             f"prompt of at least {p} positions, not "
                             f"{tokens.shape[1]}")
        x = torch.cat([frontend_embeds.to(x.dtype), x[:, p:]], dim=1)
    return x


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = norm_apply(cfg, params["final_norm"], x)
    return lm_head(params, x, cfg.tie_embeddings)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s params: a view of every stacked leaf at index i."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _n_unrolled(cfg: ModelConfig) -> int:
    """Leading layers kept as ``layer_{i:02d}`` subtrees before a
    uniform stack: a MoE stack's dense layers (deepseek-v2's layer 0)."""
    if cfg.moe is not None and cfg.moe.first_moe_layer > 0:
        return cfg.moe.first_moe_layer
    return 0


def _layer_params(cfg: ModelConfig, params: dict, i: int) -> dict:
    """Layer i's params: its own subtree (the hybrid stack, a MoE
    stack's leading dense layers), else views of the stacked leaves
    (the audio family: of the decoder's ``dec_layers``)."""
    if cfg.family == "audio":
        return _layer(params["dec_layers"], i)
    k = _n_unrolled(cfg)
    if cfg.family == "hybrid" or i < k:
        return params[f"layer_{i:02d}"]
    return _layer(params["layers"], i - k)


# ----------------------------------------------------------------------
# full-sequence forward (training / scoring)
# ----------------------------------------------------------------------
def layer_fwd(cfg: ModelConfig, lp: dict, x: torch.Tensor,
              positions: torch.Tensor, kind: str,
              enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder (or encoder) layer over a full sequence: an ssm
    block, or an RG-LRU or attention (MLA, or GQA: causal unless
    ``causal=False``, optionally windowed) mixer, then, given the
    encoder's K/V ``enc_kv``, cross-attention, then the MLP (dense,
    GELU or MoE). Returns (x, the MLP's aux loss or None)."""
    if kind == "ssm":
        h = norm_apply(cfg, lp["norm"], x)
        return x + ssm_mod.mamba_block(cfg, lp["ssm"], h), None
    if kind == "rglru":
        h = norm_apply(cfg, lp["mix_norm"], x)
        x = x + rglru_mod.rglru_block(cfg, lp["rglru"], h)
    elif kind == "attn":
        h = norm_apply(cfg, lp["attn_norm"], x)
        if cfg.attn_kind == "mla":
            x = x + attn.mla_attention(cfg, lp["attn"], h, positions)
        else:
            x = x + attn.gqa_attention(cfg, lp["attn"], h, positions,
                                       causal=causal, window=cfg.window)
        if enc_kv is not None:
            h = norm_apply(cfg, lp["cross_norm"], x)
            x = x + attn.cross_attention(cfg, lp["cross"], h, *enc_kv)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    h = norm_apply(cfg, lp["mlp_norm"], x)
    y, aux = mlp_apply(cfg, lp["mlp"], h)
    return x + y, aux


def _dec_pos(cfg: ModelConfig, params: dict,
             positions: torch.Tensor) -> torch.Tensor:
    """Learned decoder positions, indexed modulo the table's rows
    (whisper's 448; positions past it wrap, as in the reference)."""
    table = params["dec_pos"]
    return table[torch.remainder(positions.long(), table.shape[0])]


def _sinusoidal_pos(length: int, d: int, device=None) -> torch.Tensor:
    """The encoder's fixed positions (length, d) in f32: sin of every
    angle, then cos."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _frames(cfg: ModelConfig, frontend_embeds) -> torch.Tensor:
    if frontend_embeds is None:
        raise ValueError(f"{cfg.name}: the audio family needs frame "
                         "embeddings (frontend_embeds, (B, F, d))")
    return frontend_embeds


def _encode(cfg: ModelConfig, params: dict,
            frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) stub frontend output -> encoder states: fixed
    sinusoidal positions added, the non-causal encoder stack, its final
    layer norm."""
    f = frames.shape[1]
    x = frames + _sinusoidal_pos(f, cfg.d_model,
                                 frames.device).to(frames.dtype)[None]
    positions = torch.arange(f, device=frames.device)
    for i in range(cfg.encoder.num_layers):
        x, _ = layer_fwd(cfg, _layer(params["enc_layers"], i), x,
                         positions, "attn", causal=False)
    return norm_apply(cfg, params["enc_final_norm"], x)


def _dec_embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """The audio decoder's input: token embeddings plus learned
    positions."""
    x = embed_tokens(params["embedding"], tokens)
    return x + _dec_pos(cfg, params, positions).to(x.dtype)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V), moe_aux scalar: the MoE
    layers' router aux losses summed in layer order, zero without MoE).

    Layers are walked in order: a MoE stack's unrolled dense layers,
    then the stacked layer params (the hybrid stack: its per-layer
    subtrees). ``remat`` recomputes each layer's activations in the
    backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` does. ``frontend_embeds`` are an audio model's
    frames (B, F, d), required: the encoder runs over them and each
    decoder layer cross-attends its output; or a vision model's patches
    (B, P, d), which replace the first P token embeddings; other
    families ignore them."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if cfg.family == "audio":
        enc_out = _encode(cfg, params, _frames(cfg, frontend_embeds))
        x = _dec_embed(cfg, params, tokens, positions)
    else:
        x = _embed_inputs(cfg, params, tokens, frontend_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(cfg.layer_kinds):
        def fn(x, i=i, kind=kind):
            lp = _layer_params(cfg, params, i)
            kv = (attn.cross_kv(cfg, lp["cross"], enc_out)
                  if cfg.family == "audio" else None)
            return layer_fwd(cfg, lp, x, positions, kind, enc_kv=kv)

        if remat:
            x, a = torch.utils.checkpoint.checkpoint(fn, x,
                                                     use_reentrant=False)
        else:
            x, a = fn(x)
        if a is not None:
            aux = aux + a
    return _logits(cfg, params, x), aux


def _attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Cache positions for ``seq_len`` total positions: the window for
    sliding-window layers; otherwise caches longer than the decode
    kernel's 512-key block round up to that grid, as the reference does
    on its kernel path (positions past the true length are masked)."""
    if cfg.window is not None:
        return min(seq_len, cfg.window)
    if seq_len > DECODE_BLOCK_S:
        return -(-seq_len // DECODE_BLOCK_S) * DECODE_BLOCK_S
    return seq_len


def _pad_cache(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Zero-pad axis 1 (positions) to ``cache_len``."""
    s = k.shape[1]
    if s == cache_len:
        return k
    assert s < cache_len
    pad = [0, 0] * (k.dim() - 2) + [0, cache_len - s]
    return F.pad(k, pad)


def ring_compress(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Compress prefill keys (B, S, ...) to a ring cache (B, cache_len,
    ...): slot = absolute position mod cache_len over the last
    cache_len positions. A prompt shorter than the ring is zero-padded
    at the tail (decode's slot arithmetic needs the full ring length)."""
    s = k.shape[1]
    if s <= cache_len:
        return _pad_cache(k, cache_len)
    slots = torch.arange(s - cache_len, s, device=k.device) % cache_len
    out = torch.zeros((k.shape[0], cache_len) + tuple(k.shape[2:]),
                      dtype=k.dtype, device=k.device)
    out[:, slots] = k[:, -cache_len:]
    return out


def _attn_cache_entry(cfg: ModelConfig, batch: int, cache_len: int,
                      device) -> Dict[str, torch.Tensor]:
    if cfg.attn_kind == "mla":
        m, dt = cfg.mla, torch_dtype(cfg)
        return {"c_kv": torch.zeros((batch, cache_len, m.kv_lora_rank),
                                    dtype=dt, device=device),
                "k_rope": torch.zeros((batch, cache_len,
                                       m.qk_rope_head_dim),
                                      dtype=dt, device=device)}
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _state_entry(cfg: ModelConfig, kind: str, batch: int,
                 device) -> Dict[str, torch.Tensor]:
    """A recurrent layer's zero state: {conv (B, width-1, w) in the
    model dtype, h f32: (B, d_in, N) for ssm, (B, w) for rglru}."""
    if kind == "ssm":
        d_in, _, n = ssm_mod.ssm_dims(cfg)
        w, cw, h_shape = d_in, cfg.ssm.conv_width, (batch, d_in, n)
    else:
        w = cfg.rglru.lru_width or cfg.d_model
        cw, h_shape = cfg.rglru.conv_width, (batch, w)
    return {"conv": torch.zeros((batch, cw - 1, w), dtype=torch_dtype(cfg),
                                device=device),
            "h": torch.zeros(h_shape, dtype=torch.float32, device=device)}


def _stack(entries) -> Dict[str, torch.Tensor]:
    return {n: torch.stack([e[n] for e in entries]) for n in entries[0]}


def _assemble_cache(cfg: ModelConfig, entries, cross=None) -> Cache:
    """Per-layer cache entries -> the family's cache: the hybrid stack
    keeps one ``layer_{i:02d}`` entry a layer (batch on axis 0), and so
    do a MoE stack's unrolled dense layers; uniform stacks stack theirs
    under ``layers`` (layer axis 0, batch axis 1); the audio family
    under ``dec_layers``, beside the stacked cross K/V ``cross``."""
    if cfg.family == "audio":
        return {"dec_layers": _stack(entries), "cross": _stack(cross)}
    if cfg.family == "hybrid":
        return {f"layer_{i:02d}": e for i, e in enumerate(entries)}
    k = _n_unrolled(cfg)
    out: Cache = {f"layer_{i:02d}": entries[i] for i in range(k)}
    out["layers"] = _stack(entries[k:])
    return out


def _cache_layer(cfg: ModelConfig, cache: Cache,
                 i: int) -> Dict[str, torch.Tensor]:
    """Layer i's cache leaves (views, written in place)."""
    if cfg.family == "audio":
        return {n: t[i] for n, t in cache["dec_layers"].items()}
    k = _n_unrolled(cfg)
    if cfg.family == "hybrid" or i < k:
        return cache[f"layer_{i:02d}"]
    return {n: t[i - k] for n, t in cache["layers"].items()}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> Cache:
    """Zero-initialised decode cache for ``seq_len`` total positions.

    Attention layers hold {k, v} (B, S, KV, Dh) in the model dtype, or
    int8 codes plus {k_scale, v_scale} (B, S, KV) f32 planes for an
    int8 cache (``cfg.kv_quant``), or MLA's latent {c_kv (B, S,
    kv_lora), k_rope (B, S, rope)}; S is ``seq_len`` capped at the
    window for sliding-window layers (a ring). Recurrent layers hold
    their {conv, h} state. Uniform stacks stack the layers under
    ``layers`` (L, B, ...); the hybrid stack keeps a ``layer_{i:02d}``
    entry a layer, and a MoE stack one for each leading dense layer.
    The audio family stacks its self-attention caches under
    ``dec_layers`` and its zeroed cross K/V (L, B, F, KV, Dh) under
    ``cross``."""
    s = _attn_cache_len(cfg, seq_len)
    entries = [_attn_cache_entry(cfg, batch, s, device) if kind == "attn"
               else _state_entry(cfg, kind, batch, device)
               for kind in cfg.layer_kinds]
    cross = None
    if cfg.family == "audio":
        cross = [_attn_cache_entry(cfg, batch, cfg.encoder.num_frames,
                                   device)] * cfg.num_layers
    return _assemble_cache(cfg, entries, cross)


# ----------------------------------------------------------------------
# one-shot prefill
# ----------------------------------------------------------------------
def _attn_prefill_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                        positions: torch.Tensor, enc_kv=None):
    """One full-prompt attention layer (cross-attending ``enc_kv`` when
    given): returns (x, entry) with the
    layer's cache leaves over the prompt for the caller to pack into its
    cache or pages: MLA's normed latent and rope'd shared key {c_kv,
    k_rope}, or GQA's rope'd K/V (B, S, KV, Dh) — as they are, or int8
    codes plus f32 scales (``attn.quantize_kv``) for an int8 cache."""
    h = norm_apply(cfg, lp["attn_norm"], x)
    if cfg.attn_kind == "mla":
        c_kv, k_rope = attn.mla_project_kv_latent(cfg, lp["attn"], h)
        k_rope = apply_rope(k_rope[:, :, None], positions[None],
                            cfg.rope_theta)[:, :, 0]
        a = attn.mla_attention(cfg, lp["attn"], h, positions)
        entry = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        q, k, v = attn.gqa_project_qkv(cfg, lp["attn"], h)
        if cfg.use_rope:
            q = apply_rope(q, positions[None], cfg.rope_theta)
            k = apply_rope(k, positions[None], cfg.rope_theta)
        o = attn.flash_attention(q, k, v, positions, positions,
                                 causal=True, window=cfg.window)
        b, s = x.shape[:2]
        o = o.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
        # tensor parallelism: gather head-local attention outputs to
        # the full head axis before the replicated output projection
        o = tp_all_gather(o)
        a = torch.matmul(o, lp["attn"]["wo"])
        entry = {"k": k, "v": v}
        if cfg.kv_quant:
            kq, ks = attn.quantize_kv(k)
            vq, vs = attn.quantize_kv(v)
            entry = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    x = x + a
    if enc_kv is not None:
        h = norm_apply(cfg, lp["cross_norm"], x)
        x = x + attn.cross_attention(cfg, lp["cross"], h, *enc_kv)
    h = norm_apply(cfg, lp["mlp_norm"], x)
    return x + mlp_apply(cfg, lp["mlp"], h)[0], entry


def _prefill_layers(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    pack, frontend_embeds=None) -> torch.Tensor:
    """Run the prompt through every layer; ``pack(i, kind, entry)``
    stores layer i's cache leaves: an attention layer's full-prompt K/V
    (or int8 codes and scales), a recurrent layer's final {conv, h}
    state (``ssm.mamba_prefill``, ``rglru.rglru_prefill``: the plain
    scans the reference's prefill runs), and an audio decoder layer's
    cross K/V (kind ``"cross"``) from the encoder run over the frames
    ``frontend_embeds``. Returns the last position's logits."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if cfg.family == "audio":
        enc_out = _encode(cfg, params, _frames(cfg, frontend_embeds))
        x = _dec_embed(cfg, params, tokens, positions)
        for i in range(cfg.num_layers):
            lp = _layer_params(cfg, params, i)
            k, v = attn.cross_kv(cfg, lp["cross"], enc_out)
            x, st = _attn_prefill_layer(cfg, lp, x, positions,
                                        enc_kv=(k, v))
            pack(i, "attn", st)
            pack(i, "cross", {"k": k, "v": v})
        return _logits(cfg, params, x[:, -1])
    x = _embed_inputs(cfg, params, tokens, frontend_embeds)
    for i, kind in enumerate(cfg.layer_kinds):
        lp = _layer_params(cfg, params, i)
        if kind == "ssm":
            h = norm_apply(cfg, lp["norm"], x)
            y, st = ssm_mod.mamba_prefill(cfg, lp["ssm"], h)
            x = x + y
        elif kind == "rglru":
            h = norm_apply(cfg, lp["mix_norm"], x)
            y, st = rglru_mod.rglru_prefill(cfg, lp["rglru"], h)
            x = x + y
            h = norm_apply(cfg, lp["mlp_norm"], x)
            x = x + mlp_apply(cfg, lp["mlp"], h)[0]
        else:
            x, st = _attn_prefill_layer(cfg, lp, x, positions)
        pack(i, kind, st)
    return _logits(cfg, params, x[:, -1])


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Process a prompt: tokens (B, S) -> (last-position logits (B, V),
    decode cache for ``cache_len`` total positions, default S). The
    cache is ``init_cache``'s layout: linear attention layers hold the
    prompt's K/V (or int8 codes and scales) in positions [0, S) and
    zeros after; ring layers the last min(cache_len, window) positions
    at slot = position mod ring length (``ring_compress``); recurrent
    layers their state after the prompt; an audio model's ``cross`` the
    encoder's K/V for every decoder layer, which decoding only reads.
    ``frontend_embeds``: ``forward``'s (an audio model's frames are
    required)."""
    s = tokens.shape[1]
    a_len = _attn_cache_len(cfg, s if cache_len is None else cache_len)
    fit = ring_compress if cfg.window is not None else _pad_cache
    entries, cross = [], []

    def pack(i, kind, entry):
        if kind == "cross":
            cross.append(entry)
            return
        if kind == "attn":
            entry = {n: fit(a, a_len) for n, a in entry.items()}
        entries.append(entry)

    logits = _prefill_layers(cfg, params, tokens, pack, frontend_embeds)
    return logits, _assemble_cache(cfg, entries, cross)


# ----------------------------------------------------------------------
# paged KV-cache path (serving/kv_pool.py page pool + block tables)
# ----------------------------------------------------------------------
def resolve_layout(cfg: ModelConfig) -> Optional[str]:
    """Page-pool layout descriptor for ``cfg``, or None when only the
    dense (contiguous-cache) path can serve it.

    - ``"dense"``: K/V pages in the model dtype, linear cache, COW tail
      pages.
    - ``"quant"``: int8 code pages + per-vector f32 scale planes.
    - ``"ring"``: sliding-window layers wrap their pages in place,
      ceil(min(prompt + new, window) / page) pages a row.
    - ``"lanes"``: fixed-size recurrent-state lanes for SSM members.

    The descriptor matches the reference's ``resolve_layout`` for every
    config. Hybrid stacks (recurrentgemma: RG-LRU and sliding-window
    layers interleaved) get None and serve over contiguous caches.
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


def paged_supported(cfg: ModelConfig) -> bool:
    """True when some page layout serves the config bit-identically to
    its dense (contiguous-cache) path (``resolve_layout``)."""
    return resolve_layout(cfg) is not None


def prefill_paged(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  pages: Pages, prefill_table: torch.Tensor, *,
                  cache_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Pages]:
    """One-shot prompt prefill that scatters each layer's K/V into pool
    pages (dense, quant and ring layouts).

    tokens: (B, S); pages: the pool's leaves (L, P, page_size, ...) —
    dense and ring {k, v} in the model dtype, quant int8 {k, v} plus
    f32 {k_scale, v_scale} — written in place; prefill_table: (B, NBp)
    int32 page ids covering each row's prompt (ring: its whole
    snapshot). The hidden-state math is ``prefill``'s; only the cache
    packing differs: quant packing runs the same ``quantize_kv`` as the
    int8 cache, and ring packing the same ``ring_compress`` as the ring
    cache, over ``cache_len`` (the dense-equivalent prompt + max_new,
    required for ring: the pages hold the min(cache_len, window) ring).
    Returns (last-position logits (B, V), pages).
    """
    layout = resolve_layout(cfg)
    if layout not in ("dense", "quant", "ring"):
        raise ValueError(f"{cfg.name}: one-shot paged prefill takes the "
                         f"dense, quant and ring layouts, not {layout!r}")
    b, s = tokens.shape
    ps = pages["k"].shape[2]
    nbp = prefill_table.shape[1]
    table = prefill_table.long()
    ring_len = _attn_cache_len(cfg, s if cache_len is None else cache_len)

    def pack(i, kind, entry):
        # ring: compress to the ring snapshot the contiguous path keeps;
        # then pad positions to the page boundary (the pad lands in the
        # partial tail page's dead slots) and scatter page-shaped chunks
        for n, a in entry.items():
            if layout == "ring":
                a = ring_compress(a, ring_len)
            a = _pad_cache(a, nbp * ps)
            a = a.reshape((b, nbp, ps) + a.shape[2:])
            pages[n][i][table] = a.to(pages[n].dtype)

    return _prefill_layers(cfg, params, tokens, pack), pages


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
        x = x + mlp_apply(cfg, lp["mlp"], h)[0]
    return _logits(cfg, params, x[:, -1]), pages


def decode_step_paged(cfg: ModelConfig, params: dict, pages: Pages,
                      block_table: torch.Tensor, token: torch.Tensor,
                      pos: torch.Tensor, *, cache_len: int
                      ) -> Tuple[torch.Tensor, Pages]:
    """One decode step over the paged state, dispatching on the
    config's layout. token: (B,) int; pos: scalar, or (B,) per-row
    positions; cache_len: static dense-equivalent cache length (prompt
    + max_new; ring caps it at the window; lanes ignore it and ``pos``:
    the recurrent state is position free).

    Dense and quant write each layer's K/V (quant: codes and scales) at
    ``pos`` into the row's block-table page; ring writes at
    ``pos mod min(cache_len, window)``; lanes gather each row's state
    at its lane id (``block_table[:, 0]``), run ``ssm.mamba_step`` and
    scatter the new state back. All in place. Returns (logits (B, V),
    pages)."""
    layout = resolve_layout(cfg)
    if layout is None:
        raise ValueError(f"{cfg.name}: no page layout serves this config")
    x = embed_tokens(params["embedding"], token)
    if layout == "lanes":
        lanes = block_table[:, 0].long()
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h = norm_apply(cfg, lp["norm"], x)
            st = {n: t[i][lanes] for n, t in pages.items()}
            y, new_st = ssm_mod.mamba_step(cfg, lp["ssm"], h, st)
            # the arena's dtypes are the state's (conv: the model dtype,
            # h: f32), so the scatter is a pure copy
            for n, t in pages.items():
                t[i][lanes] = new_st[n]
            x = x + y
        return _logits(cfg, params, x), pages
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = norm_apply(cfg, lp["attn_norm"], x)
        if layout == "quant":
            a, _ = attn.gqa_decode_quant_paged(
                cfg, lp["attn"], h, {n: t[i] for n, t in pages.items()},
                block_table, pos, cache_len=cache_len)
        elif layout == "ring":
            a, _ = attn.gqa_decode_ring_paged(
                cfg, lp["attn"], h, {n: t[i] for n, t in pages.items()},
                block_table, pos, cache_len=min(cache_len, cfg.window))
        else:
            a, _, _ = attn.gqa_decode_paged(
                cfg, lp["attn"], h, pages["k"][i], pages["v"][i],
                block_table, pos, cache_len=cache_len)
        x = x + a
        h = norm_apply(cfg, lp["mlp_norm"], x)
        x = x + mlp_apply_token(cfg, lp["mlp"], h)
    return _logits(cfg, params, x), pages


# ----------------------------------------------------------------------
# decode over a contiguous cache
# ----------------------------------------------------------------------
def _attn_decode_layer(cfg: ModelConfig, lp: dict, x_t: torch.Tensor,
                       cache_l: dict, pos: int,
                       cross: Optional[dict] = None) -> torch.Tensor:
    h = norm_apply(cfg, lp["attn_norm"], x_t)
    if cfg.attn_kind == "mla":
        a, _ = attn.mla_decode(cfg, lp["attn"], h, cache_l, pos)
    else:
        a, _ = attn.gqa_decode(cfg, lp["attn"], h, cache_l, pos,
                               ring=cfg.window is not None)
    x_t = x_t + a
    if cross is not None:
        h = norm_apply(cfg, lp["cross_norm"], x_t)
        x_t = x_t + attn.cross_attention(cfg, lp["cross"], h, cross["k"],
                                         cross["v"])
    h = norm_apply(cfg, lp["mlp_norm"], x_t)
    return x_t + mlp_apply_token(cfg, lp["mlp"], h)


def decode_step(cfg: ModelConfig, params: dict, cache: Cache,
                token: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step over a contiguous cache. token: (B,) int; pos:
    the position written, one Python int for the whole batch. Attention
    layers write their K/V (or int8 codes and scales, or MLA's latent)
    at ``pos`` (a ring at ``pos`` mod its length); recurrent layers step
    their state
    (``ssm.mamba_step``, ``rglru.rglru_block_step``); an audio model's
    decoder adds the learned position ``pos`` to the token and each
    layer cross-attends its ``cross`` K/V, which stay as they are. The
    cache is updated in place; returns (logits for position pos + 1
    (B, V), cache)."""
    x = embed_tokens(params["embedding"], token)
    if cfg.family == "audio":
        table = params["dec_pos"]    # indexed on the host: no copy
        x = x + table[int(pos) % table.shape[0]].to(x.dtype)
    for i, kind in enumerate(cfg.layer_kinds):
        lp = _layer_params(cfg, params, i)
        cl = _cache_layer(cfg, cache, i)
        if kind == "attn":
            cross = ({n: t[i] for n, t in cache["cross"].items()}
                     if cfg.family == "audio" else None)
            x = _attn_decode_layer(cfg, lp, x, cl, pos, cross)
            continue
        if kind == "ssm":
            h = norm_apply(cfg, lp["norm"], x)
            y, st = ssm_mod.mamba_step(cfg, lp["ssm"], h, cl)
            x = x + y
        else:
            h = norm_apply(cfg, lp["mix_norm"], x)
            y, st = rglru_mod.rglru_block_step(cfg, lp["rglru"], h, cl)
            x = x + y
            h = norm_apply(cfg, lp["mlp_norm"], x)
            x = x + mlp_apply_token(cfg, lp["mlp"], h)
        for n, t in cl.items():
            t.copy_(st[n])
    return _logits(cfg, params, x), cache
