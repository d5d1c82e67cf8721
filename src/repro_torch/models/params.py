"""Parameter definitions, initialisation, and conversion from the
reference's parameter tree.

Each weight is declared once as a ``WeightDef`` (shape + init kind);
``init_params`` materialises the tree and ``from_jax_numpy`` checks a
converted tree against it leaf for leaf. The tree is the reference's:
nested dicts with the scanned layer stack under ``"layers"`` carrying a
leading layers axis (dense and ssm families), or one unstacked
``layer_{i:02d}`` subtree per layer (the hybrid family's non-uniform
stack). A MoE stack whose first layers keep a dense MLP
(``MoEConfig.first_moe_layer``, deepseek-v2's layer 0) unrolls those
as ``layer_{i:02d}`` subtrees beside the stacked MoE ``layers``. The
audio family (whisper) holds two stacks, ``enc_layers`` and
``dec_layers`` (the decoder's layers with cross-attention), the
encoder's final norm and the learned decoder positions ``dec_pos``;
its norms are layer norms with a bias and its MLPs the two-matmul GELU
MLP. The vision family's tree is its backbone's (patches are inputs,
not params).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import ssm_dims

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``."""
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"{cfg.name}: unsupported dtype {cfg.dtype!r}")


@dataclasses.dataclass(frozen=True)
class WeightDef:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | a_log | lam
    scale: float = 0.02
    # the reference's logical axis names, one per dim (``param_specs``
    # maps them to mesh axes through a rule table)
    axes: Tuple[Optional[str], ...] = ()


# inits whose leaves stay float32 in a bf16 model (the reference's
# abstract_params and init_params make them so)
_F32_INITS = ("a_log", "lam")
_RG_C = 8.0   # RG-LRU's recurrence constant (models.rglru._C)


def _norm_def(d: int, with_bias: bool = False) -> Dict[str, WeightDef]:
    out = {"scale": WeightDef((d,), "ones", axes=("embed",))}
    if with_bias:
        out["bias"] = WeightDef((d,), "zeros", axes=("embed",))
    return out


def _attn_defs(cfg: ModelConfig) -> Dict[str, WeightDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": WeightDef((d, h * hd), axes=("embed", "heads")),
        "wk": WeightDef((d, kv * hd), axes=("embed", "kv_heads")),
        "wv": WeightDef((d, kv * hd), axes=("embed", "kv_heads")),
        "wo": WeightDef((h * hd, d), axes=("heads", "embed")),
    }


def _mla_defs(cfg: ModelConfig) -> Dict[str, WeightDef]:
    """DeepSeek-V2's multi-head latent attention: low-rank q, a shared
    (kv_lora_rank + rope)-wide latent, per-head K (nope part) and V
    expanded from the latent."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": WeightDef((d, m.q_lora_rank), axes=("embed", None)),
        "q_norm": WeightDef((m.q_lora_rank,), "ones", axes=(None,)),
        "wq_b": WeightDef((m.q_lora_rank, h * qk), axes=(None, "heads")),
        "wkv_a": WeightDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           axes=("embed", None)),
        "kv_norm": WeightDef((m.kv_lora_rank,), "ones", axes=(None,)),
        "wk_b": WeightDef((m.kv_lora_rank, h * m.qk_nope_head_dim),
                          axes=(None, "heads")),
        "wv_b": WeightDef((m.kv_lora_rank, h * m.v_head_dim),
                          axes=(None, "heads")),
        "wo": WeightDef((h * m.v_head_dim, d), axes=("heads", "embed")),
    }


def _mlp_defs(cfg: ModelConfig) -> Dict[str, WeightDef]:
    """The audio family's GELU MLP (zero biases), else the SwiGLU."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "audio":
        return {
            "w_in": WeightDef((d, f), axes=("embed", "ff")),
            "b_in": WeightDef((f,), "zeros", axes=("ff",)),
            "w_out": WeightDef((f, d), axes=("ff", "embed")),
            "b_out": WeightDef((d,), "zeros", axes=("embed",)),
        }
    return {
        "w_gate": WeightDef((d, f), axes=("embed", "ff")),
        "w_up": WeightDef((d, f), axes=("embed", "ff")),
        "w_down": WeightDef((f, d), axes=("ff", "embed")),
    }


def _moe_defs(cfg: ModelConfig) -> Dict[str, WeightDef]:
    """A routed-expert MLP: the router (d, E), each expert's SwiGLU
    stacked on a leading expert axis, and the shared experts' SwiGLU
    (one of width num_shared * d_ff_shared) where the config has them."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    out = {
        "router": WeightDef((d, e), axes=("embed", None)),
        "w_gate": WeightDef((e, d, f),
                            axes=("experts", "embed", "expert_ff")),
        "w_up": WeightDef((e, d, f), axes=("experts", "embed", "expert_ff")),
        "w_down": WeightDef((e, f, d),
                            axes=("experts", "expert_ff", "embed")),
    }
    if m.num_shared_experts:
        sf = m.num_shared_experts * m.d_ff_shared
        out.update({
            "shared_w_gate": WeightDef((d, sf), axes=("embed", "ff")),
            "shared_w_up": WeightDef((d, sf), axes=("embed", "ff")),
            "shared_w_down": WeightDef((sf, d), axes=("ff", "embed")),
        })
    return out


def _ssm_defs(cfg: ModelConfig) -> Dict[str, WeightDef]:
    s = cfg.ssm
    d = cfg.d_model
    d_in, dt_rank, n = ssm_dims(cfg)
    return {
        "w_in_x": WeightDef((d, d_in), axes=("embed", "d_inner")),
        "w_in_z": WeightDef((d, d_in), axes=("embed", "d_inner")),
        "conv_w": WeightDef((s.conv_width, d_in), axes=(None, "d_inner")),
        "conv_b": WeightDef((d_in,), "zeros", axes=("d_inner",)),
        "w_xproj": WeightDef((d_in, dt_rank + 2 * n),
                             axes=("d_inner", None)),
        "w_dt": WeightDef((dt_rank, d_in), axes=(None, "d_inner")),
        "b_dt": WeightDef((d_in,), "zeros", axes=("d_inner",)),
        "a_log": WeightDef((d_in, n), "a_log", axes=("d_inner", None)),
        "d_skip": WeightDef((d_in,), "ones", axes=("d_inner",)),
        "w_out": WeightDef((d_in, d), axes=("d_inner", "embed")),
    }


def _rglru_defs(cfg: ModelConfig) -> Dict[str, WeightDef]:
    r = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    return {
        "w_x": WeightDef((d, w), axes=("embed", "d_inner")),
        "w_g": WeightDef((d, w), axes=("embed", "d_inner")),
        "conv_w": WeightDef((r.conv_width, w), axes=(None, "d_inner")),
        "conv_b": WeightDef((w,), "zeros", axes=("d_inner",)),
        "w_a": WeightDef((w, w), axes=("d_inner", None)),
        "b_a": WeightDef((w,), "zeros", axes=(None,)),
        "w_i": WeightDef((w, w), axes=("d_inner", None)),
        "b_i": WeightDef((w,), "zeros", axes=(None,)),
        "lam": WeightDef((w,), "lam", axes=(None,)),
        "w_out": WeightDef((w, d), axes=("d_inner", "embed")),
    }


def layer_defs(cfg: ModelConfig, kind: str, layer_idx: int = 0,
               cross_attn: bool = False) -> dict:
    """Def tree for one decoder layer of the given kind (attn | ssm |
    rglru). An attention layer holds MLA or GQA weights as the config
    says, a cross-attention block (``cross_norm``, ``cross``) with
    ``cross_attn``, and a MoE MLP from ``first_moe_layer`` on. The
    audio family's norms carry a bias."""
    d = cfg.d_model
    bias = cfg.family == "audio"
    if kind == "ssm":
        return {"norm": _norm_def(d, bias), "ssm": _ssm_defs(cfg)}
    if kind == "attn":
        out = {"attn_norm": _norm_def(d, bias),
               "attn": _mla_defs(cfg) if cfg.attn_kind == "mla"
               else _attn_defs(cfg)}
        if cross_attn:
            out["cross_norm"] = _norm_def(d, bias)
            out["cross"] = _attn_defs(cfg)
    elif kind == "rglru":
        out = {"mix_norm": _norm_def(d, bias), "rglru": _rglru_defs(cfg)}
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    out["mlp_norm"] = _norm_def(d, bias)
    use_moe = (cfg.moe is not None and kind == "attn"
               and layer_idx >= cfg.moe.first_moe_layer)
    out["mlp"] = _moe_defs(cfg) if use_moe else _mlp_defs(cfg)
    return out


def _stack_defs(defs: dict, n: int) -> dict:
    """Prepend a (stacked) layers axis to every WeightDef in a tree."""
    return {k: _stack_defs(v, n) if isinstance(v, dict)
            else WeightDef((n,) + v.shape, v.init, v.scale,
                           ("layers",) + v.axes)
            for k, v in defs.items()}


def model_defs(cfg: ModelConfig) -> dict:
    """Full parameter def tree for an architecture of any family."""
    d, v = cfg.d_model, cfg.vocab_size
    defs: dict = {
        "embedding": WeightDef((v, d), axes=("vocab", "embed")),
        "final_norm": _norm_def(d, cfg.family == "audio"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = WeightDef((d, v), axes=("embed", "vocab"))
    kinds = cfg.layer_kinds
    if cfg.family == "hybrid":
        # non-uniform layer stack: per-layer subtrees
        for i, kind in enumerate(kinds):
            defs[f"layer_{i:02d}"] = layer_defs(cfg, kind)
    elif cfg.family == "audio":
        # the encoder's layers: the decoder's without cross-attention
        defs["enc_layers"] = _stack_defs(layer_defs(cfg, "attn"),
                                         cfg.encoder.num_layers)
        defs["enc_final_norm"] = _norm_def(d, True)
        defs["dec_layers"] = _stack_defs(
            layer_defs(cfg, "attn", 0, cross_attn=True), cfg.num_layers)
        defs["dec_pos"] = WeightDef((cfg.max_position, d),
                                    axes=(None, "embed"))
    elif cfg.moe is not None and cfg.moe.first_moe_layer > 0:
        # deepseek-v2: dense layer(s) first, a uniform MoE stack after
        k = cfg.moe.first_moe_layer
        for i in range(k):
            defs[f"layer_{i:02d}"] = layer_defs(cfg, "attn", i)
        defs["layers"] = _stack_defs(layer_defs(cfg, "attn", k),
                                     cfg.num_layers - k)
    else:
        defs["layers"] = _stack_defs(layer_defs(cfg, kinds[0]),
                                     cfg.num_layers)
    return defs


def _leaves(tree: dict, prefix: str = ""):
    """(path, leaf) pairs in sorted key order (the reference's pytree
    flattening order)."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _set(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def init_params(cfg: ModelConfig,
                seed: Union[int, torch.Generator] = 0, *,
                device: Union[str, torch.device] = "cuda") -> dict:
    """Materialise random parameters on ``device`` from a seed (or a
    ``torch.Generator`` on that device): normal weights with scale
    min(0.02, 1/sqrt(fan_in)), norm scales at one, Mamba's ``a_log`` at
    log(1..N) and RG-LRU's ``lam`` so that a lies in (0.9, 0.999), the
    last two in float32 whatever the model's dtype."""
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    dtype = torch_dtype(cfg)
    params: dict = {}
    for path, wd in _leaves(model_defs(cfg)):
        if wd.init == "zeros":
            t = torch.zeros(wd.shape, dtype=dtype, device=device)
        elif wd.init == "ones":
            t = torch.ones(wd.shape, dtype=dtype, device=device)
        elif wd.init == "a_log":
            # mamba S4D-real init: A = -(1..N) per channel
            a = torch.arange(1, wd.shape[-1] + 1, dtype=torch.float32,
                             device=device)
            t = torch.log(a).expand(wd.shape).contiguous()
        elif wd.init == "lam":
            u = torch.empty(wd.shape, dtype=torch.float32, device=device)
            u.uniform_(0.9 ** 2, 0.999 ** 2, generator=gen)
            t = torch.log(torch.exp(-torch.log(u) / (2 * _RG_C)) - 1.0)
        else:
            fan_in = wd.shape[-2] if len(wd.shape) >= 2 else wd.shape[-1]
            scale = min(wd.scale, 1.0 / np.sqrt(fan_in))
            t = (torch.randn(wd.shape, generator=gen, dtype=torch.float32,
                             device=device) * scale).to(dtype)
        _set(params, path, t)
    return params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: move the raw bits
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_numpy(cfg: ModelConfig, tree: dict, *,
                   device: Union[str, torch.device] = "cuda") -> dict:
    """Convert the reference's parameter tree (nested dicts whose leaves
    are numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) into
    the port's, leaf for leaf: same paths, shapes, dtypes and values.

    Call it once per params object: the serving engine keys its KV
    servers on params identity, so an ensemble member that shares the
    probe's params must share the converted tree too."""
    defs = dict(_leaves(model_defs(cfg)))
    got = dict(_leaves(tree))
    if set(got) != set(defs):
        raise ValueError(
            f"{cfg.name}: parameter paths differ: missing "
            f"{sorted(set(defs) - set(got))}, unexpected "
            f"{sorted(set(got) - set(defs))}")
    out: dict = {}
    for path, wd in defs.items():
        t = _to_tensor(got[path], device)    # the leaf's own dtype
        if tuple(t.shape) != wd.shape:
            raise ValueError(f"{cfg.name}: {path} has shape "
                             f"{tuple(t.shape)}, expected {wd.shape}")
        _set(out, path, t)
    return out


def count_params(params: dict) -> int:
    return sum(int(t.numel()) for _, t in _leaves(params))


def _map_defs(fn, tree: dict) -> dict:
    return {k: _map_defs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as tensors on the ``meta`` device (shapes and
    dtypes, no storage), for accounting: the model's dtype, float32 for
    ``a_log`` and ``lam`` as ``init_params`` makes them."""
    dtype = torch_dtype(cfg)

    def meta(wd: WeightDef) -> torch.Tensor:
        dt = torch.float32 if wd.init in _F32_INITS else dtype
        return torch.empty(wd.shape, dtype=dt, device="meta")

    return _map_defs(meta, model_defs(cfg))


def param_specs(cfg: ModelConfig, rules: dict) -> dict:
    """Per-leaf tuples of mesh-axis names (None = not sharded), one per
    dim, mirroring the param tree: each logical axis maps through
    ``rules`` (``sharding/partitioning.py``'s tables), a mesh axis at
    most once per leaf, as the reference's ``PartitionSpec`` tree."""

    def spec(wd: WeightDef) -> tuple:
        out, used = [], set()
        for ax in wd.axes:
            mesh_axis = rules.get(ax) if ax is not None else None
            if mesh_axis is None or mesh_axis in used:
                out.append(None)
            else:
                out.append(mesh_axis)
                used.add(mesh_axis)
        return tuple(out)

    return _map_defs(spec, model_defs(cfg))


__all__ = ["WeightDef", "abstract_params", "count_params", "from_jax_numpy",
           "init_params", "layer_defs", "model_defs", "param_specs",
           "torch_dtype"]
