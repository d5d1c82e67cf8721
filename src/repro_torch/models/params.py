"""Parameter definitions, initialisation, and conversion from the
reference's parameter tree.

Each weight is declared once as a ``WeightDef`` (shape + init kind);
``init_params`` materialises the tree and ``from_jax_numpy`` checks a
converted tree against it leaf for leaf. The tree is the reference's:
nested dicts with the scanned layer stack under ``"layers"`` carrying a
leading layers axis. Only the dense family is ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

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
    init: str = "normal"          # normal | zeros | ones
    scale: float = 0.02


def _norm_def(d: int) -> Dict[str, WeightDef]:
    return {"scale": WeightDef((d,), "ones")}


def _layer_defs(cfg: ModelConfig, n: int) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    return {
        "attn_norm": {"scale": WeightDef((n, d), "ones")},
        "attn": {
            "wq": WeightDef((n, d, h * hd)),
            "wk": WeightDef((n, d, kv * hd)),
            "wv": WeightDef((n, d, kv * hd)),
            "wo": WeightDef((n, h * hd, d)),
        },
        "mlp_norm": {"scale": WeightDef((n, d), "ones")},
        "mlp": {
            "w_gate": WeightDef((n, d, f)),
            "w_up": WeightDef((n, d, f)),
            "w_down": WeightDef((n, f, d)),
        },
    }


def model_defs(cfg: ModelConfig) -> dict:
    """Full parameter def tree for a dense GQA architecture."""
    if not (cfg.family == "dense" and cfg.attn_kind == "gqa"
            and cfg.moe is None and cfg.frontend is None
            and cfg.layer_pattern is None):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported")
    d, v = cfg.d_model, cfg.vocab_size
    defs: dict = {
        "embedding": WeightDef((v, d)),
        "final_norm": _norm_def(d),
        "layers": _layer_defs(cfg, cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = WeightDef((d, v))
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
    min(0.02, 1/sqrt(fan_in)), norm scales at one."""
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
        t = _to_tensor(got[path], device)
        if tuple(t.shape) != wd.shape:
            raise ValueError(f"{cfg.name}: {path} has shape "
                             f"{tuple(t.shape)}, expected {wd.shape}")
        _set(out, path, t)
    return out


def count_params(params: dict) -> int:
    return sum(int(t.numel()) for _, t in _leaves(params))


__all__ = ["WeightDef", "count_params", "from_jax_numpy", "init_params",
           "model_defs", "torch_dtype"]
