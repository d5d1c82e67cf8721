"""A fleet's weights, made on the device from ``--seed``.

The tree is the one ``repro_torch`` serves (nested dicts, each layer
kind's leaves stacked on a leading layers axis), written out here so
that the weights are the benchmark's inputs and not the program's:
both the program and the reference read this same tree. Each leaf is
one draw of a ``torch.Generator`` on the card, in the dtype it is
served in: normal weights scaled by min(0.02, 1/sqrt(fan_in)), norm
scales and Mamba's D one, biases zero, Mamba's A_log = log(1..N) in
float32.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _ssm_dims(m: dict):
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    dt_rank = s.get("dt_rank") or -(-m["d_model"] // 16)
    return d_in, dt_rank, s["state_dim"], s["conv_width"]


def leaf_specs(m: dict) -> Dict[str, Tuple[tuple, str]]:
    """path -> (shape, init) of every leaf of a model's tree; init is
    normal, ones, zeros or a_log."""
    d, v, layers = m["d_model"], m["vocab_size"], m["num_layers"]
    out = {"embedding": ((v, d), "normal"),
           "final_norm/scale": ((d,), "ones")}
    if not m.get("tie_embeddings", False):
        out["lm_head"] = ((d, v), "normal")
    if m["family"] == "ssm":
        d_in, dt_rank, n, width = _ssm_dims(m)
        layer = {"norm/scale": ((d,), "ones"),
                 "ssm/w_in_x": ((d, d_in), "normal"),
                 "ssm/w_in_z": ((d, d_in), "normal"),
                 "ssm/conv_w": ((width, d_in), "normal"),
                 "ssm/conv_b": ((d_in,), "zeros"),
                 "ssm/w_xproj": ((d_in, dt_rank + 2 * n), "normal"),
                 "ssm/w_dt": ((dt_rank, d_in), "normal"),
                 "ssm/b_dt": ((d_in,), "zeros"),
                 "ssm/a_log": ((d_in, n), "a_log"),
                 "ssm/d_skip": ((d_in,), "ones"),
                 "ssm/w_out": ((d_in, d), "normal")}
    elif m["family"] == "dense":
        hd = m.get("head_dim") or d // m["num_heads"]
        h, kv, f = m["num_heads"], m["num_kv_heads"], m["d_ff"]
        layer = {"attn_norm/scale": ((d,), "ones"),
                 "attn/wq": ((d, h * hd), "normal"),
                 "attn/wk": ((d, kv * hd), "normal"),
                 "attn/wv": ((d, kv * hd), "normal"),
                 "attn/wo": ((h * hd, d), "normal"),
                 "mlp_norm/scale": ((d,), "ones"),
                 "mlp/w_gate": ((d, f), "normal"),
                 "mlp/w_up": ((d, f), "normal"),
                 "mlp/w_down": ((f, d), "normal")}
    else:
        raise ValueError(f"no weights for family {m['family']!r}")
    for path, (shape, init) in layer.items():
        out[f"layers/{path}"] = ((layers,) + shape, init)
    return out


def _set(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def generator_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for weight set ``index`` under ``seed``."""
    h = hashlib.sha256(f"perfbench-weights:{int(seed)}:{int(index)}"
                       .encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def make_weights(m: dict, seed: int, index: int, device) -> dict:
    """Weight set ``index`` of model ``m`` under ``seed``, on ``device``."""
    dtype = _DTYPES[m["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, index))
    tree: dict = {}
    for path, (shape, init) in sorted(leaf_specs(m).items()):
        if init == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "a_log":
            a = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            t = torch.log(a).expand(shape).contiguous()
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            t.mul_(min(0.02, 1.0 / math.sqrt(fan_in)))
        _set(tree, path, t)
    return tree


def fleet_weights(config: dict, seed: int, device) -> dict:
    """(model, weight index) -> tree, one per distinct pair of the
    fleet, so a twin gets the very tree object of its probe."""
    out = {}
    for entry in [config["probe"]] + list(config["ensemble"]):
        key = (entry["model"], entry["weights"])
        if key not in out:
            out[key] = make_weights(config["models"][entry["model"]], seed,
                                    entry["weights"], device)
    return out
