"""Dry-run accounting: shapes, parameters, memory and FLOPs per
(architecture x input shape), with nothing allocated.

The port of ``repro/launch/dryrun.py``'s accounting. Everything is
computed from the configs and from ``meta`` tensors (shapes and dtypes,
no storage): ``models.params.abstract_params``, ``launch.steps.
input_specs`` and ``models.transformer.init_cache`` on ``meta``. Per
combo ``account`` gives the parameter count, the active parameters, the
useful FLOPs of one step (``model_flops``) and the bytes one device
holds of params, of the step's decode cache and of AdamW's state, on
one card and under the serving mesh's column split over ``model_shards``
columns (``sharding/tp.py``: ``tp_param_specs`` splits the
``_COL_PARALLEL`` leaves' last axis, ``tp_local_cfg`` gives a column's
head counts, so its caches).

The reference's XLA measurements have no torch counterpart and are not
ported: ``compiled.cost_analysis()`` (HLO FLOPs and bytes),
``memory_analysis()``, ``collective_bytes`` parsed from post-SPMD HLO,
the cost-exact correction compiles, and the lowering onto the 512-device
production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch llama3-8b --shape decode_32k --model-shards 2

writes ``experiments/dryrun_torch/<arch>__<shape>__m<shards>.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models.params import _leaves, abstract_params
from repro_torch.models.transformer import init_cache
from repro_torch.sharding.tp import (
    tp_check_cfg, tp_local_cfg, tp_param_specs)

DEFAULT_OUT = Path("experiments/dryrun_torch")
# AdamW's state: mu and nu in float32 for every param, and an int32 step
_ADAM_MOMENTS = 2


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Useful-compute reference: 6*N*D train, 2*N*D forward-only."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch   # one token / request


def should_skip(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention architecture: 524k decode requires "
                "sub-quadratic attention (DESIGN.md §4)")
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict (meta or placed)."""
    return sum(_nbytes(t) for _, t in _leaves(tree))


def params_per_device(cfg: ModelConfig, model_shards: int = 1):
    """(bytes, elements) of one device's params: the whole tree on one
    card; under a column split over ``model_shards`` columns, a
    column's slice of every ``_COL_PARALLEL`` leaf (its last axis /
    model_shards) and every other leaf whole."""
    tree = abstract_params(cfg)
    if model_shards > 1:
        tp_check_cfg(cfg, model_shards)
    specs = dict(_leaves(tp_param_specs(tree)))
    n_bytes = n_elems = 0
    for path, t in _leaves(tree):
        div = model_shards if specs[path] else 1
        n_bytes += _nbytes(t) // div
        n_elems += t.numel() // div
    return n_bytes, n_elems


def cache_bytes_per_device(cfg: ModelConfig, shape: InputShape,
                           model_shards: int = 1) -> int:
    """Bytes of the decode cache the step holds on one device: the
    decode step's input (``input_specs``' cache), the prefill step's
    output, none for training. Under a column split a column keeps its
    kv heads' slice (``tp_local_cfg``); recurrent state and MLA's
    latent stay whole."""
    if shape.kind == "train":
        return 0
    local = tp_local_cfg(cfg, model_shards)
    return tree_bytes(init_cache(local, shape.global_batch, shape.seq_len,
                                 device="meta"))


def account(arch: Union[str, ModelConfig], shape: Union[str, InputShape],
            model_shards: int = 1) -> dict:
    """The accounting of one (arch, shape) combo: ``arch`` a registry id
    or a config, ``shape`` an ``INPUT_SHAPES`` name or an InputShape.
    Bytes are per device: on one card (``param_bytes``, ``cache_bytes``,
    ``adamw_bytes``, the last for training steps only) and, for
    ``model_shards`` > 1, under the column split (the same keys with
    ``_split``)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": cfg.name, "shape": shape.name,
           "model_shards": int(model_shards)}
    skip = should_skip(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec

    def adamw(elems: int) -> int:
        return _ADAM_MOMENTS * 4 * elems + 4 if shape.kind == "train" else 0

    n_bytes, n_elems = params_per_device(cfg)
    rec.update(
        status="ok",
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        param_elements=n_elems,
        num_layers=cfg.num_layers,
        model_flops=model_flops(cfg, shape),
        param_bytes=n_bytes,
        cache_bytes=cache_bytes_per_device(cfg, shape),
        adamw_bytes=adamw(n_elems))
    if model_shards > 1:
        s_bytes, s_elems = params_per_device(cfg, model_shards)
        rec.update(param_bytes_split=s_bytes,
                   cache_bytes_split=cache_bytes_per_device(
                       cfg, shape, model_shards),
                   adamw_bytes_split=adamw(s_elems))
    return rec


def _write(out_dir: Path, rec: dict) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / (f"{rec['arch']}__{rec['shape']}__"
                      f"m{rec['model_shards']}.json")
    path.write_text(json.dumps(rec, indent=1))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", choices=ARCH_IDS)
    ap.add_argument("--shape", action="append", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    archs = list(ARCH_IDS) if (args.all or not args.arch) else args.arch
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else args.shape)
    for arch in archs:
        for shape in shapes:
            try:
                rec = account(arch, shape, args.model_shards)
            except ValueError as e:   # a split the config cannot take
                rec = {"arch": arch, "shape": shape,
                       "model_shards": args.model_shards,
                       "status": "failed", "error": str(e)}
            _write(Path(args.out), rec)
            extra = rec.get("reason") or rec.get("error") or (
                f"params {rec['params']:.4e} flops "
                f"{rec['model_flops']:.4e} param bytes "
                f"{rec['param_bytes']:.4e} cache {rec['cache_bytes']:.4e}")
            print(f"[{rec['status']:7s}] {arch:24s} {shape:12s} {extra}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
