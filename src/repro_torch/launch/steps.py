"""Step builders and abstract input specs.

The port of ``repro/launch/steps.py``: ``make_train_step`` on one
device (the reference's ``moe_shards`` is 1 there), ``make_prefill_step``
and ``make_serve_step``, and ``input_specs``, one step's model inputs as
tensors on the ``meta`` device (shapes and dtypes, no storage), for
the dry-run accounting (``launch/dryrun.py``). The reference's sharding
helpers and its lowering onto the production mesh are XLA's and have no
counterpart here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.models.frontends import (
    audio_frame_shape, vision_patch_shape)
from repro_torch.models.params import _leaves, _set, torch_dtype
from repro_torch.optim import AdamWState, softmax_cross_entropy, update
from repro_torch.optim.adamw import tree_map


def loss_and_grads(cfg: ModelConfig, params: dict,
                   batch: Dict[str, torch.Tensor], remat: bool = False):
    """The training loss and its gradient in every param leaf.

    ``batch`` holds ``tokens`` and ``labels`` (B, S) and optionally
    ``loss_mask``, on the params' device. The total loss is the
    cross-entropy plus, for a MoE config, ``router_aux_weight`` times
    the router's load-balancing aux, as the reference's step adds it.
    It is differentiated through ``transformer.forward`` (the kernels'
    autograd Functions on the card); a leaf the loss does not reach gets
    a zero gradient. Returns (total loss, metrics, grads), detached."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    logits, aux = T.forward(cfg, p, batch["tokens"],
                            batch.get("frontend_embeds"), remat=remat)
    loss, met = softmax_cross_entropy(logits, batch["labels"],
                                      batch.get("loss_mask"))
    total = loss
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_weight * aux
    paths, leaves = zip(*_leaves(p))
    grads: dict = {}
    for path, x, g in zip(paths, leaves, torch.autograd.grad(
            total, leaves, allow_unused=True)):
        _set(grads, path, torch.zeros_like(x) if g is None else g)
    met = {k: v.detach() for k, v in met.items()}
    return total.detach(), dict(met, aux_loss=aux.detach()), grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics):
    ``loss_and_grads`` and one AdamW update, which returns new
    params."""
    remat = cfg.remat == "layer"

    def train_step(params: dict, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        total, met, grads = loss_and_grads(cfg, params, batch, remat)
        new_params, new_state, om = update(params, grads, opt_state, tc)
        return new_params, new_state, {**met, **om, "total_loss": total}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """(params, tokens[, frontend]) -> (last-position logits, decode
    cache)."""

    def prefill_step(params, tokens, frontend_embeds=None):
        return T.prefill(cfg, params, tokens, frontend_embeds)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, token, pos) -> (logits, cache)."""

    def serve_step(params, cache, token, pos):
        return T.decode_step(cfg, params, cache, token, pos)

    return serve_step


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_spec(cfg: ModelConfig, batch: int):
    if cfg.frontend == "audio":
        return _meta(audio_frame_shape(cfg, batch), torch_dtype(cfg))
    if cfg.frontend == "vision":
        return _meta(vision_patch_shape(cfg, batch), torch_dtype(cfg))
    return None


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """One step's model inputs as ``meta`` tensors (no storage):

    train   -> {tokens, labels, loss_mask[, frontend_embeds]}
    prefill -> {tokens[, frontend_embeds]}
    decode  -> {cache, token, pos}, the cache ``init_cache``'s tree
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"cache": T.init_cache(cfg, b, s, device="meta"),
                "token": _meta((b,), torch.int32),
                "pos": _meta((), torch.int32)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(f"unknown input-shape kind {shape.kind!r}")
    out = {"tokens": _meta((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
        out["loss_mask"] = _meta((b, s), torch.float32)
    fe = _frontend_spec(cfg, b)
    if fe is not None:
        out["frontend_embeds"] = fe
    return out
