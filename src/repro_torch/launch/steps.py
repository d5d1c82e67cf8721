"""The training step.

The port of ``repro/launch/steps.py::make_train_step`` on one device
(the reference's ``moe_shards`` is 1 there). Abstract input specs,
shardings and the dry-run lowering have no counterpart here yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import _leaves, _set
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
