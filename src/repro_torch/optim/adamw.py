"""AdamW + warmup-cosine schedule + global-norm clipping.

The port of ``repro/optim/adamw.py`` over nested dicts of tensors: the
moments are float32, and each update runs in float32 before the cast
back to the param's dtype. Leaves are visited in sorted-key order, the
order jax flattens a dict in, so the global norm sums them in the
reference's order. The step count and the learning rate live on the
host (the step is a Python int), so an update copies nothing between
host and card; the schedule rounds as the reference's float32 graph
does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import _leaves


class AdamWState(NamedTuple):
    step: int                # optimizer steps taken
    mu: dict                 # first moment (float32)
    nu: dict                 # second moment (float32)


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """Apply ``fn`` leaf by leaf over trees of one structure, visiting
    keys in sorted order."""
    out = {}
    for k in sorted(tree):
        args = (tree[k], *(r[k] for r in rest))
        out[k] = (tree_map(fn, *args) if isinstance(tree[k], dict)
                  else fn(*args))
    return out


def init(params: dict) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def cosine_schedule(step: int, tc: TrainConfig) -> float:
    """Linear warmup to ``learning_rate`` then cosine decay to 10%,
    rounded in float32 as the reference computes it."""
    f32 = np.float32
    if step < tc.warmup_steps:
        return float(f32(tc.learning_rate) * f32(step + 1)
                     / f32(max(tc.warmup_steps, 1)))
    frac = np.clip(f32(step - tc.warmup_steps)
                   / f32(max(tc.total_steps - tc.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.1) + f32(0.9 * 0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
    return float(f32(tc.learning_rate) * cos)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for _, leaf in _leaves(tree)))


def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> Tuple[dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def update(params: dict, grads: dict, state: AdamWState,
           tc: TrainConfig) -> Tuple[dict, AdamWState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics); the
    params are new tensors, as the reference's are new arrays."""
    grads = tree_map(lambda g: g.float(), grads)
    if tc.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    else:
        gnorm = global_norm(grads)

    step = state.step
    lr = cosine_schedule(step, tc)
    t = np.float32(step + 1)
    bc1 = float(np.float32(1.0) - np.float32(tc.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(tc.b2) ** t)

    mu = tree_map(lambda m, g: tc.b1 * m + (1 - tc.b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: tc.b2 * v + (1 - tc.b2) * g * g, state.nu,
                  grads)

    def step_fn(p, m, v):
        upd = (m / bc1) / (torch.sqrt(v / bc2) + tc.eps)
        upd = upd + tc.weight_decay * p.float()
        return (p.float() - lr * upd).to(p.dtype)

    new_params = tree_map(step_fn, params, mu, nu)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, AdamWState(step + 1, mu, nu), metrics
