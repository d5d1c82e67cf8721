"""Modality frontends: stand-ins for the stubbed encoders' outputs.

The port of ``repro/models/frontends.py``. The audio (mel-spectrogram +
conv) and vision (ViT/SigLIP + projector) encoders are not implemented
in either package; these helpers give the shapes of their outputs and
deterministic synthetic embeddings for training, serving and checks.
The synthetic values come from a ``torch.Generator`` seeded on the
target device (the idiom of ``params.init_params``), not from
``jax.random``: the two packages draw different numbers from one seed,
so checks that compare them feed both the same arrays.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import torch_dtype


def audio_frame_shape(cfg: ModelConfig, batch: int):
    e = cfg.encoder
    assert e is not None, "audio frontend requires an encoder config"
    return (batch, e.num_frames, e.d_frontend)


def vision_patch_shape(cfg: ModelConfig, batch: int):
    assert cfg.num_patches > 0, "vision frontend requires num_patches"
    return (batch, cfg.num_patches, cfg.d_model)


def _normal(cfg: ModelConfig, shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * 0.02).to(torch_dtype(cfg))


def synthetic_frames(cfg: ModelConfig, batch: int, seed: int = 0, *,
                     device: Union[str, torch.device] = "cuda"
                     ) -> torch.Tensor:
    """Deterministic stand-in for mel+conv output (B, F, d)."""
    return _normal(cfg, audio_frame_shape(cfg, batch), seed, device)


def synthetic_patches(cfg: ModelConfig, batch: int, seed: int = 0, *,
                      device: Union[str, torch.device] = "cuda"
                      ) -> torch.Tensor:
    """Deterministic stand-in for ViT+projector output (B, P, d)."""
    return _normal(cfg, vision_patch_shape(cfg, batch), seed, device)
