"""Training entry point.

The port of ``repro/launch/train.py``: build the config, init params
and the optimizer on the device, and run the train step over the data
pipeline. Runs on the card unless ``device="cpu"`` is asked for (the
tests do); on the card TF32 is off and algorithms are deterministic, so
a rerun reproduces its losses and params.

CLI (reduced configs):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-135m --data arithmetic --steps 300 \\
        --batch 64 --seq 24 --ckpt /tmp/smollm.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import tokenizer as tok
from repro_torch.data.pipeline import arithmetic_batches, synthetic_lm_batches
from repro_torch.launch.steps import make_train_step
from repro_torch.models import params as params_lib
from repro_torch.models.frontends import synthetic_frames, synthetic_patches
from repro_torch.optim import init as opt_init
from repro_torch.runtime import deterministic_cuda


def reduced_for_data(arch: str, data: str):
    """Reduced config adapted to the selected dataset."""
    cfg = get_config(arch, reduced=True)
    if data == "arithmetic":
        cfg = cfg.replace(vocab_size=tok.VOCAB_SIZE, dtype="float32",
                          tie_embeddings=True)
    else:
        cfg = cfg.replace(dtype="float32")
    return cfg


def train(arch: str = "smollm-135m", data: str = "arithmetic",
          steps: int = 300, batch: int = 64, seq: int = 24,
          lr: float = 1e-3, seed: int = 0,
          ckpt: Optional[str] = None, log_every: int = 50,
          reduced: bool = True, verbose: bool = True,
          device: str = "cuda"):
    """Train ``arch`` for ``steps`` steps on ``device``; returns (cfg,
    params, last metrics) and writes an npz checkpoint to ``ckpt``. An
    audio or vision model gets the same synthetic frames or patches
    (``models.frontends``, from ``seed``) on every step, as the
    reference's trainer gives them."""
    dev = torch.device(device)
    if dev.type == "cuda":
        deterministic_cuda()
    cfg = reduced_for_data(arch, data) if reduced \
        else get_config(arch)
    tc = TrainConfig(learning_rate=lr, warmup_steps=min(50, steps // 4),
                     total_steps=steps, seed=seed)
    params = params_lib.init_params(cfg, seed, device=dev)
    opt_state = opt_init(params)
    step_fn = make_train_step(cfg, tc)

    if data == "arithmetic":
        it = arithmetic_batches(batch, seq, seed=seed)
    else:
        it = synthetic_lm_batches(batch, seq, cfg.vocab_size, seed=seed)

    fe = None
    if cfg.frontend == "audio":
        fe = synthetic_frames(cfg, batch, seed, device=dev)
    elif cfg.frontend == "vision":
        fe = synthetic_patches(cfg, batch, seed, device=dev)

    t0 = time.perf_counter()
    metrics = {}
    for i in range(steps):
        b = next(it)
        batch_dict = {
            "tokens": torch.from_numpy(b.tokens).to(dev),
            "labels": torch.from_numpy(b.labels).to(dev),
            "loss_mask": torch.from_numpy(b.loss_mask).to(dev),
        }
        if fe is not None:
            batch_dict["frontend_embeds"] = fe
        params, opt_state, metrics = step_fn(params, opt_state,
                                             batch_dict)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                  f"tok_acc {float(metrics['token_accuracy']):.3f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"lr {float(metrics['lr']):.2e}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if verbose:
        n_params = params_lib.count_params(params)
        print(f"trained {arch} ({n_params / 1e6:.1f}M params) "
              f"{steps} steps in {wall:.1f}s "
              f"({steps / wall:.2f} steps/s) on {dev}")
    if ckpt:
        save_checkpoint(ckpt, params, step=steps,
                        metadata={"arch": arch, "data": data})
        if verbose:
            print(f"checkpoint -> {ckpt}")
    return cfg, params, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--data", default="arithmetic",
                    choices=("arithmetic", "synthetic"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=24)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(arch=args.arch, data=args.data, steps=args.steps,
          batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
          ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
