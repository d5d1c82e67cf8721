"""Training example: train a zoo model on the arithmetic corpus
and sample from it.

    PYTHONPATH=src python examples_torch/train_model.py  # ~1M params
    PYTHONPATH=src python examples_torch/train_model.py --size 100m

``--size 100m`` uses the real smollm-135m stack (30L x 576) with the
char-level vocabulary (106.2M parameters, nearly all in the 30 layers),
in f32: on the card every layer's MLP runs the fused SwiGLU kernel and
the greedy samples' decode the dense-cache attention kernel. Runs on
the card; ``--device cpu`` runs the kernels' plain versions on the CPU
instead (a few hundred 100m steps there take a while).
"""
import argparse
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.data.pipeline import arithmetic_batches
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import params as params_lib
from repro_torch.optim import init as opt_init
from repro_torch.runtime import deterministic_cuda, require_device
from repro_torch.sampling import generate

PROMPTS = ("3 + 4 = ", "9 - 5 = ", "7 + 8 = ", "2 - 6 = ")
LOG_EVERY = 20
# train_full's arithmetic batches: small, so that a CPU step stays
# tractable at 100m
FULL_BATCH, FULL_SEQ = 8, 24


def arith_100m_config():
    """smollm-135m's published stack with the arithmetic vocabulary,
    f32 and tied embeddings."""
    return get_config("smollm-135m").replace(
        vocab_size=tok.VOCAB_SIZE, dtype="float32",
        tie_embeddings=True, name="smollm-arith-100m")


def main(argv=None, *, device: str = "cuda"):
    """Train at ``--size`` on ``--device`` (default ``device``), print
    the greedy samples and return (cfg, params)."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--size", choices=("tiny", "100m"), default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    if args.size == "100m":
        cfg = arith_100m_config()
        params = params_lib.init_params(cfg, 0, device=dev)
        n = params_lib.count_params(params)
        print(f"training {cfg.name}: {n / 1e6:.1f}M params")
        cfg, params, _ = train_full(cfg, args.steps, params=params,
                                    device=dev)
    else:
        cfg, params, _ = train(arch="smollm-135m", data="arithmetic",
                               steps=args.steps, batch=64, seq=24,
                               lr=2e-3, ckpt=args.ckpt, device=args.device)

    # sample: ask the model some sums
    for line in sample_lines(cfg, params):
        print(line)
    return cfg, params


def sample_lines(cfg, params) -> list:
    """Greedy answers to ``PROMPTS`` (6 new tokens each), one printable
    line a prompt."""
    ids = torch.from_numpy(tok.encode_batch(PROMPTS, 12))
    out = generate(cfg, params, ids, max_new_tokens=6,
                   temperature=0.0, eos_id=tok.EOS, pad_id=tok.PAD)
    return [f"  {p!r} -> {tok.decode(row)!r}"
            for p, row in zip(PROMPTS, out.tokens.cpu().tolist())]


def full_train_config(steps: int) -> TrainConfig:
    """``train_full``'s optimizer schedule for ``steps`` steps."""
    return TrainConfig(learning_rate=1e-3, warmup_steps=50,
                       total_steps=steps)


def train_full(cfg, steps, *, params=None, device="cuda", on_step=None):
    """``steps`` AdamW steps of ``cfg`` on arithmetic batches of
    ``FULL_BATCH`` x ``FULL_SEQ`` on ``device``, from ``params``
    (default: ``init_params(cfg, 0)``); logs every ``LOG_EVERY`` steps with the seconds a step so far.
    ``on_step(i, metrics)`` sees each step's metrics (device tensors).
    Returns (cfg, params, the last step's metrics)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        deterministic_cuda()
    if params is None:
        params = params_lib.init_params(cfg, 0, device=dev)
    opt_state = opt_init(params)
    step = make_train_step(cfg, full_train_config(steps))
    it = arithmetic_batches(FULL_BATCH, FULL_SEQ, seed=0)
    t0 = time.perf_counter()
    m = {}
    for i in range(steps):
        b = next(it)
        params, opt_state, m = step(params, opt_state, {
            "tokens": torch.from_numpy(b.tokens).to(dev),
            "labels": torch.from_numpy(b.labels).to(dev),
            "loss_mask": torch.from_numpy(b.loss_mask).to(dev)})
        if on_step is not None:
            on_step(i, m)
        if i % LOG_EVERY == 0:
            loss = float(m["loss"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"step {i:4d} loss {loss:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    return cfg, params, m


if __name__ == "__main__":
    main()
