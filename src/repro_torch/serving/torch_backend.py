"""TorchModelBackend — a real zoo model behind the ``ModelBackend``
protocol.

The port of the reference's ``serving/jax_backend.py``: the
orchestrator (``core/orchestrator.py``) runs the *entire* ACAR path
(probe decode -> EXTRACT -> sigma -> routed ensemble -> judge) over
genuinely executing models, one ``sampling.generate`` call per sample.
The model runs on the device that holds its params. Cost is modelled
as active-params x generated-tokens; latency is the host wall time of
the generate call, ending in a device synchronise when the params are
on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import GenResult
from repro_torch.core.extract import extract_math
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import Task
from repro_torch.runtime import deterministic_cuda
from repro_torch.sampling import generate, prng
from repro_torch.teamllm.fingerprint import stable_fingerprint

# $ per active-parameter per generated token (synthetic pricing used to
# make the cost axis comparable across zoo members)
COST_PER_APARAM_TOKEN = 1e-12


@dataclass
class TorchModelBackend:
    name: str
    cfg: ModelConfig
    params: dict
    prompt_len: int = 16
    max_new_tokens: int = 8

    def __post_init__(self):
        self._active_params = self.cfg.active_param_count()
        self.device = self.params["embedding"].device
        if self.device.type == "cuda":
            deterministic_cuda()

    def generate(self, task: Task, prompt: str, *, temperature: float,
                 sample_idx: int = 0, seed: int = 0,
                 **_ignored) -> GenResult:
        ids = tok.encode_aligned([task.text])
        # stable_fingerprint, not hash(): builtin str hashing is salted
        # per process, which would draw different keys for identical
        # runs (breaking the deterministic-execution invariant)
        key = prng.fold_in_np(
            prng.fold_in_np(prng.prng_key(seed), sample_idx),
            stable_fingerprint(task.task_id))
        t0 = time.perf_counter()
        out = generate(
            self.cfg, self.params, torch.from_numpy(ids).to(self.device),
            max_new_tokens=self.max_new_tokens,
            temperature=float(temperature), key=key,
            eos_id=tok.EOS, pad_id=tok.PAD)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        text = tok.decode(out.tokens[0].cpu().numpy())
        latency_ms = (time.perf_counter() - t0) * 1e3
        n_tok = int(out.lengths[0]) or 1
        cost = self._active_params * n_tok * COST_PER_APARAM_TOKEN
        semantic = extract_math(text) if text.strip() else text
        return GenResult(response=text, semantic_answer=semantic,
                         cost=cost, latency_ms=latency_ms)
