"""Training data pipelines.

Two sources, one interface (an iterator of ``Batch``):

* ``arithmetic_batches`` — genuinely learnable char-level arithmetic
  ("a + b = c<eos>"), loss-masked to the answer span. The example
  scripts train the reduced zoo models on this so the end-to-end ACAR
  serving path runs over models that actually know something.
* ``synthetic_lm_batches`` — deterministic Zipf-distributed token
  stream with local n-gram structure, for throughput-style training
  runs at arbitrary (batch, seq, vocab). Purely seeded; no files.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from repro_torch.data import tokenizer as tok


@dataclass(frozen=True)
class Batch:
    tokens: np.ndarray       # (B, S) int32 — model input
    labels: np.ndarray       # (B, S) int32 — next-token targets
    loss_mask: np.ndarray    # (B, S) float32


def _arith_example(rng: np.random.Generator, max_operand: int
                   ) -> Tuple[str, str]:
    a = int(rng.integers(0, max_operand + 1))
    b = int(rng.integers(0, max_operand + 1))
    op = "+" if rng.random() < 0.5 else "-"
    res = a + b if op == "+" else a - b
    return f"{a} {op} {b} = ", str(res)


def arithmetic_batches(batch_size: int, seq_len: int, *,
                       seed: int = 0, max_operand: int = 9
                       ) -> Iterator[Batch]:
    """Infinite stream of fixed-shape arithmetic batches."""
    rng = np.random.default_rng(seed)
    while True:
        tokens = np.full((batch_size, seq_len), tok.PAD, np.int32)
        mask = np.zeros((batch_size, seq_len), np.float32)
        for r in range(batch_size):
            prompt, answer = _arith_example(rng, max_operand)
            ids = tok.encode(prompt) + tok.encode(
                answer, add_bos=False, add_eos=True)
            ids = ids[:seq_len]
            tokens[r, :len(ids)] = ids
            ans_start = len(tok.encode(prompt))
            # loss on predicting the answer span (incl. EOS):
            # position i predicts token i+1.
            mask[r, max(ans_start - 1, 0):len(ids) - 1] = 1.0
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = tok.PAD
        yield Batch(tokens=tokens, labels=labels, loss_mask=mask)


def synthetic_lm_batches(batch_size: int, seq_len: int, vocab: int, *,
                         seed: int = 0, zipf_a: float = 1.2
                         ) -> Iterator[Batch]:
    """Deterministic structured token stream (Zipf unigrams + a cyclic
    bigram tendency so there is signal to learn)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    while True:
        base = rng.choice(vocab, size=(batch_size, seq_len), p=probs)
        # bigram structure: with p=0.35 a token is (prev*7+3) % vocab
        follow = (np.roll(base, 1, axis=1) * 7 + 3) % vocab
        pick = rng.random((batch_size, seq_len)) < 0.35
        tokens = np.where(pick, follow, base).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        mask = np.ones((batch_size, seq_len), np.float32)
        mask[:, -1] = 0.0
        yield Batch(tokens=tokens, labels=labels, loss_mask=mask)
