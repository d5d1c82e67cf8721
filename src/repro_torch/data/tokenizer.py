"""Deterministic char-level tokenizer for the runnable examples.

Vocabulary covers the arithmetic task surface ("3 + 4 = -7") plus BOS/
EOS/PAD. Fixed, code-defined vocab keeps the substrate deterministic
(no learned tokenizer artifacts to fingerprint).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

PAD, BOS, EOS = 0, 1, 2
_CHARS = "0123456789+-*= ."
CHAR_TO_ID = {c: i + 3 for i, c in enumerate(_CHARS)}
ID_TO_CHAR = {i: c for c, i in CHAR_TO_ID.items()}
VOCAB_SIZE = 3 + len(_CHARS)


def encode(text: str, add_bos: bool = True,
           add_eos: bool = False) -> List[int]:
    ids = [CHAR_TO_ID[c] for c in text if c in CHAR_TO_ID]
    if add_bos:
        ids = [BOS] + ids
    if add_eos:
        ids = ids + [EOS]
    return ids


def decode(ids: Sequence[int]) -> str:
    out = []
    for i in ids:
        i = int(i)
        if i == EOS:
            break
        if i in (PAD, BOS):
            continue
        out.append(ID_TO_CHAR.get(i, ""))
    return "".join(out)


def encode_batch(texts: Sequence[str], length: int) -> np.ndarray:
    """Right-pad each encoded text to ``length`` (PAD)."""
    out = np.full((len(texts), length), PAD, np.int32)
    for r, t in enumerate(texts):
        ids = encode(t)[:length]
        out[r, :len(ids)] = ids
    return out


def encode_aligned(texts: Sequence[str]) -> np.ndarray:
    """Encode prompts for GENERATION: uniform length, no padding.

    Right-padding a prompt before decoding puts PAD tokens between the
    prompt and the model's continuation — a train/serve mismatch that
    wrecks generation. The arithmetic task surface is naturally uniform
    ("d op d = "); this asserts that and appends the trailing space the
    training corpus used before the answer span.
    """
    rows = [encode(t if t.endswith(" ") else t + " ") for t in texts]
    length = len(rows[0])
    assert all(len(r) == length for r in rows),         "generation prompts must be uniform length (got mixed lengths)"
    return np.asarray(rows, np.int32)
