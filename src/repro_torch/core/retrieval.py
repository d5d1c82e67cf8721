"""Jungler experience store (ACAR-UJ, paper §3.2.4 and §6.1).

Asynchronous retrieval of "similar past experiences" injected into
prompts before dispatch. Embeddings are deterministic hashed
bag-of-token vectors (no learned encoder — keeps the substrate
deterministic); similarity is cosine. The paper's configuration uses
threshold 0.0 (any match), which §6.1 shows is harmful: median
similarity 0.167 injects noise. ``threshold`` reproduces that study.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")
EMBED_DIM = 512


def embed_text(text: str, dim: int = EMBED_DIM) -> np.ndarray:
    """Deterministic hashed bag-of-tokens embedding, L2-normalised."""
    v = np.zeros(dim, np.float32)
    for tok in _TOKEN_RE.findall(text.lower()):
        h = hashlib.blake2b(tok.encode(), digest_size=8).digest()
        idx = int.from_bytes(h[:4], "little") % dim
        sign = 1.0 if h[4] % 2 == 0 else -1.0
        v[idx] += sign
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


@dataclass(frozen=True)
class Experience:
    task_text: str
    answer: str
    correct: bool
    benchmark: str


@dataclass
class ExperienceStore:
    """Append-only store of past (task, answer) experiences."""

    dim: int = EMBED_DIM
    _items: List[Experience] = field(default_factory=list)
    _vecs: List[np.ndarray] = field(default_factory=list)

    def add(self, exp: Experience) -> None:
        self._items.append(exp)
        self._vecs.append(embed_text(exp.task_text, self.dim))

    def __len__(self) -> int:
        return len(self._items)

    def query(self, task_text: str, top_k: int = 1,
              threshold: float = 0.0
              ) -> List[Tuple[Experience, float]]:
        """Top-k experiences with similarity >= threshold."""
        if not self._items:
            return []
        q = embed_text(task_text, self.dim)
        sims = np.asarray(self._vecs) @ q
        order = np.argsort(-sims)[:max(top_k, 1)]
        return [(self._items[i], float(sims[i]))
                for i in order if sims[i] >= threshold]

    def similarity_stats(self, queries: Sequence[str]) -> dict:
        """Hit rate + similarity distribution for a query workload
        (reproduces Fig. 8/9)."""
        sims = []
        hits = 0
        for qtext in queries:
            res = self.query(qtext, top_k=1, threshold=0.0)
            if res:
                hits += 1
                sims.append(res[0][1])
        sims_arr = np.asarray(sims) if sims else np.zeros(1)
        return {
            "hit_rate": hits / max(len(queries), 1),
            "median_similarity": float(np.median(sims_arr)),
            "mean_similarity": float(np.mean(sims_arr)),
            "similarities": [float(s) for s in sims],
        }
