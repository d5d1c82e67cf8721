"""Escalated-subset compaction for batched ensemble decodes.

The port of ``repro/serving/compaction.py``. Most rows of a wave need
no ensemble work (the paper's sigma=0 rate is 54.2%), yet a masked
decode pays for every row. Compaction gathers the escalated rows into
a dense sub-batch, padded up to a power-of-two shape bucket, decodes
it and scatters the answers back to their full-batch positions. The
judge sees the same inputs either way: greedy decode of a
batch-invariant config gives a row the same tokens whatever batch it
shares, and rows the mask would have discarded are never decoded.

Pure host-side planning and accounting, shared by the wave engine
(``serving/engine.py::run_batch``) and the step loop's buckets.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


def bucket_size(k: int, cap: Optional[int] = None) -> int:
    """Smallest power of two >= k (0 stays 0), clipped to ``cap`` —
    but never below k itself (callers pass cap >= k, e.g. the batch
    size when k counts escalated rows of that batch)."""
    if k <= 0:
        return 0
    b = 1 << (int(k) - 1).bit_length()
    if cap is not None and b > cap:
        b = max(cap, int(k))
    return b


@dataclass(frozen=True)
class MemberPlan:
    """Decode plan for one ensemble member over one micro-batch."""
    member: int
    rows: np.ndarray          # int64 indices of escalated rows
    bucket: int               # padded sub-batch size (0 = skip decode)

    @property
    def n_rows(self) -> int:
        return int(self.rows.size)

    @property
    def occupancy(self) -> float:
        return self.n_rows / self.bucket if self.bucket else 0.0

    def padded_rows(self) -> np.ndarray:
        """Gather indices padded to the bucket by replicating the first
        escalated row (a valid prompt, so padding rows decode real —
        discarded — work with no risk of degenerate inputs)."""
        if self.n_rows == 0:
            return self.rows
        pad = np.full(self.bucket - self.n_rows, self.rows[0],
                      self.rows.dtype)
        return np.concatenate([self.rows, pad])


@dataclass
class CompactionPlan:
    """Per-member decode plans plus the savings accounting."""
    batch: int
    members: List[MemberPlan]
    escalated_rows: int       # rows with modes >= 1 (arena_lite+)
    full_arena_rows: int      # rows with modes >= 2

    # -- decode accounting (row-steps; multiply by max_new_tokens for
    # tokens) -----------------------------------------------------------
    @property
    def compacted_decode_rows(self) -> int:
        return sum(m.bucket for m in self.members)

    @property
    def masked_decode_rows(self) -> int:
        """What the masked path decodes: the full batch for every
        member that has at least one escalated row."""
        return sum(self.batch for m in self.members if m.n_rows)

    @property
    def decode_rows_saved(self) -> int:
        return self.masked_decode_rows - self.compacted_decode_rows

    def decode_tokens(self, max_new_tokens: int) -> int:
        return self.compacted_decode_rows * max_new_tokens

    def decode_tokens_saved(self, max_new_tokens: int) -> int:
        return self.decode_rows_saved * max_new_tokens


def plan_compaction(modes: Sequence[int], n_members: int,
                    arena_lite_size: int,
                    max_bucket: Optional[int] = None) -> CompactionPlan:
    """Plan the escalated-subset decode for one micro-batch.

    modes: per-row mode ids (0=single_agent, 1=arena_lite,
    2=full_arena). Member ``mi`` decodes the rows with
    ``modes >= 1`` when it belongs to the arena-lite pair
    (mi < arena_lite_size) and the ``modes >= 2`` subset otherwise —
    the same predicate the masked path applies after decoding.
    """
    modes = np.asarray(modes)
    b = int(modes.shape[0])
    cap = b if max_bucket is None else min(max_bucket, b)
    members = []
    for mi in range(n_members):
        needed = modes >= (1 if mi < arena_lite_size else 2)
        rows = np.nonzero(needed)[0]
        members.append(MemberPlan(
            member=mi, rows=rows,
            bucket=bucket_size(int(rows.size), cap)))
    return CompactionPlan(
        batch=b, members=members,
        escalated_rows=int(np.sum(modes >= 1)),
        full_arena_rows=int(np.sum(modes >= 2)))


@dataclass
class CompactionStats:
    """Savings record for one served batch (engine) or wave (scheduler).

    Token counts are real decode-token units; FLOP figures use the
    2 * active_params * tokens dense-transformer estimate — the honest
    per-decode accounting the Unsolvability Ceiling study calls for.
    """
    batch: int = 0
    escalated_rows: int = 0
    full_arena_rows: int = 0
    ensemble_decode_tokens: int = 0
    ensemble_decode_tokens_saved: int = 0
    probe_prefill_tokens: int = 0
    probe_prefill_tokens_saved: int = 0
    probe_prefill_flops_saved: float = 0.0
    bucket_rows: List[int] = field(default_factory=list)
    bucket_sizes: List[int] = field(default_factory=list)

    def merge(self, other: "CompactionStats") -> None:
        self.batch += other.batch
        self.escalated_rows += other.escalated_rows
        self.full_arena_rows += other.full_arena_rows
        self.ensemble_decode_tokens += other.ensemble_decode_tokens
        self.ensemble_decode_tokens_saved += \
            other.ensemble_decode_tokens_saved
        self.probe_prefill_tokens += other.probe_prefill_tokens
        self.probe_prefill_tokens_saved += \
            other.probe_prefill_tokens_saved
        self.probe_prefill_flops_saved += other.probe_prefill_flops_saved
        self.bucket_rows.extend(other.bucket_rows)
        self.bucket_sizes.extend(other.bucket_sizes)

    @property
    def ensemble_decode_token_reduction(self) -> float:
        """masked / compacted decode-token ratio (>= 1)."""
        if self.ensemble_decode_tokens <= 0:
            return float("inf") if self.ensemble_decode_tokens_saved \
                else 1.0
        return (self.ensemble_decode_tokens
                + self.ensemble_decode_tokens_saved) \
            / self.ensemble_decode_tokens

    @property
    def probe_prefill_reduction(self) -> float:
        if self.probe_prefill_tokens <= 0:
            return 1.0
        return (self.probe_prefill_tokens
                + self.probe_prefill_tokens_saved) \
            / self.probe_prefill_tokens
