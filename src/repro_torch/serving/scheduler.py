"""Step-level scheduling policy.

The port of ``StepPlanner`` from ``repro/serving/scheduler.py``: the
per-tick admission, chunk-sizing, bucket and megastep decisions of the
step-level serving loop (serving/step_loop.py). The wave scheduler
(``ContinuousBatchingScheduler``), shard placement and on-capacity
attribution are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.serving.compaction import bucket_size


@dataclass(frozen=True)
class StepPlanner:
    """Per-step scheduling policy for the step-level serving loop.

    * **admission** — a queued request joins the active set only when
      the fill-or-timeout trigger (``AdmissionQueue.ready``) has fired,
      the active-row cap has room, and the page budget is open: the
      row's worst-case page need (prompt pages + sample/decode tails)
      must fit in the pool's free pages net of what already-admitted
      rows may still allocate. Reservation-based admission is what
      makes mid-stream retirement safe: a row that got in can always
      finish.
    * **chunk sizing** — prompts prefill in fixed ``chunk_tokens``
      slices (the last chunk takes the remainder), bounding the
      per-step prefill working set regardless of prompt length.
    * **bucket selection** — each step's mixed decode/prefill groups
      pad to power-of-two row buckets (``bucket_size``), so a launch
      sees at most log2(rows)+1 shapes per (server, phase) instead of
      one per occupancy.
    * **megastep span** — decode groups fuse up to ``megastep`` ticks
      into one launch (``sampler.decode_megastep_rows``); lane state
      stays on the device between launches and only emitted token ids
      + done bits come back per megastep. Rows finishing mid-megastep
      burn <= K-1 masked steps (``StepStats.masked_decode_steps``).
      Sampling keys derive from (admission index, per-row step
      counter), so K is a pure performance knob — any value emits
      identical streams. With ``megastep_auto`` the span is capped by
      the group's *shortest* remaining budget, so no lane can overrun
      its budget mid-launch.
    """
    chunk_tokens: int = 8
    max_active_rows: int = 8
    megastep: int = 1
    megastep_auto: bool = False

    def __post_init__(self) -> None:
        if self.megastep < 1:
            raise ValueError(
                f"megastep must be >= 1, got {self.megastep}")

    def chunk_span(self, pos: int, prompt_len: int) -> int:
        """Tokens the next prefill step of a row at ``pos`` covers."""
        return min(self.chunk_tokens, prompt_len - pos)

    def chunk_count(self, prompt_len: int) -> int:
        """Prefill steps (virtual-clock units) a whole prompt costs."""
        return -(-prompt_len // self.chunk_tokens)

    def decode_bucket(self, rows: int, cap: Optional[int] = None) -> int:
        return bucket_size(rows, cap)

    def may_admit(self, active_rows: int, free_pages: int,
                  reserved_pages: int, row_need: int) -> bool:
        return (active_rows < self.max_active_rows
                and free_pages - reserved_pages >= row_need)
