"""Admission queue + micro-batch formation for the ACAR scheduler.

Requests arrive with a logical arrival tick (deterministic: supplied by
the caller or auto-incremented), wait in FIFO order, and are admitted
into micro-batches under a joint budget:

* ``max_batch_size``   — at most B requests per micro-batch;
* ``max_batch_tokens`` — the summed prompt-token estimate must stay
  under the budget (the decode wave's memory/latency proxy);
* ``max_wait_ticks``   — a request older than this forces the batch to
  close even if under budget, bounding queueing latency.

Everything is host-side and deterministic — the queue introduces no
randomness, so batched execution stays replayable and auditable.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from repro_torch.data.tasks import Task


def estimate_tokens(text: str) -> int:
    """Cheap prompt-length proxy (whitespace tokens, min 1)."""
    return max(1, len(text.split()))


@dataclass(frozen=True)
class MicroBatchPolicy:
    max_batch_size: int = 8
    max_batch_tokens: int = 4096
    max_wait_ticks: int = 16

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.max_batch_tokens < 1:
            raise ValueError("max_batch_tokens must be >= 1")


@dataclass
class Request:
    task: Task
    arrival_time: int
    request_id: str
    est_tokens: int
    admission_index: Optional[int] = None   # set when admitted
    batch_id: Optional[int] = None


@dataclass
class MicroBatch:
    batch_id: int
    requests: List[Request] = field(default_factory=list)
    formed_at: int = 0

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def total_tokens(self) -> int:
        return sum(r.est_tokens for r in self.requests)


class AdmissionQueue:
    """FIFO admission queue with deterministic micro-batch formation."""

    def __init__(self, policy: MicroBatchPolicy = MicroBatchPolicy()):
        self.policy = policy
        self._pending: Deque[Request] = deque()
        self._tick = 0
        self._last_arrival = -1
        self._admitted = 0
        self._batches_formed = 0

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def now(self) -> int:
        return self._tick

    def submit(self, task: Task,
               arrival_time: Optional[int] = None) -> Request:
        """Enqueue a task. ``arrival_time`` defaults to the next logical
        tick; explicit times must be monotone non-decreasing (FIFO)."""
        if arrival_time is None:
            arrival_time = self._tick
        # watermark check: the invariant must survive batch formation
        # draining the pending deque
        if arrival_time < self._last_arrival:
            raise ValueError(
                f"arrival_time {arrival_time} precedes the last "
                f"arrival ({self._last_arrival}); arrivals must be "
                "monotone")
        self._last_arrival = arrival_time
        self._tick = max(self._tick, arrival_time) + 1
        req = Request(task=task, arrival_time=arrival_time,
                      request_id=f"req-{arrival_time}-{task.task_id}",
                      est_tokens=estimate_tokens(task.text))
        self._pending.append(req)
        return req

    def ready(self, now: Optional[int] = None) -> bool:
        """Should a streaming loop close a micro-batch now? True when
        the requests that have *arrived by now* fill the size budget,
        or the oldest pending request has already waited
        ``max_wait_ticks`` — the standard fill-or-timeout
        continuous-batching trigger.

        Only arrived requests count toward the fill trigger: the
        pending deque may hold future arrivals (a stream is often
        submitted up front with explicit arrival ticks), and counting
        those fired ready() early — a burst whose last member lands
        exactly at the head's timeout instant (fill == timeout)
        admitted the head alone and the burst later, two batches where
        fill-or-timeout semantics demand one."""
        if not self._pending:
            return False
        if now is None:
            now = self._tick
        head = self._pending[0]
        if head.arrival_time > now:
            return False              # nothing has arrived yet
        arrived = 0
        for r in self._pending:
            if r.arrival_time > now:
                break
            arrived += 1
            if arrived >= self.policy.max_batch_size:
                return True
        return now - head.arrival_time >= self.policy.max_wait_ticks

    def peek(self) -> Optional[Request]:
        """Oldest pending request (not yet admitted), or None."""
        return self._pending[0] if self._pending else None

    def pop(self) -> Request:
        """Admit the single oldest pending request (FIFO). Admission
        indices are assigned from the same monotone counter
        ``form_batch`` uses, so row numbering is identical whether a
        stream is served wave-wise or one row at a time — the
        step-level loop's sampling key streams depend on that. A
        requeued request (see ``requeue``) keeps the index it already
        holds — the counter advanced at its first admission."""
        req = self._pending.popleft()
        if req.admission_index is None:
            req.admission_index = self._admitted
            self._admitted += 1
        return req

    def requeue(self, req: Request) -> None:
        """Return an admitted-but-unstarted request to the head of the
        queue (the step loop's admission-time ``PoolExhausted``
        rollback). The request keeps its already-assigned admission
        index, so its sampling key streams — and therefore its tokens
        — are unchanged when it re-admits."""
        self._pending.appendleft(req)

    @property
    def next_admission_index(self) -> int:
        """The admission index the next ``pop`` will return: a
        requeued head keeps the index it already holds, otherwise the
        monotone counter's next value. Crash recovery peeks this to
        restore already-retired rows without popping."""
        if self._pending and \
                self._pending[0].admission_index is not None:
            return self._pending[0].admission_index
        return self._admitted

    def form_batch(self, now: Optional[int] = None
                   ) -> Optional[MicroBatch]:
        """Admit the next micro-batch (FIFO) under the size/token
        budget; None when the queue is empty. A request is always
        admissible on its own even if it alone exceeds
        ``max_batch_tokens`` (oversized requests must not wedge the
        queue). Timing — *when* to close a batch — is ``ready``'s job;
        formation always packs up to the budget."""
        if not self._pending:
            return None
        if now is None:
            now = self._tick
        pol = self.policy
        batch = MicroBatch(batch_id=self._batches_formed, formed_at=now)
        tokens = 0
        while self._pending and len(batch) < pol.max_batch_size:
            head = self._pending[0]
            if head.arrival_time > now:
                break               # not yet arrived at this tick
            if batch.requests and \
                    tokens + head.est_tokens > pol.max_batch_tokens:
                break
            req = self.pop()
            req.batch_id = batch.batch_id
            tokens += req.est_tokens
            batch.requests.append(req)
        self._batches_formed += 1
        return batch

    def next_ready_at(self) -> Optional[int]:
        """Earliest tick at which ``ready`` will fire for the current
        pending set: when the size budget fills (the arrival of the
        batch-size-th pending request — the earliest tick at which
        ``max_batch_size`` requests have *arrived*, matching ready()'s
        arrived-only count) or when the oldest request's wait budget
        expires — whichever comes first.

        Boundary contract: an empty queue returns None (there is no
        meaningful instant after a drain — callers must not fast-
        forward a clock on it), an exactly-full queue returns
        ``min(fill, timeout)``, and when fill == timeout the two
        triggers coincide so the instant admits the whole burst as
        one batch (see ``ready``)."""
        if not self._pending:
            return None
        timeout = self._pending[0].arrival_time \
            + self.policy.max_wait_ticks
        if len(self._pending) >= self.policy.max_batch_size:
            fill = self._pending[
                self.policy.max_batch_size - 1].arrival_time
            return min(fill, timeout)
        return timeout

    def drain_batches(self) -> List[MicroBatch]:
        """Form micro-batches until the queue is empty, with
        ``ready()`` as the single admission trigger: the clock jumps
        to each batch's fill-or-timeout instant before it forms, so a
        drain is exactly the batch sequence a streaming loop ticking
        through the same arrivals would admit."""
        out = []
        now = self._tick
        while self._pending:
            # next_ready_at is never None here (pending is non-empty),
            # and the max() keeps the clock monotone when a batch was
            # already ready before the jump; at a fill == timeout
            # coincidence the instant admits the whole burst at once
            now = max(now, self.next_ready_at())
            assert self.ready(now)
            out.append(self.form_batch(now))
        return out
