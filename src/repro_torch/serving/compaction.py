"""Power-of-two shape buckets for batched launches.

Only ``bucket_size`` of the reference's ``repro/serving/compaction.py``
is ported so far: the step loop pads every prefill and decode group to
a bucket, and the KV pool sizes its scratch region by it. The wave
engine's escalated-subset compaction plans join with that engine.
"""
from __future__ import annotations

from typing import Optional


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
