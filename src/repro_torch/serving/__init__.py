from repro_torch.serving.compaction import (
    CompactionPlan, CompactionStats, MemberPlan, bucket_size,
    plan_compaction)
from repro_torch.serving.engine import (
    BatchedACAREngine, BatchResult, QueuedServeResult, ZooModel,
    intern_answers, judge_batch)
from repro_torch.serving.kv_pool import (
    KVStats, PageAccountingError, PagePool, PagePoolError, PagedKVServer,
    PoolExhausted, ProbeHandle, dense_tile_slots, pages_for)
from repro_torch.serving.metrics import PromCounters
from repro_torch.serving.queue import (
    AdmissionQueue, MicroBatch, MicroBatchPolicy, Request)
from repro_torch.serving.scheduler import StepPlanner
from repro_torch.serving.step_loop import (
    ShardedStepLoopRunner, StepLoopRunner, StepStats)

__all__ = [
    "AdmissionQueue", "BatchResult", "BatchedACAREngine", "CompactionPlan",
    "CompactionStats", "KVStats", "MemberPlan", "MicroBatch",
    "MicroBatchPolicy", "PageAccountingError", "PagePool",
    "PagePoolError", "PagedKVServer", "PoolExhausted", "ProbeHandle",
    "PromCounters", "QueuedServeResult", "Request",
    "ShardedStepLoopRunner", "StepLoopRunner", "StepPlanner", "StepStats",
    "ZooModel", "bucket_size", "dense_tile_slots", "intern_answers",
    "judge_batch", "pages_for", "plan_compaction",
]
