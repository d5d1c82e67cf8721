from repro_torch.serving.compaction import bucket_size
from repro_torch.serving.engine import (
    BatchedACAREngine, QueuedServeResult, ZooModel, intern_answers,
    judge_batch)
from repro_torch.serving.kv_pool import (
    KVStats, PageAccountingError, PagePool, PagePoolError, PagedKVServer,
    PoolExhausted, pages_for)
from repro_torch.serving.metrics import PromCounters
from repro_torch.serving.queue import (
    AdmissionQueue, MicroBatch, MicroBatchPolicy, Request)
from repro_torch.serving.scheduler import StepPlanner
from repro_torch.serving.step_loop import (
    ShardedStepLoopRunner, StepLoopRunner, StepStats)

__all__ = [
    "AdmissionQueue", "BatchedACAREngine", "KVStats", "MicroBatch",
    "MicroBatchPolicy", "PageAccountingError", "PagePool",
    "PagePoolError", "PagedKVServer", "PoolExhausted", "PromCounters",
    "QueuedServeResult", "Request", "ShardedStepLoopRunner",
    "StepLoopRunner", "StepPlanner", "StepStats", "ZooModel",
    "bucket_size", "intern_answers", "judge_batch", "pages_for",
]
