from repro_torch.serving.compaction import (
    CompactionPlan, CompactionStats, MemberPlan, bucket_size,
    plan_compaction)
from repro_torch.serving.engine import (
    BatchedACAREngine, BatchResult, QueuedServeResult, ZooModel,
    intern_answers, judge_batch)
from repro_torch.serving.faults import (
    SITES, FaultInjector, FaultPlan, FaultSpec, SimulatedCrash)
from repro_torch.serving.journal import RecoveryState, StepJournal
from repro_torch.serving.kv_pool import (
    KVStats, PageAccountingError, PagePool, PagePoolError, PagedKVServer,
    PoolExhausted, ProbeHandle, dense_tile_slots, pages_for)
from repro_torch.serving.mesh import ServingMesh, ShardedPagedKVServer
from repro_torch.serving.metrics import PromCounters
from repro_torch.serving.queue import (
    AdmissionQueue, MicroBatch, MicroBatchPolicy, Request)
from repro_torch.serving.scheduler import (
    ContinuousBatchingScheduler, ProbeCache, SchedulerStats, StepPlanner)
from repro_torch.serving.step_loop import (
    ShardedStepLoopRunner, StepLoopRunner, StepStats)
from repro_torch.serving.torch_backend import TorchModelBackend
from repro_torch.serving.tracing import NullTracer, SpanTracer

__all__ = [
    "AdmissionQueue", "BatchResult", "BatchedACAREngine",
    "CompactionPlan", "CompactionStats", "ContinuousBatchingScheduler",
    "FaultInjector", "FaultPlan", "FaultSpec", "KVStats", "MemberPlan",
    "MicroBatch", "MicroBatchPolicy", "NullTracer", "PageAccountingError",
    "PagePool", "PagePoolError", "PagedKVServer", "PoolExhausted",
    "ProbeCache", "ProbeHandle", "PromCounters", "QueuedServeResult",
    "RecoveryState", "Request", "SITES", "SchedulerStats",
    "ServingMesh", "ShardedPagedKVServer", "ShardedStepLoopRunner", "SimulatedCrash", "SpanTracer",
    "StepJournal", "StepLoopRunner", "StepPlanner", "StepStats",
    "TorchModelBackend", "ZooModel", "bucket_size", "dense_tile_slots",
    "intern_answers", "judge_batch", "pages_for", "plan_compaction",
]
