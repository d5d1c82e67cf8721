from repro_torch.data.tasks import (
    BENCHMARKS, PAPER_MIX, Task, arithmetic_suite, paper_suite,
    split_by_benchmark)

__all__ = [
    "BENCHMARKS", "PAPER_MIX", "Task", "arithmetic_suite", "paper_suite",
    "split_by_benchmark",
]
