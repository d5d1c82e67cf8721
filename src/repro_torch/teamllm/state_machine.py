"""Forward-only run state machine (paper §3.1 invariant 3).

PENDING -> EXECUTING -> VERIFYING -> COMPLETED, plus a terminal FAILED
reachable from any non-terminal state. No rollback transitions exist;
attempting one raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Tuple


class RunState(str, Enum):
    PENDING = "PENDING"
    EXECUTING = "EXECUTING"
    VERIFYING = "VERIFYING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"


_ORDER = [RunState.PENDING, RunState.EXECUTING, RunState.VERIFYING,
          RunState.COMPLETED]

_ALLOWED = {
    RunState.PENDING: {RunState.EXECUTING, RunState.FAILED},
    RunState.EXECUTING: {RunState.VERIFYING, RunState.FAILED},
    RunState.VERIFYING: {RunState.COMPLETED, RunState.FAILED},
    RunState.COMPLETED: set(),
    RunState.FAILED: set(),
}


class IllegalTransition(RuntimeError):
    pass


@dataclass
class RunStateMachine:
    run_id: str
    state: RunState = RunState.PENDING
    history: List[Tuple[str, str]] = field(default_factory=list)

    def advance(self, to: RunState) -> None:
        if to not in _ALLOWED[self.state]:
            raise IllegalTransition(
                f"run {self.run_id}: {self.state.value} -> {to.value} "
                "is not a forward transition")
        self.history.append((self.state.value, to.value))
        self.state = to

    @property
    def terminal(self) -> bool:
        return self.state in (RunState.COMPLETED, RunState.FAILED)
