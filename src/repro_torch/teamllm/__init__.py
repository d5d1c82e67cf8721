from repro_torch.teamllm.artifacts import ArtifactStore, ChainCorruption
from repro_torch.teamllm.fingerprint import (
    EnvironmentFingerprint, capture_environment, render_prompt)
from repro_torch.teamllm.state_machine import (
    IllegalTransition, RunState, RunStateMachine)
from repro_torch.teamllm.trace import (
    ModelResponse, ProbeSample, TraceRecord, content_hash, stable_json)

__all__ = [
    "ArtifactStore", "ChainCorruption", "EnvironmentFingerprint",
    "IllegalTransition", "ModelResponse", "ProbeSample", "RunState",
    "RunStateMachine", "TraceRecord", "capture_environment",
    "content_hash", "render_prompt", "stable_json",
]
