# ACAR: the paper's primary contribution — sigma-based adaptive
# complexity routing with auditable traces, plus the negative-result
# machinery (retrieval, attribution).
from repro_torch.core.backends import (
    GenResult, ModelBackend, ModelProfile, PAPER_MODELS,
    SyntheticBackend, paper_backends)
from repro_torch.core.extract import extract, extract_batch
from repro_torch.core.judge import arena_verify, judge_select
from repro_torch.core.orchestrator import (
    ACAROrchestrator, TaskOutcome, run_fixed_mode)
from repro_torch.core.retrieval import (
    Experience, ExperienceStore, embed_text)
from repro_torch.core.routing import (
    ARENA_LITE, FULL_ARENA, MODES, SINGLE_AGENT, RoutingDecision,
    decide, degrade_mode, execution_mode, majority_vote, models_for_mode)
from repro_torch.core.sigma import (
    MODE_NAMES, majority_vote_batch, route_batch, sigma, sigma_batch)

__all__ = [
    "ACAROrchestrator", "ARENA_LITE", "Experience", "ExperienceStore",
    "FULL_ARENA", "GenResult", "MODES", "MODE_NAMES", "ModelBackend",
    "ModelProfile", "PAPER_MODELS", "RoutingDecision", "SINGLE_AGENT",
    "SyntheticBackend", "TaskOutcome", "arena_verify", "decide",
    "degrade_mode", "embed_text", "execution_mode", "extract",
    "extract_batch", "judge_select", "majority_vote",
    "majority_vote_batch", "models_for_mode", "paper_backends",
    "route_batch", "run_fixed_mode", "sigma", "sigma_batch",
]
