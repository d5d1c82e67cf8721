# ACAR's routing core: sigma-based adaptive complexity routing. The
# orchestrator, backends, retrieval and attribution of the reference
# join as their serving paths are ported.
from repro_torch.core.extract import extract, extract_batch
from repro_torch.core.routing import (
    ARENA_LITE, FULL_ARENA, MODES, SINGLE_AGENT, RoutingDecision,
    decide, degrade_mode, execution_mode, majority_vote, models_for_mode)
from repro_torch.core.sigma import (
    MODE_NAMES, majority_vote_batch, route_batch, sigma, sigma_batch)

__all__ = [
    "ARENA_LITE", "FULL_ARENA", "MODES", "MODE_NAMES", "RoutingDecision",
    "SINGLE_AGENT", "decide", "degrade_mode", "execution_mode",
    "extract", "extract_batch", "majority_vote", "majority_vote_batch",
    "models_for_mode", "route_batch", "sigma", "sigma_batch",
]
