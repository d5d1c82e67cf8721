"""The serve CLI's default fleet — a smollm-135m probe with llama3-8b,
deepseek-7b and recurrentgemma-2b members, reduced, f32, trained 10
arithmetic steps so that their answers are digits and not "" — through
each engine ``serve`` drives, port against reference on the CPU (ladder
rung 4): 8 prompts of 75 digits (past the hybrid's 64-position ring
window), forced routes over every mode, members sampled at 0.9, 6 new
tokens, micro-batches of 4, chunk 8. The wave (recurrentgemma-2b over
contiguous ring and RG-LRU caches), ``run_queued`` and the step loop at
megastep 2 (recurrentgemma-2b on the contiguous-cache member fallback)
are each equal to the reference on sigma, mode, answers, member
answers, probe texts, record hashes and chain head, and the hybrid
member answers every full-arena row. ``test_torch_serve_fleet.py``
holds ``serve``'s reports over the same fleet; the 200-task legs are
``python tests/_torch_port.py hetero``."""
import pytest

from _torch_port import default_fleet_legs, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def legs():
    return default_fleet_legs(n_tasks=8, batch_size=4)


@pytest.mark.parametrize("leg", ["default wave", "default queued",
                                 "default step loop"])
def test_default_fleet_engine_matches_reference(legs, leg):
    legs[leg]()
