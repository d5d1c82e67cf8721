"""The heterogeneous fleet of the reference harness's
``run_hetero_equivalence`` (an int8-KV probe, a Mamba member on
recurrent-state lanes, a sliding-window member on ring pages, the
probe's int8 twin; ``tests/harness/simulate.py::hetero_zoo``), port
against reference on the CPU (ladder rung 4) at tier-1 scale: 8 long
prompts of 24 characters, forced routes over every mode, 6 new tokens,
micro-batches of 4, chunk 8. Each leg — the ``paged=False`` queued
baseline, the stepped loop with every page layout live in the same
ticks, and the int8-paged queued wave — is equal to the reference's
on sigma, mode, answers, member answers, probe texts, record hashes
and chain heads, and each paged leg to the port's own baseline. The
200-task legs are ``python tests/_torch_port.py hetero``."""
import pytest

from _torch_port import forced_route, hetero_legs, one_torch_thread

N_TASKS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    return hetero_legs(tmp_path_factory.mktemp("hetero"), n_tasks=N_TASKS,
                       batch_size=4, route_fn=forced_route(N_TASKS))


@pytest.mark.parametrize("leg", ["dense", "step", "wave-paged"])
def test_hetero_leg_matches_reference_and_dense_baseline(legs, leg):
    legs[leg]()
