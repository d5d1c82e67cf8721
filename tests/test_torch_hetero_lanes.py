"""Recovery and the all-recurrent probe over the heterogeneous fleets of
the reference harness's ``run_hetero_equivalence``, port against
reference on the CPU (ladder rung 4) at tier-1 scale (8 long prompts,
forced routes, 6 new tokens, micro-batches of 4, chunk 8): the
journaled stepped run of ``hetero_zoo`` killed at 3/4 of its ticks and
recovered (ring pages and lanes rebuilt from the journal like dense
pages), and ``mamba_probe_zoo``'s stepped run, whose probe prefills,
forks its N samples and retires on recurrent-state lanes. Each equals
the reference's, and the port's own ``paged=False`` baseline."""
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


@pytest.mark.parametrize("leg", ["recovered", "mamba-step"])
def test_hetero_leg_matches_reference_and_dense_baseline(legs, leg):
    legs[leg]()
