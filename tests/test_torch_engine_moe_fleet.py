"""Capacity MoE and MLA on the contiguous-cache member fallback at rung
4 of the ladder, at 16 tasks (the 200-task legs: ``python
tests/_torch_port.py moe``): the serve CLI's fleet with ``--ensemble
mixtral-8x22b deepseek-v2-236b`` behind the smollm-135m probe (reduced,
trained 10 arithmetic steps by the port's ``build_zoo`` so that the
members answer in digits; deepseek-v2 with MLA, a shared expert and a
dense layer 0) through ``run_stepped`` and ``run_queued``, forced
routes with half the rows full arena, the members sampled at 0.9.
Each leg: sigma, mode, final answers, member answers and probe texts
equal, record hashes and chain heads equal, and each member answers some
full-arena row."""
import pytest

from _torch_port import moe_fleet_legs, one_torch_thread

N_TASKS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def legs():
    return moe_fleet_legs(N_TASKS)


@pytest.mark.parametrize("leg", ["moe fleet step loop", "moe fleet queued"])
def test_moe_fleet_leg_matches_reference(legs, leg):
    legs[leg]()


def test_serve_cli_serves_the_moe_ensemble():
    """``launch.serve.main`` with ``--ensemble mixtral-8x22b
    deepseek-v2-236b`` builds the fleet through ``build_zoo`` (reduced,
    trained 2 steps) and serves 4 tasks through the step loop on the
    CPU, every task in the report."""
    from repro_torch.launch import serve as tserve
    report = tserve.main(["--ensemble", "mixtral-8x22b", "deepseek-v2-236b",
                          "--tasks", "4", "--train-steps", "2",
                          "--step-loop"], device="cpu")
    assert sum(report["mode_distribution"].values()) == 4
    assert report["batch_sizes"]
