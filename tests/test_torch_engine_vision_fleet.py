"""The vision family on the contiguous-cache member fallback at rung 4
of the ladder, at 16 tasks (the 200-task legs: ``python
tests/_torch_port.py vision``): the serve CLI's fleet with
``--ensemble llava-next-mistral-7b llama3-8b`` behind the smollm-135m
probe (reduced, trained 10 arithmetic steps by the port's
``build_zoo``, llava on its synthetic patches, so that the members
answer in digits) through ``run_stepped`` (llava on the member fallback
over a contiguous ring cache, llama3-8b on dense pages) and
``run_queued``, forced routes with half the rows full arena, the
members sampled at 0.9. Llava is served text only, as the reference's
engine serves it. Each leg: sigma, mode, final answers, member answers
and probe texts equal, record hashes and chain heads equal, and each
member answers some full-arena row. And the serve CLI with a one-member
vision ensemble."""
import pytest

from _torch_port import one_torch_thread, vision_fleet_legs

N_TASKS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def legs():
    return vision_fleet_legs(N_TASKS)


@pytest.mark.parametrize("leg", ["vision fleet step loop",
                                 "vision fleet queued"])
def test_vision_fleet_leg_matches_reference(legs, leg):
    legs[leg]()


def test_serve_cli_serves_a_vision_member():
    """``launch.serve.main`` with ``--ensemble llava-next-mistral-7b``
    builds the fleet through ``build_zoo`` (reduced, trained 2 steps on
    synthetic patches) and serves 4 tasks through the step loop on the
    CPU, every task in the report."""
    from repro_torch.launch import serve as tserve
    report = tserve.main(["--ensemble", "llava-next-mistral-7b",
                          "--tasks", "4", "--train-steps", "2",
                          "--step-loop"], device="cpu")
    assert sum(report["mode_distribution"].values()) == 4
    assert report["batch_sizes"]
