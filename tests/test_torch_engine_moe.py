"""The gather MoE on pages at rung 4 of the ladder, at 16 tasks (the
200-task legs: ``python tests/_torch_port.py moe``): the single-device
leg of the reference harness's ``run_mesh2d_equivalence``
(``mesh2d_zoo``: the probe, a dense member, a gather-MoE member on dense
pages and the probe's twin) through both packages' ``run_stepped`` at
megastep 1 and "auto". Each leg: sigma, mode, final answers, member
answers and probe texts equal, record hashes and chain heads equal
(``_torch_port.check_served_equal``). The capacity-MoE and MLA fleet's
legs are ``tests/test_torch_engine_moe_fleet.py``."""
import pytest

from _torch_port import mesh2d_legs, one_torch_thread

N_TASKS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def legs():
    return mesh2d_legs(N_TASKS)


@pytest.mark.parametrize("leg", ["mesh2d megastep 1",
                                 "mesh2d megastep 'auto'"])
def test_moe_leg_matches_reference(legs, leg):
    legs[leg]()
