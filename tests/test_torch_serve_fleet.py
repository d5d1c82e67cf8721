"""The serve CLI's default fleet — a smollm-135m probe with llama3-8b,
deepseek-7b and recurrentgemma-2b members (``DEFAULT_PROBE``,
``DEFAULT_ENSEMBLE``), reduced, f32, trained 10 arithmetic steps by
the port's ``build_zoo`` and carried to the reference's tree
(``_torch_port.default_fleets``) — through the port's ``serve`` against
the reference's
on the CPU: 8 arithmetic tasks with the default sigma routing on the
wave (``run_batch``: the dense members from pool pages, the hybrid over
contiguous ring and RG-LRU caches), through the admission queue
(``scheduler=True``) and on the step loop at megastep 2 (the hybrid on
the contiguous-cache member fallback). Accuracy, mode distribution,
calls saved, mean sigma, the compaction savings and the micro-batch
sizes are equal. ``main`` (the CLI) runs on the CPU for the default
and the heterogeneous fleets."""
import pytest

from _torch_port import default_fleets, one_torch_thread, serve_reports
from repro.data.tasks import arithmetic_suite
from repro_torch.launch import serve as tserve


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def fleets():
    return default_fleets()


@pytest.mark.parametrize("kw", [
    {}, {"scheduler": True, "batch_size": 4},
    {"step_loop": True, "batch_size": 4, "megastep": 2}],
    ids=["wave", "scheduler", "step_loop"])
def test_default_fleet_serve_report_matches_reference(fleets, kw):
    got, want = serve_reports(fleets, arithmetic_suite(8, seed=99), **kw)
    assert got == want
    assert sum(got["mode_distribution"].values()) == 8
    assert ("batch_sizes" in got) == bool(kw)


@pytest.mark.parametrize("argv", [
    [], ["--hetero-fleet", "--step-loop", "--megastep", "2"]],
    ids=["default", "hetero"])
def test_main_serves_on_the_cpu(argv, capsys):
    report = tserve.main(["--tasks", "4", "--train-steps", "1"] + argv,
                         device="cpu")
    assert sum(report["mode_distribution"].values()) == 4
    assert 0.0 <= report["accuracy"] <= 1.0
    out = capsys.readouterr().out
    probe, ensemble = ((tserve.HETERO_PROBE, tserve.HETERO_ENSEMBLE)
                       if argv else
                       (tserve.DEFAULT_PROBE, tserve.DEFAULT_ENSEMBLE))
    assert f"fleet layouts     : {probe}=" in out
    for spec in ensemble:
        assert f"{spec}=" in out
    assert "served 4 tasks" in out


def test_cli_fleets_match_reference():
    from repro.launch import serve as jserve
    assert tserve.DEFAULT_PROBE == jserve.DEFAULT_PROBE
    assert tserve.DEFAULT_ENSEMBLE == jserve.DEFAULT_ENSEMBLE
    assert tserve.HETERO_PROBE == jserve.HETERO_PROBE
    assert tserve.HETERO_ENSEMBLE == jserve.HETERO_ENSEMBLE
