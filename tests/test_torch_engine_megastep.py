"""The port's stepped ACAR engine against the reference's at megastep
4: four decode ticks per launch on both sides, with the same stream,
fleet and knobs as ``test_torch_engine.py`` (kept in its own file so
the reference's compiles of both megastep widths do not share one
worker's time budget)."""
import pytest

from _torch_port import check_run_stepped_against_reference, engine_fleets


@pytest.fixture(scope="module")
def fleets():
    return engine_fleets()


def test_run_stepped_megastep_matches_reference(fleets):
    check_run_stepped_against_reference(fleets, megastep=4)
