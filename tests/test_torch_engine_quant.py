"""The port's stepped engine (``run_stepped``) against the reference's
on the int8-KV fleet (probe and twin on int8 pages, prefilled one-shot,
the 21-token prompts' tail page COW-forked per lane;
two dense members prefilled in chunks), at megastep 1 and 4, with the
stream and checks of ``test_torch_engine.py``."""
import pytest

from _torch_port import check_run_stepped_against_reference, quant_fleets


@pytest.fixture(scope="module")
def fleets():
    return quant_fleets(prompt_chars=21)


@pytest.mark.parametrize("megastep", [1, 4])
def test_run_stepped_matches_reference_int8_kv(fleets, megastep):
    check_run_stepped_against_reference(fleets, megastep=megastep)
