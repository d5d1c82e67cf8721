"""The port's wave engine against the reference's on the int8-KV fleet:
the probe and its twin keep their KV as int8 codes with f32 scales
(int8 pool pages by default, an int8 contiguous cache with
``paged=False``), the two other members stay dense. Same stream, knobs
and checks as ``test_torch_wave_engine.py``."""
import pytest

from _torch_port import check_run_batch_against_reference, quant_fleets


@pytest.fixture(scope="module")
def fleets():
    return quant_fleets(prompt_chars=21)


@pytest.mark.parametrize("paged", [None, False], ids=["paged", "dense"])
def test_run_batch_matches_reference_int8_kv(fleets, paged):
    check_run_batch_against_reference(fleets, paged)
