"""The port's wave engine (``BatchedACAREngine.run_batch``) against the
reference's, end to end on the CPU, over the ``paged_zoo`` fleet (three
dense members, the third the probe's own params): once from pool pages
(``paged=None``, the default) and once over contiguous caches
(``paged=False``, the reference's A/B baseline and pool-exhaustion
fallback). ``test_torch_wave_engine_quant.py`` serves the int8-KV
fleet.

Both engines serve the same 16-task long-prompt stream (21-token
prompts, off the page grid, with duplicates) as two waves of 8 on one
engine, with forced routes keyed by admission index so every mode and
every member path runs. Sigma, modes, final answers, member answers
and probe texts must agree with zero mismatches, and the compaction
and paged-KV accounting must be equal.
"""
import pytest

from _torch_port import check_run_batch_against_reference, engine_fleets


@pytest.fixture(scope="module")
def fleets():
    return engine_fleets(prompt_chars=21)


@pytest.mark.parametrize("paged", [None, False], ids=["paged", "dense"])
def test_run_batch_matches_reference(fleets, paged):
    check_run_batch_against_reference(fleets, paged)


@pytest.mark.parametrize("paged", [None, False], ids=["paged", "dense"])
def test_run_batch_sampled_members_match_reference(fleets, paged):
    """Members sampled at temperature 0.7: no member is compactable, so
    every member decodes the whole wave (masked) and the twin does not
    seed its decode from the probe's pages."""
    check_run_batch_against_reference(fleets, paged,
                                      ensemble_temperature=0.7)
