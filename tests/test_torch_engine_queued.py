"""The port's queued wave engine (``BatchedACAREngine.run_queued``)
against the reference's on the CPU.

Over ``engine_fleets`` (the reduced f32 ``paged_zoo``: three members,
the third the probe's own params; 16 long-prompt tasks with duplicates,
micro-batches of 8, routes forced by admission index so every mode and
member path runs), each package's ``run_queued`` serves the stream with
the same knobs: from pool pages (``paged=None``), over contiguous
caches (``paged=False``) and as the masked baseline (``compact=False,
shared_prefix=False``). Sigma, modes, answers, member answers, probe
texts, record hashes and chain heads, micro-batch sizes, the merged
``CompactionStats``, paged-KV accounting and the rendered metrics must
be equal (``_torch_port.check_queued_equal``).

Then the claims the reference's harness makes of its own queued engine,
held within the port (each run also against the reference's with the
same knobs): compacted equals masked
(``run_engine_compaction_equivalence``'s fleet and stream), and queued
equals stepped (``run_step_loop_equivalence``'s). Last, a traced
``run_queued``: spans and span head equal to the reference's, the span
file verified, lineage of every task, attribution equal to
leave-one-out (``run_obs_equivalence``'s wave leg).
"""
import pytest

from _torch_port import (
    check_compaction_equivalence, check_queued_against_stepped,
    check_queued_obs, check_run_queued_against_reference, engine_fleets,
    forced_route, one_torch_thread, stream)
from repro.data.tasks import arithmetic_suite

KNOBS = {
    "paged": dict(),
    "dense": dict(paged=False),
    "masked": dict(compact=False, shared_prefix=False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def fleets():
    return engine_fleets()


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_run_queued_matches_reference(fleets, knobs):
    jfleet, tfleet, tasks = fleets
    _, res = check_run_queued_against_reference(
        (jfleet, tfleet), tasks, KNOBS[knobs],
        route_fn=forced_route(len(tasks)))
    assert res.batch_sizes == [8, 8]
    assert set(res.modes.tolist()) == {0, 1, 2}
    cs = res.compaction
    if knobs == "masked":
        # every member decodes the whole wave; each prompt prefills N
        # times
        assert cs.ensemble_decode_token_reduction == 1.0
        assert cs.probe_prefill_reduction == 1.0
        assert cs.probe_prefill_tokens_saved == 0
    else:
        assert cs.ensemble_decode_token_reduction > 1.0
        assert cs.probe_prefill_reduction > 1.0
    if knobs == "dense":
        assert res.kv is None
    else:
        assert res.kv["m1"].pages_highwater > 0


def test_compacted_equals_masked():
    """The reference harness's compaction leg, at its knobs (four
    ``tiny_zoo`` models, 4 new tokens), with forced routes over one
    micro-batch of 8: sigma sends nearly every task of this random zoo
    to the full arena, where compaction has no row to skip (the
    200-task script leg serves both routings)."""
    got = check_compaction_equivalence(
        arithmetic_suite(8, seed=0), batch_size=8, route_fn=forced_route(8))
    assert got["decode_token_reduction"] > 1.0
    assert got["prefill_reduction"] == pytest.approx(3.0)


def test_run_queued_equals_run_stepped(fleets):
    """``run_step_loop_equivalence``'s knobs: 6 new tokens, prefill
    chunks of 8 over 24-character prompts, micro-batches of 8."""
    jfleet, tfleet, tasks = fleets
    check_queued_against_stepped((jfleet, tfleet), tasks, chunk_tokens=8,
                                 route_fn=forced_route(len(tasks)))


def test_traced_run_queued_matches_reference(fleets, tmp_path):
    jfleet, tfleet, _ = fleets
    got = check_queued_obs((jfleet, tfleet), stream(12, seed=6), tmp_path,
                           max_new_tokens=4, batch_size=4)
    assert got["lineage"] > 0 and got["spans"] > 0
    assert got["attribution_rows"] > 0 and got["attribution_nonzero"] > 0
