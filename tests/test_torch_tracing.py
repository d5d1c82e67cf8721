"""The port's span tracing (``repro_torch.serving.tracing`` and the
engines' span sites) against the reference's on the CPU.

The tracer first: the same span calls make the same records, span ids,
parents and chain head in both packages, and a port span file verifies
in both. Then ``run_obs_equivalence``'s single-device legs at
``tests/test_faults.py``'s scale (``_torch_port.check_obs``): each
package's stepped engine traced, the port into a span file; the traced
run's records and heads equal the untraced run's; span records and span
heads equal the reference's; the file verifies; the lineage of every
task walks OK, as the reference's does; every full-arena row's
on-capacity ``attribution`` span equals the leave-one-out oracle, under
golds keyed to the members' answers so that some values are non-zero; a
traced crash at 3/4, recovered with a tracer, gives one ``restore`` span
per restored row and the reference's span head. Last, the wave's
post-hoc spans (``run_batch(tracer=...)``) over 8 tasks and
``serve(step_loop=True, trace_path=..., lineage_task=...)``'s report,
each against the reference's.
"""
import dataclasses

import pytest

from _torch_port import (
    check_obs, check_served_equal, forced_route, one_torch_thread,
    paged_fleets, stepped_pair, stream, torch_task)
from repro.serving.tracing import NullTracer as JNull
from repro.serving.tracing import SpanTracer as JTracer
from repro.teamllm.prov import verify_span_file as jverify
from repro_torch.serving.tracing import NullTracer, SpanTracer
from repro_torch.teamllm.prov import verify_span_file


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _drive(tracer):
    """A fixed span sequence over two traces: row streams, forked
    member and probe streams, an explicit parent, KV provenance."""
    a = tracer.span("admit", "a#0", 0, prompt_tokens=9, arrival=0)
    tracer.span("prefill_chunk", "a#0", 1, model="m0", start=0, tokens=7)
    tracer.kv_insert("m0", "h0", "a#0", "a#0/1")
    tracer.kv_insert("m0", "h0", "b#1", "b#1/0")
    tracer.span("probe_decode", "a#0", 2, key=("p", 0), ticks=4)
    tracer.span("member_launch", "a#0", 3, key=("m", 1), member=1)
    tracer.span("member_decode", "a#0", 4, key=("m", 1), done=1)
    tracer.span("admit", "b#1", 4, parent=a)
    src = tracer.kv_source("m0", "h0")
    tracer.span("kv_reuse", "b#1", 5, kind="prefix", source=src[0],
                source_span=src[1])
    tracer.span("attribution", "a#0", 6, values={"m1": 0.5, "m2": -1.0})
    tracer.span("retire", "a#0", 6, final_answer=None, aborted=None)
    return tracer


def test_span_tracer_matches_reference(tmp_path):
    jt, tt = _drive(JTracer()), _drive(SpanTracer(tmp_path / "spans.jsonl"))
    assert tt.records() == jt.records()
    assert tt.head == jt.head == jt.flush()
    assert tt.flush() == tt.head
    for verify in (verify_span_file, jverify):
        audit = verify(tmp_path / "spans.jsonl")
        assert audit["ok"] and audit["head"] == tt.head
        assert audit["records"] == len(tt.records())
    assert tt.attribution and tt.armed == jt.armed


def test_null_tracer_matches_reference():
    for t in (NullTracer(), JNull()):
        assert t.armed is False
        assert t.span("admit", "a#0", 0) is None
        assert t.kv_source("m", "h") is None
        assert t.records() == [] and t.flush() is None


# ----------------------------------------------------------------------
# the stepped engine traced
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleets():
    return paged_fleets()


def test_traced_stepped_engine_matches_reference(fleets, tmp_path):
    tasks = stream(8, seed=6)
    ref, port = stepped_pair(fleets, tasks)
    names = [m.name for m in fleets[0][1]]
    _, base = ref()
    got = check_obs(ref, port, tasks, base, names, tmp_path)
    assert got["restored"] > 0 and got["lineage"] > 0
    assert got["attribution_rows"] > 0 and got["attribution_nonzero"] > 0


def test_traced_faulted_run_matches_reference(fleets):
    """Fault spans (a launch retry, NaN quarantines, degraded routes)
    and a disarmed tracer: spans equal to the reference's, and a
    ``NullTracer`` serves like no tracer."""
    from _torch_port import degraded_plans
    tasks = stream(8, seed=2)
    ref, port = stepped_pair(fleets, tasks)
    names = [m.name for m in fleets[0][1]]
    jplan, tplan = degraded_plans(names)
    _, jres = ref(faults=jplan, tracer=JTracer())
    _, tres = port(faults=tplan, tracer=SpanTracer())
    check_served_equal("traced-degraded", tasks, jres, tres, names)
    phases = {s["phase"] for s in tres.spans}
    assert {"member_retry", "member_quarantined", "route_degraded"} <= \
        phases
    _, quiet = port(faults=tplan, tracer=NullTracer())
    assert quiet.spans is None and quiet.span_head is None
    check_served_equal("null-tracer", tasks, dataclasses.replace(
        tres, spans=None, span_head=None), quiet, names)


# ----------------------------------------------------------------------
# the wave's post-hoc spans and serve's report
# ----------------------------------------------------------------------
def test_run_batch_spans_match_reference(fleets):
    from repro.configs.acar import ACARConfig as JACARConfig
    from repro.serving import BatchedACAREngine as JEngine
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine

    (jprobe, jens), (tprobe, tens) = fleets
    tasks = stream(8, seed=7)
    knobs = dict(max_new_tokens=4, route_fn=forced_route(len(tasks) + 3))
    acfg = dict(probe_temperature=0.9, seed=0)
    rids = [f"req-{i}" for i in range(len(tasks))]
    jt, tt = JTracer(), SpanTracer()
    jres = JEngine(JACARConfig(**acfg), jprobe, jens, **knobs).run_batch(
        tasks, start_index=3, tracer=jt, request_ids=rids)
    tres = BatchedACAREngine(ACARConfig(**acfg), tprobe, tens,
                             device="cpu", **knobs).run_batch(
        [torch_task(t) for t in tasks], start_index=3, tracer=tt,
        request_ids=rids)
    assert tres.final_answers == jres.final_answers
    assert tres.member_answers == jres.member_answers
    assert tt.records() == jt.records()
    assert tt.head == jt.head
    phases = [s["phase"] for s in tt.records()]
    assert phases.count("retire") == len(tasks)
    assert "kv_reuse" in phases and "attribution" in phases
    # untraced (request ids default to the task's): no spans, same bits
    plain = BatchedACAREngine(ACARConfig(**acfg), tprobe, tens,
                              device="cpu", **knobs).run_batch(
        [torch_task(t) for t in tasks], start_index=3, tracer=NullTracer())
    assert plain.final_answers == tres.final_answers


def test_serve_trace_and_lineage_match_reference(fleets, tmp_path):
    from repro.configs.acar import ACARConfig as JACARConfig
    from repro.launch import serve as jserve
    from repro_torch.configs import ACARConfig
    from repro_torch.launch import serve as tserve

    (jprobe, jens), (tprobe, tens) = fleets
    tasks = stream(6, seed=8)
    acfg = dict(probe_temperature=0.9, seed=0)
    kw = dict(verbose=False, step_loop=True, batch_size=4,
              lineage_task=tasks[-1].task_id)
    want = jserve.serve(tasks, jprobe, jens, JACARConfig(**acfg),
                        trace_path=str(tmp_path / "ref.jsonl"), **kw)
    got = tserve.serve([torch_task(t) for t in tasks], tprobe, tens,
                       ACARConfig(**acfg), device="cpu",
                       trace_path=str(tmp_path / "port.jsonl"), **kw)
    for report in (want, got):
        del report["wall_ms"]
    assert got == want
    assert got["lineage_ok"] and got["lineage_verified"] > 0
    audit = verify_span_file(tmp_path / "port.jsonl")
    assert audit["ok"] and audit["head"] == got["span_head"]
