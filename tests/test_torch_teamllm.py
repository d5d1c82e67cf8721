"""The port's TEAMLLM substrate (``repro_torch.teamllm``) held against
the reference's (``repro.teamllm``): content and record hashes, the
hash-chained artifact file byte for byte, each package reading and
extending the other's chain, torn-tail recovery and tamper detection,
the forward-only run state machine, span logs, and PROV lineage over a
span file that the reference's ``SpanTracer`` wrote while its engine
served a stream."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                          # seeded fallback shim
    from _propshim import given, settings
    from _propshim import strategies as st

import repro.teamllm.artifacts as j_art
import repro.teamllm.prov as j_prov
import repro.teamllm.spans as j_spans
import repro.teamllm.state_machine as j_sm
import repro.teamllm.trace as j_trace
import repro_torch.teamllm.artifacts as t_art
import repro_torch.teamllm.prov as t_prov
import repro_torch.teamllm.spans as t_spans
import repro_torch.teamllm.state_machine as t_sm
import repro_torch.teamllm.trace as t_trace

ROOT = Path(__file__).resolve().parent.parent
MODES = ("single_agent", "arena_lite", "full_arena")


# ----------------------------------------------------------------------
# records: the same plain fields built into each package's TraceRecord
# ----------------------------------------------------------------------
def record_fields(rng: np.random.Generator, i: int) -> dict:
    """One record's fields from a numpy stream: floats of every kind a
    record hashes (sigma, costs, scores, a retrieval similarity), the
    optional fields set and unset, and the non-hashed side channel."""
    probes = [dict(response=f"sample {int(rng.integers(1000))}",
                   answer=str(int(rng.integers(10))),
                   cost=float(rng.random() * 1e-3))
              for _ in range(int(rng.integers(0, 4)))]
    resps = [dict(model=f"m{k}", response=f"answer: {int(rng.integers(9))}",
                  answer=str(int(rng.integers(9))),
                  cost=float(rng.random() * 1e-2),
                  score=float(rng.standard_normal()))
             for k in range(int(rng.integers(0, 4)))]
    retrieval = None
    if rng.random() < 0.5:
        retrieval = {"hit": True, "similarity": float(rng.random()),
                     "exemplar_benchmark": "matharena"}
    schedule = None
    if rng.random() < 0.5:
        schedule = {"arrival": int(rng.integers(100)),
                    "batch_id": int(rng.integers(10)), "cache_hit": False}
    return dict(
        run_id="run", task_id=f"t{i:03d}", benchmark="supergpqa",
        prompt_hash=f"{int(rng.integers(1 << 62)):016x}",
        seed=int(rng.integers(1 << 31)),
        sigma=float(rng.choice([0.0, 0.5, 1.0, -1.0])),
        mode=MODES[int(rng.integers(3))], probe_samples=probes,
        responses=resps, final_answer=str(int(rng.integers(10))),
        correct=(None, True, False)[int(rng.integers(3))],
        cost=float(rng.random() * 3e-2), retrieval=retrieval,
        logical_time=i, wall_time=float(rng.random() * 1e9),
        schedule=schedule)


def build(trace_mod, fields: dict):
    return trace_mod.TraceRecord(**{
        **fields,
        "probe_samples": tuple(trace_mod.ProbeSample(**p)
                               for p in fields["probe_samples"]),
        "responses": tuple(trace_mod.ModelResponse(**r)
                           for r in fields["responses"])})


def pair(fields: dict):
    return build(j_trace, fields), build(t_trace, fields)


def assert_same_record(jr, tr) -> None:
    # the hashed view first, so a mismatch names its field
    assert tr.hashed_view() == jr.hashed_view()
    assert tr.to_dict() == jr.to_dict()
    assert t_trace.stable_json(tr.hashed_view()) == \
        j_trace.stable_json(jr.hashed_view())
    assert tr.record_hash() == jr.record_hash()


@pytest.mark.parametrize("seed", range(4))
def test_record_hash_equal_on_seeded_records(seed):
    rng = np.random.default_rng(seed)
    for i in range(25):
        jr, tr = pair(record_fields(rng, i))
        assert_same_record(jr, tr)
        # wall time and scheduling provenance stay outside the hash
        moved = dataclasses.replace(tr, wall_time=tr.wall_time + 1.0,
                                    schedule={"batch_id": -1})
        assert moved.record_hash() == jr.record_hash()


_TEXT = st.lists(st.sampled_from("ab09 -+=.:é\"\\\n"), max_size=12)


@settings(max_examples=60, deadline=None)
@given(_TEXT, st.integers(0, 3), st.lists(st.integers(-10**9, 10**9),
                                          max_size=6),
       st.sampled_from((None, True, False)), st.integers(0, 1 << 40))
def test_record_hash_equal_on_drawn_records(text, sig, nums, correct,
                                            bits):
    text = "".join(text)
    probes = [dict(response=f"{text}{n}", answer=str(n),
                   cost=n / 7.0) for n in nums[:3]]
    resps = [dict(model=f"m{k}", response=text, answer=str(n),
                  cost=abs(n) * 1e-12, score=n / 3.0)
             for k, n in enumerate(nums[3:])]
    fields = dict(
        run_id=text, task_id=f"task-{bits}", benchmark=text,
        prompt_hash=f"{bits:016x}", seed=bits % (1 << 31),
        sigma=(0.0, 0.5, 1.0, -1.0)[sig], mode=MODES[sig % 3],
        probe_samples=probes, responses=resps, final_answer=text,
        correct=correct, cost=bits * 1e-15,
        retrieval={"similarity": bits / (1 << 40), "hit": bool(bits & 1)},
        logical_time=bits % 1000, wall_time=float(bits), schedule=None)
    assert_same_record(*pair(fields))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from("kxyé"), st.integers(-99, 99)),
                max_size=8),
       st.integers(0, 1 << 30))
def test_content_hash_and_fault_record_equal_on_drawn_values(items, n):
    obj = {k * (abs(v) % 3 + 1): [v, v / 9.0, str(v), None, v > 0]
           for k, v in items}
    obj["nested"] = {"n": n, "f": n / 3.0, "l": list(range(n % 5))}
    assert t_trace.stable_json(obj) == j_trace.stable_json(obj)
    assert t_trace.content_hash(obj) == j_trace.content_hash(obj)
    kw = {"model": f"m{n % 3}", "count": n % 4 or None, "shard": n % 2}
    assert t_trace.fault_record("retry", n, **kw) == \
        j_trace.fault_record("retry", n, **kw)


# ----------------------------------------------------------------------
# artifact stores: byte-identical files, cross-package chains
# ----------------------------------------------------------------------
def _records(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [record_fields(rng, i) for i in range(n)]


def _append_all(art, trace_mod, path, fields_list, wall, as_dict):
    store = art.ArtifactStore(path)
    heads = []
    for i, f in enumerate(fields_list):
        rec = build(trace_mod, f)
        if as_dict:
            rec = {**rec.hashed_view(), "schedule": rec.schedule}
        heads.append(store.append(rec, wall_time=None if wall is None
                                  else wall + i))
    return store, heads


@pytest.mark.parametrize("as_dict", [False, True], ids=["trace", "dict"])
def test_same_appends_give_byte_identical_files(tmp_path, as_dict):
    recs = _records(30)
    js, jh = _append_all(j_art, j_trace, tmp_path / "j.jsonl", recs,
                         1.7e9, as_dict)
    ts, th = _append_all(t_art, t_trace, tmp_path / "t.jsonl", recs,
                         1.7e9, as_dict)
    assert th == jh
    assert ts.head == js.head != t_art.GENESIS == j_art.GENESIS
    assert len(ts) == len(js) == 30
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    assert ts.audit()["ok"] and js.audit()["ok"]
    assert ts.read_all() == js.read_all()


def test_stamped_wall_times_leave_the_chain_equal(tmp_path):
    """Without a wall time the stores stamp ``time.time()``, so the
    files differ in that field alone: every line's record, record hash
    and chain hash agree."""
    recs = [dict(f, wall_time=0.0) for f in _records(12, seed=3)]
    _append_all(j_art, j_trace, tmp_path / "j.jsonl", recs, None, False)
    _append_all(t_art, t_trace, tmp_path / "t.jsonl", recs, None, False)
    jl = (tmp_path / "j.jsonl").read_text().splitlines()
    tl = (tmp_path / "t.jsonl").read_text().splitlines()
    assert len(jl) == len(tl) == 12
    for a, b in zip(jl, tl):
        ja, tb = json.loads(a), json.loads(b)
        for k in ("record", "record_hash", "chain_hash"):
            assert tb[k] == ja[k], k
        assert tb["wall_time"] > 0 and ja["wall_time"] > 0


@pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                           ("ref", "port")])
def test_chain_audits_under_the_other_package(tmp_path, writer, reader):
    pk = {"ref": (j_art, j_trace), "port": (t_art, t_trace)}
    recs = _records(20, seed=1)
    path = tmp_path / "runs.jsonl"
    w, _ = _append_all(*pk[writer], path, recs[:12], 5.0, False)
    r = pk[reader][0].ArtifactStore(path)
    audit = r.audit()
    assert audit["ok"] and audit["records"] == 12
    assert audit["head"] == w.head == r.head
    assert r.read_all() == w.read_all()
    # the reader extends the writer's chain; the writer reopens it
    for i, f in enumerate(recs[12:]):
        r.append(build(pk[reader][1], f), wall_time=100.0 + i)
    again = pk[writer][0].ArtifactStore(path)
    assert again.audit()["ok"] and len(again) == 20
    assert again.head == r.head


def _two_stores(tmp_path, n=6):
    recs = _records(n, seed=2)
    _append_all(j_art, j_trace, tmp_path / "j.jsonl", recs, 9.0, False)
    _append_all(t_art, t_trace, tmp_path / "t.jsonl", recs, 9.0, False)
    return tmp_path / "j.jsonl", tmp_path / "t.jsonl"


@pytest.mark.parametrize("cut", [1, 17, -2])
def test_torn_tail_recovers_the_same(tmp_path, cut):
    jp, tp = _two_stores(tmp_path)
    whole = jp.read_bytes()
    torn_line = json.dumps({"record": {"task_id": "torn"}}) + "\n"
    torn = whole + torn_line.encode()[:cut]
    jp.write_bytes(torn)
    tp.write_bytes(torn)
    js, ts = j_art.ArtifactStore(jp), t_art.ArtifactStore(tp)
    assert js.torn_recovered and ts.torn_recovered
    assert jp.read_bytes() == tp.read_bytes() == whole
    assert len(ts) == len(js) == 6 and ts.head == js.head
    # an intact file is left alone by both
    assert not j_art.ArtifactStore(jp).torn_recovered
    assert not t_art.ArtifactStore(tp).torn_recovered


@pytest.mark.parametrize("field", ["record", "record_hash", "chain_hash"])
def test_tampered_line_raises_the_same(tmp_path, field):
    jp, tp = _two_stores(tmp_path)
    lines = jp.read_text().splitlines()
    row = json.loads(lines[3])
    if field == "record":
        row["record"]["final_answer"] += "x"
    else:
        row[field] = "f" * 64
    lines[3] = j_trace.stable_json(row)
    text = "\n".join(lines) + "\n"
    jp.write_text(text)
    tp.write_text(text)
    with pytest.raises(j_art.ChainCorruption) as je:
        j_art.ArtifactStore(jp)
    with pytest.raises(t_art.ChainCorruption) as te:
        t_art.ArtifactStore(tp)
    assert str(te.value).replace(str(tp), "P") == \
        str(je.value).replace(str(jp), "P")
    assert ":4:" in str(te.value)


# ----------------------------------------------------------------------
# the forward-only run state machine
# ----------------------------------------------------------------------
def _walk(sm_mod, path):
    sm = sm_mod.RunStateMachine("run/t0")
    seen = []
    for name in path:
        try:
            sm.advance(sm_mod.RunState[name])
            seen.append(("ok", name))
        except sm_mod.IllegalTransition as e:
            seen.append(("illegal", str(e)))
    return seen, sm.history, sm.state.value, sm.terminal


@pytest.mark.parametrize("start", [s.name for s in j_sm.RunState])
def test_state_machine_transitions_equal(start):
    names = [s.name for s in j_sm.RunState]
    prefix = {"PENDING": [], "EXECUTING": ["EXECUTING"],
              "VERIFYING": ["EXECUTING", "VERIFYING"],
              "COMPLETED": ["EXECUTING", "VERIFYING", "COMPLETED"],
              "FAILED": ["FAILED"]}[start]
    for to in names:
        assert _walk(t_sm, prefix + [to]) == _walk(j_sm, prefix + [to])


@settings(max_examples=80, deadline=None)
@given(st.lists(st.sampled_from([s.name for s in j_sm.RunState]),
                max_size=7))
def test_state_machine_walks_equal(path):
    assert _walk(t_sm, path) == _walk(j_sm, path)


# ----------------------------------------------------------------------
# spans and PROV lineage
# ----------------------------------------------------------------------
def test_spanlog_flush_bytes_and_heads_equal(tmp_path):
    rng = np.random.default_rng(7)
    jl, tl = j_spans.SpanLog(), t_spans.SpanLog()
    for k in range(40):
        trace = t_spans.make_trace_id(f"req-{k % 5}", k)
        assert trace == j_spans.make_trace_id(f"req-{k % 5}", k)
        fields = dict(model=f"m{k % 3}", sigma=float(rng.random()),
                      members=[0, 1][: k % 3], done=None)
        jrec = j_spans.span_record("route", trace, f"{trace}/{k}", k,
                                   parent=None if k % 2 else "p",
                                   **fields)
        trec = t_spans.span_record("route", trace, f"{trace}/{k}", k,
                                   parent=None if k % 2 else "p",
                                   **fields)
        assert trec == jrec
        assert tl.append(trec, wall_time=k * 0.5) == \
            jl.append(jrec, wall_time=k * 0.5)
    assert jl.flush(tmp_path / "j.jsonl") == tl.flush(tmp_path / "t.jsonl")
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    assert t_art.ArtifactStore(tmp_path / "j.jsonl").head == tl.head
    assert tl.records() == jl.records() and len(tl) == len(jl) == 40


@pytest.fixture(scope="module")
def reference_span_file(tmp_path_factory):
    """A span file the reference's ``SpanTracer`` wrote while its
    stepped engine served 8 long-prompt tasks over ``paged_zoo`` with
    routes forced through every mode (so member launches, judges,
    prefix-cache reuse and leave-one-out attribution spans occur)."""
    from _torch_port import forced_route
    from harness.simulate import long_prompt_workload, paged_zoo
    from repro.configs.acar import ACARConfig
    from repro.serving import BatchedACAREngine, MicroBatchPolicy
    from repro.serving.tracing import SpanTracer

    probe, ensemble = paged_zoo(seed=0)
    tasks = long_prompt_workload(8, prompt_chars=24, seed=0)
    path = tmp_path_factory.mktemp("spans") / "spans.jsonl"
    tracer = SpanTracer(path)
    eng = BatchedACAREngine(ACARConfig(probe_temperature=0.9, seed=0),
                            probe, ensemble, max_new_tokens=4,
                            route_fn=forced_route(len(tasks)))
    eng.run_stepped(tasks, MicroBatchPolicy(max_batch_size=8,
                                            max_batch_tokens=1 << 20),
                    chunk_tokens=8, tracer=tracer)
    tracer.flush()
    spans = [json.loads(l)["record"]
             for l in path.read_text().splitlines()]
    phases = {s["phase"] for s in spans}
    assert {"route", "member_launch", "judge", "retire"} <= phases
    return path, spans, sorted({t.task_id for t in tasks})


def test_prov_records_equal_on_a_reference_span_file(reference_span_file):
    _, spans, _ = reference_span_file
    recs = t_prov.prov_records(spans)
    assert recs == j_prov.prov_records(spans)
    kinds = {r["kind"] for r in recs}
    assert {"entity", "activity", "agent", "wasGeneratedBy", "used",
            "wasDerivedFrom", "wasAttributedTo"} <= kinds


def test_lineage_equal_on_a_reference_span_file(reference_span_file):
    _, spans, task_ids = reference_span_file
    recs = j_prov.prov_records(spans)
    for tid in task_ids + ["no-such-task"]:
        got = t_prov.lineage(spans, tid)
        assert got == j_prov.lineage(spans, tid)
        assert got["ok"] == (tid != "no-such-task")
        assert t_prov.lineage(spans, tid, records=recs) == \
            j_prov.lineage(spans, tid, records=recs)
    # a span changed after the graph was built fails both walks alike
    # wherever the walk passes the route decision (an escalated task)
    tampered = [dict(s) for s in spans]
    for s in tampered:
        if s["phase"] == "route":
            s["mode"] = 99
    failed = []
    for tid in task_ids:
        got = t_prov.lineage(tampered, tid, records=recs)
        assert got == j_prov.lineage(tampered, tid, records=recs)
        if not got["ok"]:
            failed.append(tid)
            assert any("hash mismatch" in f for f in got["hash_failures"])
    assert failed


def test_verify_span_file_equal_on_a_reference_span_file(
        reference_span_file):
    path, spans, _ = reference_span_file
    got = t_prov.verify_span_file(path)
    assert got == j_prov.verify_span_file(path)
    assert got["ok"] and got["records"] == len(spans)


# ----------------------------------------------------------------------
# the environment fingerprint
# ----------------------------------------------------------------------
def test_capture_environment_is_stable_and_names_torch():
    from repro_torch.teamllm.fingerprint import (
        PROMPT_TEMPLATE, capture_environment, prompt_hash)
    import torch
    a, b = capture_environment(), capture_environment()
    assert a == b and a.digest() == b.digest()
    assert a.torch_version == torch.__version__
    assert a.cuda_version == str(torch.version.cuda or "none")
    assert a.prompt_template_hash == prompt_hash(PROMPT_TEMPLATE)
    assert not hasattr(a, "jax_version")


def test_capture_environment_imports_no_jax():
    snippet = (
        "import sys\n"
        "from repro_torch.teamllm import capture_environment\n"
        "d = capture_environment().digest()\n"
        "assert capture_environment().digest() == d\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith"
        "('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(d)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [subprocess.run([sys.executable, "-c", snippet], env=env,
                           capture_output=True, text=True, timeout=120)
            for _ in range(2)]
    assert all(r.returncode == 0 for r in runs), runs[0].stderr[-2000:]
    assert runs[0].stdout == runs[1].stdout and len(runs[0].stdout) == 17


def test_prompt_helpers_equal():
    from repro.teamllm import fingerprint as jf
    from repro_torch.teamllm import fingerprint as tf
    for text in ("3 + 4 =", "w1 w2 w3", ""):
        for ex in ("", "1 + 1 = -> 2"):
            assert tf.render_prompt(text, ex) == jf.render_prompt(text, ex)
        assert tf.stable_fingerprint(text) == jf.stable_fingerprint(text)
    for tmpl in (tf.PROMPT_TEMPLATE, tf.PROMPT_TEMPLATE_RETRIEVAL):
        assert tf.prompt_hash(tmpl) == jf.prompt_hash(tmpl)
    assert tf.RUBRIC_VERSION == jf.RUBRIC_VERSION
