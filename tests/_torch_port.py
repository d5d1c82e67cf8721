"""Shared helpers for the tests that hold the PyTorch port
(``repro_torch``) against the JAX reference (``repro``): the same
fixture models, converted once per params object, configs carried
across field by field, and the engine gates (ladder rung 4: equal
judge-visible outputs, record hashes and chain heads).

Run as a script, it serves the 200-task legs of the gates that tier-1
runs at small scale and prints each leg's wall and mismatch counts:
``engine`` (stepped at megastep 1, 4 and "auto"; waves paged and
``paged=False``), ``faults`` (the crash legs kill@mid, kill@3/4 and
torn@3/4, the degraded fleet, and the observability legs) and
``queued`` (the scheduler, compacted against masked, queued against
stepped, and the queued engine's spans) and ``hetero`` (the
heterogeneous fleets' legs: the dense baseline, stepped over ring
pages and lanes, the int8-paged wave, kill and recover, the Mamba
probe; and the serve CLI's default fleet through each engine and
through ``serve``) and ``moe`` (the gather-MoE fleet of ``mesh2d_zoo``
on pages, and the serve CLI's capacity-MoE/MLA fleet on the
contiguous-cache fallback) and ``vision`` (the serve CLI's fleet with a
llava member on the contiguous-cache fallback beside llama3-8b on
pages; whisper's and llava's sampling with frames and patches) and
``mesh`` (the serving mesh at data=4 and (data 2, model 2): each port
leg against the reference's same leg, served in a subprocess under
forced host devices, and against the port's single-device run)::

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python tests/_torch_port.py \
        [engine] [faults] [queued] [hetero] [moe] [vision] [mesh]
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.configs.base import ModelConfig as TorchModelConfig
from repro_torch.data.tasks import Task as TorchTask
from repro_torch.models.params import from_jax_numpy
from repro_torch.serving import ZooModel as TorchZooModel


def _torch_dataclass(obj):
    """A reference config dataclass (or a plain value) as the port's
    class of the same name, field for field."""
    if not dataclasses.is_dataclass(obj):
        return obj
    from repro_torch.configs import base
    cls = getattr(base, type(obj).__name__)
    return cls(**{f.name: _torch_dataclass(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


def torch_cfg(cfg) -> TorchModelConfig:
    """The port's ModelConfig with every field of the reference's (its
    nested MoE, MLA, SSM, RG-LRU and encoder configs as the port's)."""
    return _torch_dataclass(cfg)


def torch_task(task) -> TorchTask:
    return TorchTask(**dataclasses.asdict(task))


def pallas_zoo(probe, ensemble):
    """The reference fleet with ``use_pallas=True`` configs, so its ops
    dispatch reaches the ``kernels/ref.py`` oracles the port's plain
    versions port. Params objects keep their identity (the probe twin
    shares the probe's)."""
    from repro.serving import ZooModel
    cfgs = {}

    def conv(zm):
        key = id(zm.cfg)
        if key not in cfgs:
            cfgs[key] = zm.cfg.replace(use_pallas=True)
        return ZooModel(name=zm.name, cfg=cfgs[key], params=zm.params)

    return conv(probe), [conv(m) for m in ensemble]


def torch_zoo(probe, ensemble, device="cpu"):
    """The port's fleet: params converted once per params object, so
    the probe twin keeps the probe's identity."""
    conv: dict = {}

    def zoo(zm):
        key = id(zm.params)
        if key not in conv:
            conv[key] = from_jax_numpy(
                torch_cfg(zm.cfg), jax.tree.map(np.asarray, zm.params),
                device=device)
        return TorchZooModel(name=zm.name, cfg=torch_cfg(zm.cfg),
                             params=conv[key])

    return zoo(probe), [zoo(m) for m in ensemble]


def engine_fleets(prompt_chars: int = 24, n_tasks: int = 16):
    """The reference's and the port's ``paged_zoo`` fleets and the
    long-prompt stream (16 tasks) the engine tests serve."""
    from harness.simulate import long_prompt_workload
    tasks = long_prompt_workload(n_tasks, prompt_chars=prompt_chars,
                                 seed=0)
    return (*paged_fleets(), tasks)


def quant_fleets(n_tasks: int = 16, prompt_chars: int = 24):
    """``engine_fleets`` with an int8-KV probe: the probe and its twin
    take ``kv_quant=True`` (the int8 page layout, or an int8 contiguous
    cache with ``paged=False``), the two other members stay dense."""
    from harness.simulate import long_prompt_workload, paged_zoo
    from repro.serving import ZooModel
    probe, ensemble = paged_zoo(seed=0)
    qprobe = ZooModel(name="probe-q8",
                      cfg=probe.cfg.replace(kv_quant=True),
                      params=probe.params)
    ensemble = [ensemble[0], ensemble[1],
                ZooModel(name="m3-probe-q8", cfg=qprobe.cfg,
                         params=probe.params)]
    jprobe, jens = pallas_zoo(qprobe, ensemble)
    tprobe, tens = torch_zoo(qprobe, ensemble)
    assert tens[2].params is tprobe.params
    tasks = long_prompt_workload(n_tasks, prompt_chars=prompt_chars,
                                 seed=0)
    return (jprobe, jens), (tprobe, tens), tasks


def forced_route(n_tasks: int, pattern=(0, 0, 1, 2)):
    """A route_fn keyed by admission index that forces every mode:
    single, arena-lite and full-arena rows (in the shares of
    ``pattern``) in a fixed shuffle."""
    modes = np.random.default_rng(0x45A).permutation(
        np.resize(np.asarray(pattern, np.int32), n_tasks))

    def route(sig, indices):
        return modes[np.asarray(indices, np.int64)]

    return route


def check_records_against_reference(run_id, member_names, legs) -> None:
    """Each package's engine results become TraceRecords through its
    own ``teamllm`` — the reference's by its harness's
    ``_engine_traces``, the port's by ``chip_smoke.engine_traces``, the
    same materialisation — chained leg after leg (``legs``: (tasks,
    reference result, port result)) into one ``ArtifactStore`` each.
    Requires every task's record hash equal (its hashed view first, so
    a mismatch names its field), both chains auditing OK, and
    byte-identical heads."""
    from chip_smoke import engine_traces
    from harness.simulate import _engine_traces
    from repro.teamllm.artifacts import ArtifactStore as JStore
    from repro_torch.teamllm.artifacts import ArtifactStore as TStore

    with tempfile.TemporaryDirectory(prefix="acar-rung4-") as d:
        jpath, tpath = Path(d) / "ref.jsonl", Path(d) / "port.jsonl"
        jstore, tstore = JStore(jpath), TStore(tpath)
        n, differ = 0, []
        for tasks, jres, tres in legs:
            jt = _engine_traces(run_id, tasks, jres, member_names, jstore)
            tt = engine_traces(run_id, [torch_task(t) for t in tasks],
                               tres, member_names, tstore)
            for a, b in zip(jt, tt):
                if a.record_hash() != b.record_hash():
                    va, vb = a.hashed_view(), b.hashed_view()
                    differ.append((n, a.task_id, sorted(
                        k for k in va if va[k] != vb.get(k))))
                n += 1
        assert not differ, differ[:5]
        ja, ta = JStore(jpath).audit(), TStore(tpath).audit()
        assert ja["ok"] and ta["ok"], (ja, ta)
        assert ta["records"] == ja["records"] == n
        assert ta["head"] == ja["head"] == tstore.head


def _mismatches(jres, tres, n) -> dict:
    return {
        "sigma": [i for i in range(n) if jres.sigma[i] != tres.sigma[i]],
        "mode": [i for i in range(n) if jres.modes[i] != tres.modes[i]],
        "answer": [i for i in range(n)
                   if jres.final_answers[i] != tres.final_answers[i]],
        "member": [i for i in range(n)
                   if jres.member_answers[i] != tres.member_answers[i]],
        "probe_text": [i for i in range(n)
                       if jres.probe_texts[i] != tres.probe_texts[i]],
    }


def check_run_batch_against_reference(fleets, paged, waves=2,
                                      ensemble_temperature=0.0,
                                      twin=True, route_fn=None) -> None:
    """Serve the stream through both packages' ``run_batch`` as
    ``waves`` consecutive waves on one engine (later waves hit the
    prompt prefix cache) with the same knobs and forced routes; require
    zero mismatches in sigma, mode, final answer, member answers and
    probe texts, equal compaction and paged-KV accounting, and equal
    record hashes and chain heads over the waves. ``twin``: the
    ensemble holds the probe's twin; ``route_fn``: ``forced_route``'s
    by default."""
    from repro.configs.acar import ACARConfig as JACARConfig
    from repro.serving import BatchedACAREngine as JEngine
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine

    (jprobe, jens), (tprobe, tens), tasks = fleets
    route = route_fn or forced_route(len(tasks))
    knobs = dict(max_new_tokens=6, paged=paged, route_fn=route)
    temps = dict(probe_temperature=0.9,
                 ensemble_temperature=ensemble_temperature, seed=0)
    jeng = JEngine(JACARConfig(**temps), jprobe, jens, **knobs)
    teng = BatchedACAREngine(ACARConfig(**temps), tprobe, tens,
                             device="cpu", **knobs)
    per = len(tasks) // waves
    modes, legs = set(), []
    for w in range(waves):
        wave = tasks[w * per:(w + 1) * per]
        jres = jeng.run_batch(wave, start_index=w * per)
        tres = teng.run_batch([torch_task(t) for t in wave],
                              start_index=w * per)
        mism = _mismatches(jres, tres, len(wave))
        assert all(not v for v in mism.values()), (w, mism)
        assert dataclasses.asdict(tres.compaction) == \
            dataclasses.asdict(jres.compaction), w
        assert tres.ensemble_calls_saved == jres.ensemble_calls_saved
        modes |= set(tres.modes.tolist())
        legs.append((wave, jres, tres))
    assert modes >= {1, 2}
    check_records_against_reference(
        f"wave-{paged}", [m.name for m in jens], legs)
    jkv = {k: dataclasses.asdict(v) for k, v in jeng.kv_stats().items()}
    tkv = {k: dataclasses.asdict(v) for k, v in teng.kv_stats().items()}
    assert tkv == jkv
    if paged is None:
        st = teng.kv_stats()[tprobe.name]
        assert st.probe_highwater_bytes == \
            jeng.kv_stats()[jprobe.name].probe_highwater_bytes > 0
        assert st.prefill_tokens_reused_prefix > 0 and st.cow_forks > 0
        # sampled members decode the whole wave (masked), so only a
        # greedy twin seeds its decode from the probe's pages
        assert (st.prefill_tokens_reused_probe > 0) == \
            (twin and ensemble_temperature <= 0.0)
    elif paged is False:
        assert not tkv


def check_run_stepped_against_reference(fleets, megastep) -> None:
    """Serve the stream through both packages' ``run_stepped`` with the
    same knobs and require zero mismatches in sigma, mode, final
    answer, member answers and probe texts, equal prefill-chunk, tick
    and page accounting, and equal record hashes and chain heads."""
    (jprobe, jens), (tprobe, tens), tasks = fleets
    ref, port = stepped_pair(fleets[:2], tasks, max_new_tokens=6,
                             chunk_tokens=8, batch_size=8)
    jeng, jres = ref(megastep=megastep)
    teng, tres = port(megastep=megastep)
    check_served_equal(f"stepped-{megastep}", tasks, jres, tres,
                       [m.name for m in jens])
    # the stream exercises every route and the twin's page reuse
    assert set(tres.modes.tolist()) >= {1, 2}
    assert tres.step.prefill_chunks == jres.step.prefill_chunks
    jkv, tkv = jeng.kv_stats()[jprobe.name], teng.kv_stats()[tprobe.name]
    assert tkv.pages_highwater == jkv.pages_highwater
    assert tkv.prefill_tokens_reused_probe == \
        jkv.prefill_tokens_reused_probe > 0
    assert tkv.prefill_tokens_reused_prefix == \
        jkv.prefill_tokens_reused_prefix
    assert tkv.cow_forks == jkv.cow_forks


# ----------------------------------------------------------------------
# faults, the journal, recovery and span tracing on the stepped engine
# ----------------------------------------------------------------------
@contextlib.contextmanager
def one_torch_thread():
    """One intra-op torch thread while the block runs. The engines of
    the fault, recovery and tracing tests run tiny shapes, where extra
    threads only contend with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def paged_fleets():
    """The reference's (``use_pallas=True``) and the port's
    ``paged_zoo`` fleets, with no stream."""
    from harness.simulate import paged_zoo
    probe, ensemble = paged_zoo(seed=0)
    jfleet, tfleet = pallas_zoo(probe, ensemble), torch_zoo(probe, ensemble)
    assert tfleet[1][2].params is tfleet[0].params
    return jfleet, tfleet


def stream(n_tasks: int, seed: int, prompt_chars: int = 20,
           duplicate_rate: float = 0.2):
    """``long_prompt_workload`` at ``tests/test_faults.py``'s scale."""
    from harness.simulate import long_prompt_workload
    return long_prompt_workload(n_tasks, prompt_chars, seed=seed,
                                duplicate_rate=duplicate_rate)


def fault_plans(*specs, **plan_kw):
    """The same ``FaultPlan`` in both packages; ``specs`` are
    ``FaultSpec`` keyword dicts."""
    from repro.serving.faults import FaultPlan as JPlan
    from repro.serving.faults import FaultSpec as JSpec
    from repro_torch.serving import FaultPlan, FaultSpec
    return (JPlan(specs=tuple(JSpec(**sp) for sp in specs), **plan_kw),
            FaultPlan(specs=tuple(FaultSpec(**sp) for sp in specs),
                      **plan_kw))


def stepped_pair(fleets, tasks, *, max_new_tokens: int = 4,
                 chunk_tokens: int = 7, batch_size: int = 4,
                 route_fn=None, ensemble_temperature: float = 0.0):
    """Two callables, ``ref(**kw)`` and ``port(**kw)``, that each serve
    ``tasks`` (or ``keyed=``, the same prompts under other golds)
    through a fresh engine of their package with the same knobs
    (``tests/test_faults.py``'s by default) and return ``(engine,
    result)``. ``recover=path`` calls ``recover`` on the journal at
    ``path``; every other keyword goes to the entry point, each
    package's own objects to its own engine."""
    from repro.configs.acar import ACARConfig as JACARConfig
    from repro.serving import BatchedACAREngine as JEngine
    from repro.serving import MicroBatchPolicy as JPolicy
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy

    (jprobe, jens), (tprobe, tens) = fleets
    policy = dict(max_batch_size=batch_size, max_batch_tokens=1 << 20)
    acfg = dict(probe_temperature=0.9, seed=0,
                ensemble_temperature=ensemble_temperature)
    ttasks = [torch_task(t) for t in tasks]

    def serve(eng, tasks_, pol, kw):
        if "recover" in kw:
            kw = dict(kw)
            return eng, eng.recover(tasks_, pol,
                                    journal_path=kw.pop("recover"),
                                    chunk_tokens=chunk_tokens, **kw)
        return eng, eng.run_stepped(tasks_, pol,
                                    chunk_tokens=chunk_tokens, **kw)

    def ref(keyed=None, **kw):
        eng = JEngine(JACARConfig(**acfg), jprobe, jens,
                      max_new_tokens=max_new_tokens, route_fn=route_fn)
        return serve(eng, keyed or tasks, JPolicy(**policy), kw)

    def port(keyed=None, **kw):
        eng = BatchedACAREngine(ACARConfig(**acfg), tprobe, tens,
                                max_new_tokens=max_new_tokens,
                                route_fn=route_fn, device="cpu")
        return serve(eng, [torch_task(t) for t in keyed] if keyed
                     else ttasks, MicroBatchPolicy(**policy), kw)

    return ref, port


def check_served_equal(run_id, tasks, jres, tres, member_names) -> None:
    """Both packages' results of one stream: zero mismatches in sigma,
    mode, answer, member answers and probe texts; equal record hashes
    and chain heads; equal fault-event lists, restored rows, ticks and
    step accounting; and, when traced, equal span records and span
    chain heads."""
    mism = _mismatches(jres, tres, len(tasks))
    assert all(not v for v in mism.values()), mism
    check_records_against_reference(run_id, member_names,
                                    [(tasks, jres, tres)])
    assert tres.faults == jres.faults
    assert tres.restored_rows == jres.restored_rows
    for f in ("ticks", "retired", "requeues", "retries", "aborted",
              "restored", "decode_tokens", "timeline"):
        assert getattr(tres.step, f) == getattr(jres.step, f), f
    assert (tres.spans is None) == (jres.spans is None)
    if jres.spans is not None:
        assert tres.spans == jres.spans
        assert tres.span_head == jres.span_head


def assert_no_leaks(eng) -> None:
    """``tests/test_faults.py``'s drain-time accounting: with the
    prefix cache dropped every server holds exactly its scratch
    pages."""
    for srv in eng._kv_servers.values():
        srv.drop_prefix_cache()
        assert srv.pool.pages_in_use == srv._scratch.size


def journal_state(state) -> dict:
    """A ``RecoveryState`` of either package as a plain dict."""
    return dict(retired=state.retired, admitted=state.admitted,
                faults=state.faults, records=state.records,
                torn_recovered=state.torn_recovered, head=state.head)


def crash_ticks(ticks: int):
    """The harness's kill ticks of a run of ``ticks`` loop ticks: the
    midpoint and 3/4 (``run_crash_recovery_equivalence``)."""
    return max(1, ticks // 2), max(1, ticks * 3 // 4)


def check_crash_leg(ref, port, tasks, base, member_names, workdir,
                    tick: int, torn: bool, tracers=None) -> int:
    """Kill both packages' journaled runs at loop tick ``tick``
    (``torn``: mid-journal-append at that virtual-clock instant), load
    each journal with both packages' loaders (equal states: retired
    rows, records, torn tail, head), recover each package from its own
    journal, and hold the recovered runs to each other and their
    records to the reference's uninterrupted run ``base``. ``tracers``
    (a factory of a (reference, port) pair) traces the killed and the
    recovered runs. Returns the rows restored."""
    from repro.serving.faults import FaultPlan as JPlan
    from repro.serving.faults import SimulatedCrash as JCrash
    from repro.serving.journal import StepJournal as JJournal
    from repro_torch.serving import FaultPlan, SimulatedCrash, StepJournal

    workdir = Path(workdir)
    leg = f"{'torn' if torn else 'kill'}@{tick}"
    jpath, tpath = workdir / f"{leg}-ref.jsonl", workdir / f"{leg}-port.jsonl"
    jt, tt = tracers() if tracers else (None, None)
    try:
        ref(journal_path=jpath, tracer=jt,
            faults=JPlan.crash_at(tick, torn=torn))
        raise AssertionError(f"{leg}: the reference did not crash")
    except JCrash:
        pass
    try:
        port(journal_path=tpath, tracer=tt,
             faults=FaultPlan.crash_at(tick, torn=torn))
        raise AssertionError(f"{leg}: the port did not crash")
    except SimulatedCrash:
        pass
    # every journal through every loader, each on its own copy (a load
    # truncates a torn tail in place)
    states = []
    for path in (jpath, tpath):
        for k, loader in enumerate((JJournal.load, StepJournal.load)):
            copy = path.with_suffix(f".load{k}.jsonl")
            copy.write_bytes(path.read_bytes())
            states.append(journal_state(loader(copy)))
    want = states[0]
    assert all(st == want for st in states), leg
    assert want["torn_recovered"] == torn, leg
    jt, tt = tracers() if tracers else (None, None)
    _, jres = ref(recover=jpath, tracer=jt)
    _, tres = port(recover=tpath, tracer=tt)
    assert tres.restored_rows == len(want["retired"])
    if tracers:
        # span continuity: every restored row re-materialises
        assert sum(1 for sp in tres.spans if sp["phase"] == "restore") \
            == tres.restored_rows
    check_served_equal(f"recovered-{leg}", tasks, jres, tres,
                       member_names)
    check_records_against_reference(f"uninterrupted-{leg}", member_names,
                                    [(tasks, base, tres)])
    return tres.restored_rows


def degraded_plans(member_names, scale: float = 1.0):
    """The reference harness's degraded-fleet plan on one device
    (``run_degraded_fleet`` less its shard loss): a transient launch
    failure and a NaN quarantine of member 0, then a NaN quarantine of
    member 1, at ticks 2, 4 and 7 times ``scale``."""
    return fault_plans(
        dict(tick=int(2 * scale), site="member_launch",
             model=member_names[0]),
        dict(tick=int(4 * scale), site="member_nan",
             model=member_names[0]),
        dict(tick=int(7 * scale), site="member_nan",
             model=member_names[1]))


def check_degraded(ref, port, tasks, member_names, scale: float = 1.0):
    """Serve the degraded plan through both packages, twice in the
    port: equal results, records, heads and fault events; the port's
    replay equal to its first run; equal degraded-route and
    quarantine counters; every task answered or abort-traced; two
    members quarantined, at least one route degraded; no page leaks.
    Returns the port's result."""
    from repro_torch.serving.metrics import (
        MEMBER_QUARANTINED, ROUTES_DEGRADED)
    jplan, tplan = degraded_plans(member_names, scale)
    _, jres = ref(faults=jplan)
    teng, tres = port(faults=tplan)
    teng2, tres2 = port(faults=tplan)
    check_served_equal("degraded", tasks, jres, tres, member_names)
    check_served_equal("degraded-replay", tasks, tres, tres2,
                       member_names)
    for res in (jres, tres2):
        for f, t in ((1, 0), (2, 0), (2, 1)):
            lab = {"from": str(f), "to": str(t)}
            assert tres.metrics.get(ROUTES_DEGRADED, **lab) == \
                res.metrics.get(ROUTES_DEGRADED, **lab)
        for m in member_names:
            assert tres.metrics.get(MEMBER_QUARANTINED, model=m) == \
                res.metrics.get(MEMBER_QUARANTINED, model=m)
    aborted = {f["admission"] for f in tres.faults or []
               if f["kind"] == "row_aborted"}
    assert all(a is not None or i in aborted
               for i, a in enumerate(tres.final_answers))
    assert sum(1 for m in member_names
               if tres.metrics.get(MEMBER_QUARANTINED, model=m)) == 2
    assert any(f["kind"] == "route_degraded" for f in tres.faults)
    assert_no_leaks(teng)
    assert_no_leaks(teng2)
    return tres


def attribution_key(tasks, base, member_names):
    """``tasks`` under golds that let leave-one-out discriminate: the
    zoo never answers a stream's own gold, so every value would be 0
    whatever member answers an engine used. Each full-arena row's gold
    becomes the first of its member answers in ``base`` (an untraced
    run) that the reference's leave-one-out credits with a non-zero
    value; serving does not read the gold."""
    from repro.core.attribution import leave_one_out
    from repro.teamllm.trace import ModelResponse
    keyed = list(tasks)
    for i, task in enumerate(tasks):
        if int(base.modes[i]) < 2:
            continue
        responses = [ModelResponse(model=member_names[mi], response="",
                                   answer=a, cost=0.0)
                     for mi, a in enumerate(base.member_answers[i])
                     if a is not None]
        for r in responses:
            if any(leave_one_out(responses, task.task_id,
                                 r.answer).values()):
                keyed[i] = dataclasses.replace(task, gold=r.answer)
                break
    return keyed


def attribution_oracle_mismatches(tasks, res, member_names):
    """The port's on-capacity ``attribution`` spans against its offline
    leave-one-out oracle, row by row (exact float equality); returns
    (full-arena rows, rows with a non-zero value, mismatches), as the
    harness's ``_attribution_oracle_check``."""
    from repro_torch.core.attribution import leave_one_out
    from repro_torch.teamllm.trace import ModelResponse
    spans = {int(s["trace"].rsplit("#", 1)[1]): s for s in res.spans
             if s["phase"] == "attribution"}
    rows, nonzero, bad = 0, 0, []
    for i, task in enumerate(tasks):
        if int(res.modes[i]) < 2:
            continue
        rows += 1
        responses = [ModelResponse(model=member_names[mi], response="",
                                   answer=a, cost=0.0)
                     for mi, a in enumerate(res.member_answers[i])
                     if a is not None]
        want = {m: float(v) for m, v in leave_one_out(
            responses, task.task_id, task.gold).items()}
        nonzero += any(want.values())
        if i not in spans or spans[i]["values"] != want:
            bad.append(i)
    bad += sorted(set(spans) - {i for i in range(len(tasks))
                                if int(res.modes[i]) >= 2})
    return rows, nonzero, bad


def check_obs(ref, port, tasks, base, member_names, workdir) -> dict:
    """``run_obs_equivalence``'s single-device legs, port against
    reference: each package traced (the port into a span file) over the
    stream under ``attribution_key`` against the reference's untraced
    run ``base`` (records and heads equal); equal span records and span
    heads; the port's span file verified with its head; the lineage of
    every task OK and equal to the reference's; the attribution spans
    equal to the oracle, some of them non-zero; a traced
    crash at 3/4 recovered with a tracer: one restore span per
    restored row and span heads equal to the reference's. Returns the
    counts."""
    from repro.serving.tracing import SpanTracer as JTracer
    from repro.teamllm.prov import lineage as jlineage
    from repro_torch.serving import SpanTracer
    from repro_torch.teamllm.prov import lineage, verify_span_file

    path = Path(workdir) / "spans-port.jsonl"
    keyed = attribution_key(tasks, base, member_names)
    _, jres = ref(keyed=keyed, tracer=JTracer())
    _, tres = port(keyed=keyed, tracer=SpanTracer(path))
    check_served_equal("traced", keyed, jres, tres, member_names)
    check_records_against_reference("traced-vs-untraced", member_names,
                                     [(keyed, base, tres)])
    audit = verify_span_file(path)
    assert audit["ok"] and audit["head"] == tres.span_head, audit
    walked = 0
    for tid in sorted({t.task_id for t in tasks}):
        lin = lineage(tres.spans, tid)
        assert lin["ok"] and lin["verified"] > 0, (tid, lin)
        assert lin == jlineage(jres.spans, tid), tid
        walked += 1
    rows, nonzero, bad = attribution_oracle_mismatches(keyed, tres,
                                                       member_names)
    assert rows > 0 and nonzero > 0 and not bad, (rows, nonzero, bad)
    kill = crash_ticks(base.step.ticks)[1]
    restored = check_crash_leg(
        ref, port, tasks, base, member_names, workdir, kill, False,
        tracers=lambda: (JTracer(), SpanTracer()))
    return dict(spans=len(tres.spans), lineage=walked,
                attribution_rows=rows, attribution_nonzero=nonzero,
                restored=restored)


# ----------------------------------------------------------------------
# the queued wave engine and the continuous-batching scheduler
# ----------------------------------------------------------------------
def experience_stores(n: int = 200):
    """Each package's ``ExperienceStore`` over the same ``n`` past
    experiences (another seed's ``paper_suite``)."""
    from repro.core import retrieval as jret
    from repro.data.tasks import paper_suite
    from repro_torch.core import retrieval as tret
    js, ts = jret.ExperienceStore(), tret.ExperienceStore()
    for i, t in enumerate(paper_suite(1)[:n]):
        e = dict(task_text=t.text, answer=t.gold, correct=bool(i % 2),
                 benchmark=t.benchmark)
        js.add(jret.Experience(**e))
        ts.add(tret.Experience(**e))
    return js, ts


def check_scheduler_against_reference(tasks, workdir, batch: int = 8,
                                      overlap: bool = True,
                                      retrieval: bool = False, **kw):
    """Both packages' ``ContinuousBatchingScheduler`` over their own
    ``paper_backends`` (``ACAR_UJ`` over ``experience_stores`` with
    ``retrieval``, ``ACAR_U`` otherwise) serve ``tasks`` into an
    ``ArtifactStore`` each; ``kw`` goes to both schedulers. Every
    record's hashed view, hash and schedule side channel, every
    outcome's semantic answer, correctness and latency equal;
    ``logical_time`` the admission order; both chains audit OK with
    equal heads; every ``SchedulerStats`` field but ``wall_ms``, the
    cache hits and the rendered metrics equal. Then the port's
    sequential orchestrator over the same stream: equal record hashes
    and head. Returns the port's scheduler and outcomes."""
    from repro.configs import acar as jacar
    from repro.core.backends import paper_backends as jbackends
    from repro.serving import MicroBatchPolicy as JPolicy
    from repro.serving.scheduler import ContinuousBatchingScheduler as JS
    from repro.teamllm.artifacts import ArtifactStore as JStore
    from repro_torch.configs import acar as tacar
    from repro_torch.core import ACAROrchestrator
    from repro_torch.core.backends import paper_backends as tbackends
    from repro_torch.serving import ContinuousBatchingScheduler as TS
    from repro_torch.serving import MicroBatchPolicy
    from repro_torch.teamllm.artifacts import ArtifactStore as TStore

    workdir = Path(workdir)
    jexp, texp = experience_stores() if retrieval else (None, None)
    variant = "ACAR_UJ" if retrieval else "ACAR_U"
    jb, tb = jbackends(), tbackends()
    js = JS(getattr(jacar, variant), jb["gemini-2.0-flash"], jb,
            store=JStore(workdir / "j.jsonl"), experience=jexp,
            run_id="sched", policy=JPolicy(max_batch_size=batch),
            overlap=overlap, **kw)
    ts = TS(getattr(tacar, variant), tb["gemini-2.0-flash"], tb,
            store=TStore(workdir / "t.jsonl"), experience=texp,
            run_id="sched", policy=MicroBatchPolicy(max_batch_size=batch),
            overlap=overlap, **kw)
    jouts, touts = js.serve(tasks), ts.serve([torch_task(t)
                                              for t in tasks])
    assert len(touts) == len(jouts) == len(tasks)
    for j, t in zip(jouts, touts):
        assert t.trace.hashed_view() == j.trace.hashed_view(), \
            j.trace.task_id
        assert t.trace.record_hash() == j.trace.record_hash()
        assert t.trace.schedule == j.trace.schedule
        assert (t.semantic_answer, t.correct, t.latency_ms) == \
            (j.semantic_answer, j.correct, j.latency_ms)
    lt = [o.trace.logical_time for o in touts]
    assert lt == list(range(len(touts))) == \
        [o.trace.schedule["admitted"] for o in touts]
    ja = JStore(workdir / "j.jsonl").audit()
    ta = TStore(workdir / "t.jsonl").audit()
    assert ja["ok"] and ta["ok"] and ta["records"] == ja["records"]
    assert ta["head"] == ja["head"]
    jst, tst = dataclasses.asdict(js.stats), dataclasses.asdict(ts.stats)
    del jst["wall_ms"], tst["wall_ms"]
    assert tst == jst
    assert ts.cache.hits == js.cache.hits
    assert ts.render_metrics() == js.render_metrics()
    tb = tbackends()
    seq = ACAROrchestrator(
        getattr(tacar, variant), tb["gemini-2.0-flash"], tb,
        store=TStore(workdir / "seq.jsonl"), experience=texp,
        run_id="sched").run_suite([torch_task(t) for t in tasks])
    assert [o.trace.record_hash() for o in seq] == \
        [o.trace.record_hash() for o in touts]
    sa = TStore(workdir / "seq.jsonl").audit()
    assert sa["ok"] and sa["head"] == ta["head"]
    return ts, touts


def queued_pair(fleets, tasks, *, max_new_tokens: int = 6,
                batch_size: int = 8, route_fn=None,
                probe_temperature: float = 0.9,
                ensemble_temperature: float = 0.0):
    """Two callables, ``ref(**kw)`` and ``port(**kw)``, that each serve
    ``tasks`` (or ``keyed=``, the same prompts under other golds)
    through ``run_queued`` on a fresh engine of their package and return
    ``(engine, result)``. ``tracer=`` goes to ``run_queued`` (each
    package's own object), every other keyword to the engine
    (``compact``, ``shared_prefix``, ``paged``)."""
    from repro.configs.acar import ACARConfig as JACARConfig
    from repro.serving import BatchedACAREngine as JEngine
    from repro.serving import MicroBatchPolicy as JPolicy
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy

    (jprobe, jens), (tprobe, tens) = fleets
    policy = dict(max_batch_size=batch_size, max_batch_tokens=1 << 20)
    acfg = dict(probe_temperature=probe_temperature, seed=0,
                ensemble_temperature=ensemble_temperature)

    def ref(keyed=None, tracer=None, **kw):
        eng = JEngine(JACARConfig(**acfg), jprobe, jens,
                      max_new_tokens=max_new_tokens, route_fn=route_fn,
                      **kw)
        return eng, eng.run_queued(keyed or tasks, JPolicy(**policy),
                                   tracer=tracer)

    def port(keyed=None, tracer=None, **kw):
        eng = BatchedACAREngine(ACARConfig(**acfg), tprobe, tens,
                                max_new_tokens=max_new_tokens,
                                route_fn=route_fn, device="cpu", **kw)
        return eng, eng.run_queued(
            [torch_task(t) for t in keyed or tasks], MicroBatchPolicy(
                **policy), tracer=tracer)

    return ref, port


def check_queued_equal(run_id, tasks, jres, tres, member_names) -> None:
    """Both packages' ``run_queued`` results of one stream: zero
    mismatches in sigma, mode, answer, member answers and probe texts;
    equal record hashes and chain heads; equal micro-batch sizes, calls
    saved, merged compaction and paged-KV accounting, rendered metrics
    byte for byte, and, when traced, equal span records and span
    heads."""
    mism = _mismatches(jres, tres, len(tasks))
    assert all(not v for v in mism.values()), mism
    check_records_against_reference(run_id, member_names,
                                    [(tasks, jres, tres)])
    assert tres.batch_sizes == jres.batch_sizes
    assert tres.ensemble_calls_saved == jres.ensemble_calls_saved
    assert dataclasses.asdict(tres.compaction) == \
        dataclasses.asdict(jres.compaction)
    assert (tres.kv is None) == (jres.kv is None)
    if jres.kv is not None:
        assert {k: dataclasses.asdict(v) for k, v in tres.kv.items()} == \
            {k: dataclasses.asdict(v) for k, v in jres.kv.items()}
    assert tres.metrics.render() == jres.metrics.render()
    assert (tres.spans is None) == (jres.spans is None)
    if jres.spans is not None:
        assert tres.spans == jres.spans
        assert tres.span_head == jres.span_head


def check_run_queued_against_reference(fleets, tasks, knobs, **pair_kw):
    """Serve ``tasks`` through both packages' ``run_queued`` with the
    same engine ``knobs`` (and ``queued_pair``'s ``pair_kw``) and hold
    them equal (``check_queued_equal``). Returns the port's engine and
    result."""
    ref, port = queued_pair(fleets, tasks, **pair_kw)
    _, jres = ref(**knobs)
    teng, tres = port(**knobs)
    check_queued_equal(f"queued-{sorted(knobs.items())}", tasks, jres,
                       tres, [m.name for m in fleets[0][1]])
    return teng, tres


def compaction_fleets(seed: int = 0):
    """``run_engine_compaction_equivalence``'s fleet: four reduced f32
    models (``tiny_zoo``), the first the probe, no twin."""
    from harness.simulate import tiny_zoo
    zoo = tiny_zoo(seed=seed)
    return pallas_zoo(zoo[0], zoo[1:]), torch_zoo(zoo[0], zoo[1:])


def check_compaction_equivalence(tasks, batch_size: int = 8,
                                 max_new_tokens: int = 4, route_fn=None,
                                 seed: int = 0) -> dict:
    """``run_engine_compaction_equivalence``, port against reference: the
    compacted engine (``compact``, ``shared_prefix``) and the masked one
    (both off) of each package serve ``tasks`` through ``run_queued``;
    each port run equals the reference's run with the same knobs
    (``check_queued_equal``), and the port's masked run equals its
    compacted run in sigma, mode, answers, member answers and probe
    texts, with equal record hashes and chain heads. Returns the
    compacted run's decode-token and probe-prefill reductions."""
    from chip_smoke import chain_head
    fleets = compaction_fleets(seed)
    ref, port = queued_pair(fleets, tasks, max_new_tokens=max_new_tokens,
                            batch_size=batch_size, route_fn=route_fn)
    names = [m.name for m in fleets[1][1]]
    res = {}
    for leg, knobs in (("compacted", dict(compact=True,
                                          shared_prefix=True)),
                       ("masked", dict(compact=False,
                                       shared_prefix=False))):
        _, jres = ref(**knobs)
        _, res[leg] = port(**knobs)
        check_queued_equal(leg, tasks, jres, res[leg], names)
    mism = _mismatches(res["compacted"], res["masked"], len(tasks))
    assert all(not v for v in mism.values()), mism
    ttasks = [torch_task(t) for t in tasks]
    with tempfile.TemporaryDirectory(prefix="acar-compact-") as d:
        heads = [chain_head("compact", ttasks, res[leg], names,
                            Path(d) / f"{leg}.jsonl")
                 for leg in ("compacted", "masked")]
    assert heads[0] == heads[1]
    cs = res["compacted"].compaction
    return dict(decode_token_reduction=cs.ensemble_decode_token_reduction,
                prefill_reduction=cs.probe_prefill_reduction)


def check_queued_against_stepped(fleets, tasks, chunk_tokens: int = 8,
                                 **pair_kw) -> None:
    """``run_step_loop_equivalence``'s claim within the port: its
    ``run_queued`` and its ``run_stepped`` serve the same stream with
    the same knobs to equal sigma, mode, answers, member answers and
    probe texts, record hashes and chain heads."""
    from chip_smoke import chain_head
    _, port = queued_pair(fleets, tasks, **pair_kw)
    _, wave = port()
    _, step = stepped_pair(
        fleets, tasks, max_new_tokens=pair_kw.get("max_new_tokens", 6),
        chunk_tokens=chunk_tokens,
        batch_size=pair_kw.get("batch_size", 8),
        route_fn=pair_kw.get("route_fn"))[1]()
    mism = _mismatches(wave, step, len(tasks))
    assert all(not v for v in mism.values()), mism
    names = [m.name for m in fleets[1][1]]
    ttasks = [torch_task(t) for t in tasks]
    with tempfile.TemporaryDirectory(prefix="acar-steploop-") as d:
        heads = [chain_head("steploop", ttasks, r, names,
                            Path(d) / f"{k}.jsonl")
                 for k, r in (("wave", wave), ("step", step))]
    assert heads[0] == heads[1]


def check_queued_obs(fleets, tasks, workdir, **pair_kw) -> dict:
    """The wave leg of ``run_obs_equivalence``, port against reference:
    both packages' ``run_queued`` traced (the port into a span file)
    over the stream under ``attribution_key``; equal results, records,
    span records and span heads (``check_queued_equal``); the traced
    run's records equal to the untraced run's; the span file verified
    with its head; the lineage of every task OK and equal to the
    reference's; the attribution spans equal to the leave-one-out
    oracle, some of them non-zero. Returns the counts."""
    from repro.serving.tracing import SpanTracer as JTracer
    from repro.teamllm.prov import lineage as jlineage
    from repro_torch.serving import SpanTracer
    from repro_torch.teamllm.prov import lineage, verify_span_file

    names = [m.name for m in fleets[0][1]]
    ref, port = queued_pair(fleets, tasks, **pair_kw)
    _, base = ref()
    keyed = attribution_key(tasks, base, names)
    path = Path(workdir) / "spans-queued.jsonl"
    _, jres = ref(keyed=keyed, tracer=JTracer())
    _, tres = port(keyed=keyed, tracer=SpanTracer(path))
    check_queued_equal("queued-traced", keyed, jres, tres, names)
    check_records_against_reference("queued-traced-vs-untraced", names,
                                    [(keyed, base, tres)])
    audit = verify_span_file(path)
    assert audit["ok"] and audit["head"] == tres.span_head, audit
    walked = 0
    for tid in sorted({t.task_id for t in tasks}):
        lin = lineage(tres.spans, tid)
        assert lin["ok"] and lin["verified"] > 0, (tid, lin)
        assert lin == jlineage(jres.spans, tid), tid
        walked += 1
    rows, nonzero, bad = attribution_oracle_mismatches(keyed, tres, names)
    assert rows > 0 and nonzero > 0 and not bad, (rows, nonzero, bad)
    return dict(spans=len(tres.spans), lineage=walked,
                attribution_rows=rows, attribution_nonzero=nonzero)


def hetero_fleets(mamba_probe: bool = False):
    """The reference's (``use_pallas=True``) and the port's fleets of
    ``run_hetero_equivalence``: ``hetero_zoo`` (an int8-KV probe, a
    Mamba member on lanes, a sliding-window member on ring pages and
    the probe's int8 twin) or, with ``mamba_probe``, ``mamba_probe_zoo``
    (a Mamba probe on lanes, a dense member, a Mamba member and the
    probe's twin)."""
    from harness.simulate import hetero_zoo, mamba_probe_zoo
    probe, ensemble = (mamba_probe_zoo if mamba_probe else hetero_zoo)(
        seed=0)
    jfleet, tfleet = pallas_zoo(probe, ensemble), torch_zoo(probe, ensemble)
    assert tfleet[1][2].params is tfleet[0].params
    return jfleet, tfleet


def check_port_runs_equal(leg, tasks, base, res, member_names) -> None:
    """Two of the port's results of one stream (a leg and its dense
    baseline, the reference harness's own claim): zero mismatches and
    byte-identical chain heads of their records."""
    from chip_smoke import chain_head
    mism = _mismatches(base, res, len(tasks))
    assert all(not v for v in mism.values()), (leg, mism)
    ttasks = [torch_task(t) for t in tasks]
    with tempfile.TemporaryDirectory(prefix="acar-port-leg-") as d:
        heads = [chain_head(leg, ttasks, r, member_names,
                            Path(d) / f"{i}.jsonl")
                 for i, r in enumerate((base, res))]
    assert heads[0] == heads[1], leg


def hetero_legs(workdir, n_tasks: int = 200, batch_size: int = 8,
                route_fn=None, prompt_chars: int = 24):
    """The single-device legs of the reference harness's
    ``run_hetero_equivalence`` (its knobs: 6 new tokens, chunk 8,
    probe temperature 0.9), port against reference: the ``paged=False``
    queued baseline (``dense``), the stepped loop over mixed layouts
    (``step``), the int8-paged queued wave (``wave-paged``), a kill at
    3/4 of the stepped run's ticks and ``recover`` (``recovered``), and
    the Mamba-probe fleet stepped (``mamba-step``). Each port leg also
    equals the port's own dense baseline, and the ring member's block
    table is narrower than a dense row's. Returns {leg: callable}."""
    from harness.simulate import long_prompt_workload
    from repro_torch.data import tokenizer as ttok
    from repro_torch.serving.kv_pool import pages_for

    tasks = long_prompt_workload(n_tasks, prompt_chars, seed=0,
                                 duplicate_rate=0.15)
    kw = dict(max_new_tokens=6, batch_size=batch_size, route_fn=route_fn)
    state: dict = {}

    def fleet(mamba: bool):
        key = ("fleet", mamba)
        if key not in state:
            fleets = hetero_fleets(mamba_probe=mamba)
            state[key] = (fleets, [m.name for m in fleets[0][1]],
                          queued_pair(fleets, tasks, **kw),
                          stepped_pair(fleets, tasks, chunk_tokens=8, **kw))
        return state[key]

    def base(mamba: bool = False):
        key = ("base", mamba)
        if key not in state:
            _, names, (qref, qport), _ = fleet(mamba)
            _, jres = qref(paged=False)
            _, tres = qport(paged=False)
            check_queued_equal(f"hetero-dense-{mamba}", tasks, jres, tres,
                               names)
            state[key] = (jres, tres)
        return state[key]

    def dense():
        base()
        return "paged=False baseline"

    def step():
        fleets, names, _, (sref, sport) = fleet(False)
        _, tbase = base()
        _, jres = sref()
        teng, tres = sport()
        check_served_equal("hetero-step", tasks, jres, tres, names)
        check_port_runs_equal("hetero-step", tasks, tbase, tres, names)
        state["ticks"] = tres.step.ticks
        s = int(ttok.encode_aligned([tasks[0].text]).shape[1])
        srv = teng._stepped_server(fleets[1][1][1])
        ring_w = srv.table_width(s, 6)
        dense_w = pages_for(s + 6, srv.page_size)
        assert srv.layout == "ring" and ring_w < dense_w
        kv = teng.kv_stats()
        assert kv[fleets[1][0].name].pages_highwater > 0
        return (f"{tres.step.ticks} ticks, ring table width {ring_w} < "
                f"dense {dense_w}, layouts "
                f"{sorted((n, st.pages_highwater) for n, st in kv.items())}")

    def wave_paged():
        _, names, (qref, qport), _ = fleet(False)
        _, tbase = base()
        _, jres = qref()
        _, tres = qport()
        check_queued_equal("hetero-wave-paged", tasks, jres, tres, names)
        check_port_runs_equal("hetero-wave-paged", tasks, tbase, tres,
                              names)
        return "int8 pages"

    def recovered():
        _, names, _, (sref, sport) = fleet(False)
        jbase, tbase = base()
        if "ticks" not in state:
            state["ticks"] = sport()[1].step.ticks
        tick = max(1, state["ticks"] * 3 // 4)
        restored = check_crash_leg(sref, sport, tasks, jbase, names,
                                   workdir, tick, torn=False)
        return f"recovered@{tick}, restored {restored}"

    def mamba_step():
        fleets, names, _, (sref, sport) = fleet(True)
        _, tbase = base(True)
        _, jres = sref()
        teng, tres = sport()
        check_served_equal("hetero-mamba-step", tasks, jres, tres, names)
        check_port_runs_equal("hetero-mamba-step", tasks, tbase, tres,
                              names)
        hw = teng.kv_stats()[fleets[1][0].name].pages_highwater
        assert teng._stepped_server(fleets[1][0]).layout == "lanes"
        assert hw > 0
        return f"lanes high-water {hw}"

    return {"dense": dense, "step": step, "wave-paged": wave_paged,
            "recovered": recovered, "mamba-step": mamba_step}


# AdamW steps of arithmetic that ``default_fleets`` gives each model
DEFAULT_FLEET_STEPS = 10


def default_fleets(train_steps: int = DEFAULT_FLEET_STEPS,
                   ensemble=None):
    """The serve CLI's default fleet (``DEFAULT_PROBE`` smollm-135m;
    ``DEFAULT_ENSEMBLE`` llama3-8b, deepseek-7b, recurrentgemma-2b, or
    the arch names ``ensemble`` gives, as ``--ensemble`` does) as the
    CLI builds it: reduced f32 arithmetic configs trained
    ``train_steps`` steps each by the port's ``build_zoo`` on the CPU
    (member i from seed i), then the same values in the reference's
    tree. Seed weights answer "" on every row, so a member that computed
    wrongly would go unseen; after 10 steps every member answers in
    digits. Returns the reference's (``use_pallas=True``) and the port's
    fleets."""
    from repro.launch.serve import DEFAULT_ENSEMBLE, DEFAULT_PROBE
    from repro.launch.train import reduced_for_data
    from repro.serving import ZooModel
    from repro_torch.launch.serve import build_zoo
    trained = build_zoo((DEFAULT_PROBE,) + tuple(ensemble or
                                                 DEFAULT_ENSEMBLE),
                        train_steps, verbose=False, device="cpu")
    zoo = [ZooModel(name=m.name, cfg=reduced_for_data(m.name, "arithmetic"),
                    params=jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                        m.params))
           for m in trained]
    return pallas_zoo(zoo[0], zoo[1:]), torch_zoo(zoo[0], zoo[1:])


def serve_reports(fleets, tasks, **kw):
    """Both packages' ``serve`` reports over one fleet and stream (the
    port on the CPU), without their walls."""
    from repro.configs.acar import ACARConfig as JACARConfig
    from repro.launch import serve as jserve
    from repro_torch.configs import ACARConfig
    from repro_torch.launch import serve as tserve
    (jprobe, jens), (tprobe, tens) = fleets
    acfg = dict(probe_temperature=0.9, seed=0)
    want = jserve.serve(tasks, jprobe, jens, JACARConfig(**acfg),
                        verbose=False, **kw)
    got = tserve.serve([torch_task(t) for t in tasks], tprobe, tens,
                       ACARConfig(**acfg), verbose=False, device="cpu",
                       **kw)
    for report in (want, got):
        del report["wall_ms"]
    return got, want


def default_fleet_legs(n_tasks: int = 200, batch_size: int = 8,
                       prompt_chars: int = 76):
    """The serve CLI's default fleet (``default_fleets``) through each
    engine ``serve`` drives, port against reference, over long prompts
    with duplicates (by default past the reduced recurrentgemma-2b's
    64-position ring window, so its ring caches wrap), forced routes
    over every mode, 6 new tokens, chunk 8, and the members sampled at
    0.9 like the probe: greedy, seed weights answer "" on every row, so
    a wrong member would go unseen. The legs: the wave (``run_batch``
    in two waves: the dense members from pool pages, recurrentgemma-2b
    over contiguous ring and RG-LRU caches), ``run_queued`` and
    ``run_stepped`` at megastep 2 (recurrentgemma-2b on the
    contiguous-cache member fallback). Each is equal to the reference on
    sigma, mode, answers, member answers, probe texts, record hashes and
    chain head, and recurrentgemma-2b answers every full-arena row, not
    always "". Returns {leg: callable}."""
    from harness.simulate import long_prompt_workload
    tasks = long_prompt_workload(n_tasks, prompt_chars, seed=0,
                                 duplicate_rate=0.15)
    fleets = default_fleets()
    names = [m.name for m in fleets[0][1]]
    hybrid = names.index("recurrentgemma-2b")
    # half the rows full-arena: the only mode that runs the hybrid
    kw = dict(max_new_tokens=6, batch_size=batch_size,
              route_fn=forced_route(n_tasks, (0, 1, 2, 2)),
              ensemble_temperature=0.9)

    def hybrid_answered(res) -> str:
        full = [res.member_answers[i][hybrid] for i in range(n_tasks)
                if res.modes[i] == 2]
        assert full and None not in full and any(full), full
        return (f"recurrentgemma-2b answered {len(full)} full-arena rows, "
                f"{sum(map(bool, full))} not empty")

    def wave():
        check_run_batch_against_reference(fleets + (tasks,), paged=None,
                                          ensemble_temperature=0.9,
                                          twin=False,
                                          route_fn=kw["route_fn"])
        return "two waves"

    def queued():
        _, tres = check_run_queued_against_reference(fleets, tasks, {},
                                                     **kw)
        return hybrid_answered(tres)

    def step():
        ref, port = stepped_pair(fleets, tasks, chunk_tokens=8, **kw)
        _, jres = ref(megastep=2)
        _, tres = port(megastep=2)
        check_served_equal("default-step", tasks, jres, tres, names)
        return hybrid_answered(tres)

    return {"default wave": wave, "default queued": queued,
            "default step loop": step}


def serve_legs(n_tasks: int = 200):
    """``serve``'s reports over the default fleet, port against
    reference: the wave (``run_batch``), ``scheduler=True`` and the step
    loop at megastep 2. Returns {leg: callable}."""
    from repro.data.tasks import arithmetic_suite
    tasks = arithmetic_suite(n_tasks, seed=99)
    fleets = default_fleets()

    def leg(**kw):
        def run():
            got, want = serve_reports(fleets, tasks, **kw)
            assert got == want, (got, want)
            return f"modes {got['mode_distribution']}"
        return run

    return {"serve wave": leg(),
            "serve scheduler": leg(scheduler=True, batch_size=8),
            "serve step loop": leg(step_loop=True, batch_size=8,
                                   megastep=2)}


# ----------------------------------------------------------------------
# the MoE family and MLA
# ----------------------------------------------------------------------
def mesh2d_fleets():
    """The reference's (``use_pallas=True``) and the port's
    ``mesh2d_zoo`` fleets: the probe, a dense member, a gather-MoE
    member on dense pages (capacity-free, batch-invariant) and the
    probe's twin."""
    from harness.simulate import mesh2d_zoo
    probe, ensemble = mesh2d_zoo(seed=0)
    jfleet, tfleet = pallas_zoo(probe, ensemble), torch_zoo(probe, ensemble)
    assert tfleet[1][2].params is tfleet[0].params
    assert tfleet[1][1].cfg.moe.impl == "gather"
    return jfleet, tfleet


def mesh2d_legs(n_tasks: int = 200, megasteps=(1, "auto")):
    """The single-device leg of the reference harness's
    ``run_mesh2d_equivalence`` (its knobs: chunk 4, 6 new tokens, batch
    8, probe temperature 0.9, 24-character prompts with duplicates at
    0.15) through both packages' ``run_stepped`` at each megastep:
    sigma, mode, answers, member answers, probe texts, record hashes and
    chain heads equal. The gather member serves from dense pages, its
    experts through ``ops.fused_swiglu`` on prefill chunks and decode
    ticks. Returns {leg: callable}."""
    from harness.simulate import long_prompt_workload
    tasks = long_prompt_workload(n_tasks, 24, seed=0, duplicate_rate=0.15)
    state: dict = {}

    def pair():
        if "pair" not in state:
            fleets = mesh2d_fleets()
            state["pair"] = ([m.name for m in fleets[0][1]],
                             stepped_pair(fleets, tasks, max_new_tokens=6,
                                          chunk_tokens=4, batch_size=8))
        return state["pair"]

    def leg(megastep):
        def run():
            names, (ref, port) = pair()
            _, jres = ref(megastep=megastep)
            teng, tres = port(megastep=megastep)
            check_served_equal(f"mesh2d-{megastep}", tasks, jres, tres,
                               names)
            moe = teng._stepped_server(teng.ensemble[1])
            assert moe is not None and moe.layout == "dense"
            assert teng.kv_stats()[names[1]].pages_highwater > 0
            return f"{tres.step.ticks} ticks, modes " + str(dict(
                collections.Counter(tres.modes.tolist())))
        return run

    return {f"mesh2d megastep {m!r}": leg(m) for m in megasteps}


# the serve CLI's MoE fleet: --ensemble mixtral-8x22b deepseek-v2-236b.
# Both members are capacity MoE (deepseek-v2 with MLA, a shared expert
# and a dense layer 0), which no page layout serves
MOE_ENSEMBLE = ("mixtral-8x22b", "deepseek-v2-236b")
# the serve CLI's vision fleet: --ensemble llava-next-mistral-7b
# llama3-8b. Llava (served text only, as the reference's engine serves
# it) takes no page layout; llama3-8b takes dense pages
VISION_ENSEMBLE = ("llava-next-mistral-7b", "llama3-8b")


def cli_fleet_legs(ensemble, label: str, n_tasks: int = 200,
                   batch_size: int = 8, prompt_chars: int = 24):
    """The serve CLI's fleet with ``--ensemble`` ``ensemble``
    (``default_fleets``) through ``run_stepped`` (the members no page
    layout serves on the contiguous-cache member fallback, the others
    on pages) and ``run_queued`` (contiguous caches, masked), port
    against reference: forced routes with half the rows full arena, 6
    new tokens, chunk 8, the members sampled at 0.9 like the probe.
    Equal sigma, mode, answers, member answers, probe texts, record
    hashes and chain heads; each member gives some full-arena row a
    non-empty answer. Returns {leg: callable}."""
    from harness.simulate import long_prompt_workload
    from repro_torch.models.transformer import resolve_layout
    tasks = long_prompt_workload(n_tasks, prompt_chars, seed=0,
                                 duplicate_rate=0.15)
    state: dict = {}
    kw = dict(max_new_tokens=6, batch_size=batch_size,
              route_fn=forced_route(n_tasks, (0, 1, 2, 2)),
              ensemble_temperature=0.9)

    def fleets():
        if "fleets" not in state:
            state["fleets"] = default_fleets(ensemble=ensemble)
        return state["fleets"]

    def answered(res, names) -> str:
        notes = []
        for j, name in enumerate(names):
            full = [res.member_answers[i][j] for i in range(n_tasks)
                    if res.modes[i] == 2]
            assert full and None not in full and any(full), (name, full)
            notes.append(f"{name} {sum(map(bool, full))}/{len(full)}")
        return "full-arena rows answered: " + ", ".join(notes)

    def step():
        fl = fleets()
        names = [m.name for m in fl[0][1]]
        ref, port = stepped_pair(fl, tasks, chunk_tokens=8, **kw)
        _, jres = ref()
        teng, tres = port()
        check_served_equal(f"{label}-step", tasks, jres, tres, names)
        for m in teng.ensemble:
            assert (teng._stepped_server(m) is None) == (
                resolve_layout(m.cfg) is None), m.name
        return answered(tres, names)

    def queued():
        fl = fleets()
        _, tres = check_run_queued_against_reference(fl, tasks, {}, **kw)
        return answered(tres, [m.name for m in fl[0][1]])

    return {f"{label} fleet step loop": step,
            f"{label} fleet queued": queued}


def moe_fleet_legs(n_tasks: int = 200, batch_size: int = 8,
                   prompt_chars: int = 24):
    """``cli_fleet_legs`` for the MoE fleet (``MOE_ENSEMBLE``): both
    members on the contiguous-cache member fallback (capacity prefill,
    per-token MoE decode, MLA's latent cache)."""
    return cli_fleet_legs(MOE_ENSEMBLE, "moe", n_tasks, batch_size,
                          prompt_chars)


def vision_fleet_legs(n_tasks: int = 200, batch_size: int = 8,
                      prompt_chars: int = 24):
    """``cli_fleet_legs`` for the vision fleet (``VISION_ENSEMBLE``):
    llava on the contiguous-cache member fallback over ring caches,
    llama3-8b on dense pages."""
    return cli_fleet_legs(VISION_ENSEMBLE, "vision", n_tasks, batch_size,
                          prompt_chars)


def frontend_generate_legs(n_prompts: int = 32):
    """Reduced f32 whisper-medium (64 frames) and llava-next-mistral-7b
    (16 patches) through both packages' ``generate`` (greedy, 8 new
    tokens) and ``generate_samples`` (n=3, temperature 0.9, 6 new
    tokens) over ``n_prompts`` prompts of 20 tokens with their own
    frames or patches: equal tokens and lengths, logprobs within 1e-4.
    Returns {leg: callable}."""
    from repro.configs.registry import get_config as jget
    from repro.models import params as jparams
    from repro.sampling import sampler as JS
    from repro_torch.sampling import sampler as TS

    def leg(arch):
        jcfg = jget(arch, reduced=True).replace(dtype="float32",
                                                use_pallas=True)
        jprm = jparams.init_params(jcfg, jax.random.PRNGKey(2))
        tcfg = torch_cfg(jcfg)
        tprm = from_jax_numpy(tcfg, jax.tree.map(np.asarray, jprm),
                              device="cpu")
        rng = np.random.default_rng(11)
        ids = rng.integers(0, jcfg.vocab_size,
                           (n_prompts, 20)).astype(np.int32)
        n = jcfg.encoder.num_frames if jcfg.frontend == "audio" \
            else jcfg.num_patches
        fe = (rng.standard_normal((n_prompts, n, jcfg.d_model))
              * 0.02).astype(np.float32)
        key = jax.random.PRNGKey(3)
        kw = dict(eos_id=-1, pad_id=0)
        runs = [(JS.generate(jcfg, jprm, jnp.asarray(ids), max_new_tokens=8,
                             key=key, frontend_embeds=jnp.asarray(fe), **kw),
                 TS.generate(tcfg, tprm, ids, max_new_tokens=8,
                             key=np.asarray(key),
                             frontend_embeds=torch.from_numpy(fe), **kw)),
                (JS.generate_samples(jcfg, jprm, jnp.asarray(ids), 3,
                                     max_new_tokens=6, temperature=0.9,
                                     key=key,
                                     frontend_embeds=jnp.asarray(fe), **kw),
                 TS.generate_samples(tcfg, tprm, ids, 3, max_new_tokens=6,
                                     temperature=0.9, key=np.asarray(key),
                                     frontend_embeds=torch.from_numpy(fe),
                                     **kw))]
        rows = 0
        for jout, tout in runs:
            np.testing.assert_array_equal(tout.tokens.numpy(),
                                          np.asarray(jout.tokens))
            np.testing.assert_array_equal(tout.lengths.numpy(),
                                          np.asarray(jout.lengths))
            np.testing.assert_allclose(tout.logprobs.numpy(),
                                       np.asarray(jout.logprobs),
                                       atol=1e-4, rtol=1e-4)
            rows += tout.tokens.shape[0]
        return f"{rows} rows: tokens equal, logprobs within 1e-4"

    return {f"{arch} generate / generate_samples ({n_prompts} prompts)":
            (lambda a=arch: leg(a))
            for arch in ("whisper-medium", "llava-next-mistral-7b")}


# ----------------------------------------------------------------------
# the serving mesh: reference legs under forced host devices
# ----------------------------------------------------------------------
# the port's CPU mesh and the reference's forced host devices: enough
# cells for data=4 and for (data 2, model 2)
MESH_DEVICES = 4


def _mesh_fleets(name: str):
    """The reference's and the port's fleet ``name`` (``paged_zoo``,
    ``mesh2d_zoo``, ``hetero_zoo``). The reference's is the harness's
    own, ``use_pallas`` off, as its mesh legs serve it: its Pallas
    dispatch has no column-parallel form, and on the CPU the kernels'
    oracles and the plain path give the same records at these
    scales."""
    from harness import simulate
    probe, ensemble = getattr(simulate, f"{name}_zoo")(seed=0)
    return (probe, ensemble), torch_zoo(probe, ensemble)


def mesh_stream(spec):
    """A leg's task stream: ``("sharded", n)`` is
    ``tests/test_sharded_serving.py``'s data=4 stream (16-digit "+ 1"
    sums, a quarter of them repeats), ``("long", n)`` the reference
    harness's 24-character duplicate-bearing stream."""
    kind, n = spec
    if kind == "long":
        from harness.simulate import long_prompt_workload
        return long_prompt_workload(n, 24, seed=0, duplicate_rate=0.15)
    from repro.data.tasks import Task
    rng = np.random.default_rng(1)
    tasks = []
    for i in range(n):
        if tasks and rng.random() < 0.25:
            tasks.append(tasks[int(rng.integers(len(tasks)))])
            continue
        digits = "".join(str(rng.integers(10)) for _ in range(16))
        tasks.append(Task(task_id=f"t{i}", benchmark="x", kind="math",
                          text=f"{digits} + 1 = ", gold="0",
                          difficulty=0.0))
    return tasks


def run_mesh_legs(pkg: str, legs: dict, workdir) -> dict:
    """Serve every leg of ``legs`` (name -> spec, in order) through one
    package's ``run_stepped`` (``pkg``: "ref" or "port"); returns {name:
    (engine, result)}. A spec names its ``fleet`` (``paged``,
    ``mesh2d``, ``hetero``), its ``stream`` (``mesh_stream``), the
    engine ``knobs`` of ``stepped_pair`` and the ``run`` keywords
    (``data_shards``, ``model_shards``, ``megastep``); ``plan`` is a
    list of ``FaultSpec`` dicts; ``crash_of`` names an earlier leg:
    this one kills a journaled run at 3/4 of that leg's ticks and
    recovers it with the same keywords. The port's legs run on a CPU
    mesh of ``MESH_DEVICES`` logical devices; the reference's need as
    many forced host devices (``reference_mesh_json``)."""
    from repro.serving.faults import FaultPlan as JPlan
    from repro.serving.faults import SimulatedCrash as JCrash
    from repro_torch.serving import FaultPlan, SimulatedCrash
    if pkg == "port":
        from repro_torch.launch.mesh import force_device_count
        force_device_count(MESH_DEVICES, "cpu")
    workdir = Path(workdir)
    fleets: dict = {}
    out: dict = {}
    for name, leg in legs.items():
        if leg["fleet"] not in fleets:
            fleets[leg["fleet"]] = _mesh_fleets(leg["fleet"])
        tasks = mesh_stream(leg["stream"])
        ref, port = stepped_pair(fleets[leg["fleet"]], tasks,
                                 **leg.get("knobs", {}))
        fn = ref if pkg == "ref" else port
        kw = dict(leg.get("run", {}))
        if leg.get("plan"):
            kw["faults"] = fault_plans(*leg["plan"])[pkg == "port"]
        if "crash_of" in leg:
            tick = max(1, out[leg["crash_of"]][1].step.ticks * 3 // 4)
            plan = (JPlan if pkg == "ref" else FaultPlan).crash_at(tick)
            jp = workdir / f"{pkg}-{name}.jsonl"
            try:
                fn(journal_path=jp, faults=plan, **kw)
                raise AssertionError(f"{name}: no crash at tick {tick}")
            except (JCrash, SimulatedCrash):
                pass
            out[name] = fn(recover=jp, **kw)
        else:
            out[name] = fn(**kw)
    return out


def result_json(res, eng=None) -> dict:
    """The judge-visible outputs and step accounting of one engine
    result as JSON (floats keep their bits: an f32 round-trips through
    a Python float)."""
    st = res.step
    out = dict(
        sigma=[float(x) for x in res.sigma],
        modes=[int(m) for m in res.modes],
        final_answers=list(res.final_answers),
        member_answers=[list(m) for m in res.member_answers],
        probe_texts=[list(p) for p in res.probe_texts],
        faults=res.faults, restored_rows=int(res.restored_rows),
        step={f: int(getattr(st, f)) for f in (
            "ticks", "retired", "requeues", "retries", "aborted",
            "restored", "decode_tokens")},
        timeline=[[int(k), [int(x) for x in v]]
                  for k, v in sorted(st.timeline.items())],
        placements=[int(res.metrics.get("acar_shard_placements_total",
                                        shard=str(k)))
                    for k in range(MESH_DEVICES)])
    return out


def result_from_json(d: dict):
    """A result object with the fields ``check_served_equal`` and the
    record materialisations read."""
    import types
    step = types.SimpleNamespace(
        **d["step"], timeline={k: tuple(v) for k, v in d["timeline"]})
    return types.SimpleNamespace(
        sigma=np.asarray(d["sigma"], np.float32),
        modes=np.asarray(d["modes"], np.int32),
        final_answers=d["final_answers"],
        member_answers=d["member_answers"],
        probe_texts=d["probe_texts"], faults=d["faults"],
        restored_rows=d["restored_rows"], step=step, spans=None,
        span_head=None, placements=d["placements"])


def forced_subprocess(snippet: str, count: int = MESH_DEVICES,
                      timeout: int = 1200) -> str:
    """Run ``snippet`` in a python subprocess under ``count`` forced
    host devices (``tests/conftest.py``'s ``forced_devices``: jax locks
    its device count at first init) and return its stdout."""
    import os
    import subprocess
    from repro.xla_flags import merge_host_device_count
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["XLA_FLAGS"] = merge_host_device_count(env.get("XLA_FLAGS"),
                                               count)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src"), str(root / "tests"), str(root)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", snippet], env=env,
                          text=True, capture_output=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"forced-device subprocess failed (exit {proc.returncode}):"
            f"\n{proc.stderr[-4000:]}")
    return proc.stdout


def reference_mesh_json(legs: dict, cache=None) -> dict:
    """The reference's results of ``legs`` (``run_mesh_legs``), served
    in a subprocess under ``MESH_DEVICES`` forced host devices: {name:
    ``result_json``}. ``cache``, a JSON file path, is read when it holds
    the same legs and written otherwise."""
    import json
    if cache is not None and Path(cache).is_file():
        got = json.loads(Path(cache).read_text())
        if got.get("legs") == legs:
            return got["results"]
    snippet = (
        "import json, tempfile\n"
        "import _torch_port as tp\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        f"    out = tp.run_mesh_legs('ref', json.loads({json.dumps(json.dumps(legs))}), d)\n"
        "    print('MESHJSON' + json.dumps(\n"
        "        {k: tp.result_json(r) for k, (_, r) in out.items()}))\n")
    text = forced_subprocess(snippet)
    line = next(ln for ln in text.splitlines()
                if ln.startswith("MESHJSON"))
    results = json.loads(line[len("MESHJSON"):])
    if cache is not None:
        Path(cache).write_text(json.dumps({"legs": legs,
                                           "results": results}))
    return results


def check_mesh_leg(name, leg, jdict, tres, member_names,
                   single=None) -> None:
    """One port mesh leg against the reference's same leg (``jdict``,
    its ``result_json``): zero mismatches in sigma, mode, answers,
    member answers and probe texts, equal record hashes and chain heads,
    equal fault events, restored rows, step accounting and placements;
    and, given the port's single-device result of the same stream
    (``single``), equal outputs and chain heads to it."""
    import json
    tasks = mesh_stream(leg["stream"])
    jres = result_from_json(jdict)
    mism = _mismatches(jres, tres, len(tasks))
    assert all(not v for v in mism.values()), (name, mism)
    check_records_against_reference(name, member_names,
                                    [(tasks, jres, tres)])
    assert json.loads(json.dumps(tres.faults)) == jres.faults, name
    assert tres.restored_rows == jres.restored_rows, name
    for f, v in jdict["step"].items():
        assert getattr(tres.step, f) == v, (name, f)
    assert {k: tuple(v) for k, v in tres.step.timeline.items()} == \
        jres.step.timeline, name
    assert result_json(tres)["placements"] == jres.placements, name
    if single is not None:
        check_port_runs_equal(name, tasks, single, tres, member_names)


def mesh_legs(n_tasks: int = 200, cache=None) -> dict:
    """The 200-task legs of the reference harness's mesh checks, each
    port leg against the same reference leg (served under forced host
    devices) and against the port's single-device run of its stream:
    ``run_sharded_equivalence`` (data=4), the sharded
    ``run_megastep_equivalence`` (K 4 and 16 at data=4), the data=4
    legs of ``run_crash_recovery_equivalence`` (kill at 3/4, recover)
    and of ``run_degraded_fleet`` (the shard loss alone, and the full
    degraded plan twice), ``run_hetero_equivalence``'s data4 leg and
    every leg of ``run_mesh2d_equivalence`` (2 x 2, K 4, "auto",
    recovered at 3/4). ``cache``: a JSON file of the reference's
    results (``reference_mesh_json``). Returns {leg: callable}."""
    long = ("long", n_tasks)
    knobs = dict(max_new_tokens=6, chunk_tokens=8, batch_size=8)
    k2d = dict(max_new_tokens=6, chunk_tokens=4, batch_size=8)
    d4 = dict(data_shards=4)
    m22 = dict(data_shards=2, model_shards=2)
    loss = [dict(tick=6, site="shard_loss", shard=1)]

    def degraded(names):
        return [dict(tick=2, site="member_launch", model=names[0]),
                dict(tick=4, site="member_nan", model=names[0]),
                dict(tick=7, site="member_nan", model=names[1]),
                dict(tick=10, site="shard_loss", shard=2)]

    paged = [m.name for m in _mesh_fleets("paged")[0][1]]
    legs = {
        "paged single": dict(fleet="paged", stream=long, knobs=knobs),
        "sharded data4": dict(fleet="paged", stream=long, knobs=knobs,
                              run=d4),
        "megastep K4 data4": dict(fleet="paged", stream=long,
                                  knobs=knobs, run=dict(d4, megastep=4)),
        "megastep K16 data4": dict(fleet="paged", stream=long,
                                   knobs=knobs,
                                   run=dict(d4, megastep=16)),
        "crash data4 recovered@3/4": dict(
            fleet="paged", stream=long, knobs=knobs, run=d4,
            crash_of="sharded data4"),
        "degraded data4 shard loss": dict(
            fleet="paged", stream=long, knobs=knobs, run=d4, plan=loss),
        "degraded data4 full plan": dict(
            fleet="paged", stream=long, knobs=knobs, run=d4,
            plan=degraded(paged)),
        "hetero single": dict(fleet="hetero", stream=long, knobs=knobs),
        "hetero data4": dict(fleet="hetero", stream=long, knobs=knobs,
                             run=d4),
        "mesh2d single": dict(fleet="mesh2d", stream=long, knobs=k2d),
        "mesh2d 2x2": dict(fleet="mesh2d", stream=long, knobs=k2d,
                           run=m22),
        "mesh2d 2x2 K4": dict(fleet="mesh2d", stream=long, knobs=k2d,
                              run=dict(m22, megastep=4)),
        "mesh2d 2x2 auto": dict(fleet="mesh2d", stream=long, knobs=k2d,
                                run=dict(m22, megastep="auto")),
        "mesh2d 2x2 recovered@3/4": dict(
            fleet="mesh2d", stream=long, knobs=k2d, run=m22,
            crash_of="mesh2d 2x2"),
    }
    # the leg each is held to in the port itself: its stream's
    # single-device run (the full degraded plan changes outputs, so it
    # is held to its own replay instead)
    single_of = {n: f"{leg['fleet']} single" for n, leg in legs.items()
                 if "single" not in n}
    single_of["degraded data4 full plan"] = None
    state: dict = {}

    def served():
        if not state:
            with tempfile.TemporaryDirectory(prefix="acar-mesh-") as d:
                state["ref"] = reference_mesh_json(legs, cache)
                with one_torch_thread():
                    state["port"] = run_mesh_legs("port", legs, d)
                    # the degraded plan's replay
                    replay = {"degraded replay": legs[
                        "degraded data4 full plan"]}
                    state["replay"] = run_mesh_legs("port", replay, d)
        return state

    def leg_check(name):
        def run():
            st = served()
            leg = legs[name]
            teng, tres = st["port"][name]
            names = [m.name for m in teng.ensemble]
            base = single_of.get(name)
            check_mesh_leg(name, leg, st["ref"][name], tres, names,
                           st["port"][base][1] if base else None)
            if name == "degraded data4 full plan":
                check_port_runs_equal(
                    name, mesh_stream(leg["stream"]), tres,
                    st["replay"]["degraded replay"][1], names)
                assert tres.faults == \
                    st["replay"]["degraded replay"][1].faults
            if "run" in leg:
                placed = result_json(tres)["placements"]
                return (f"{tres.step.ticks} ticks, placements {placed}"
                        + (f", restored {tres.restored_rows}"
                           if tres.restored_rows else ""))
            return f"{tres.step.ticks} ticks"
        return run

    return {f"mesh {n}": leg_check(n) for n in legs}


def engine_legs():
    """The 200-task legs of the engine gate: (name, callable)."""
    # the prompt lengths of tier-1's legs: 24 characters stepped, 21
    # (a tail page off the page grid, COW-forked per sample) in waves
    fleets = {"stepped": engine_fleets(n_tasks=200),
              "wave": engine_fleets(prompt_chars=21, n_tasks=200)}
    legs = []
    for knob in (1, 4, "auto"):
        legs.append((f"stepped megastep {knob!r}", lambda k=knob:
                     check_run_stepped_against_reference(
                         fleets["stepped"], megastep=k)))
    for paged in (None, False):
        # waves of 8 tasks, as tier-1's two waves of 16 tasks
        legs.append((f"wave paged={paged}", lambda pg=paged:
                     check_run_batch_against_reference(
                         fleets["wave"], pg, waves=25)))
    return legs


def fault_legs(workdir):
    """The 200-task single-device legs of the reference harness's
    crash-recovery, degraded-fleet and observability checks
    (``run_crash_recovery_equivalence``, ``run_degraded_fleet`` without
    its shard loss, ``run_obs_equivalence``), port against reference at
    the harness's knobs."""
    from harness.simulate import long_prompt_workload
    fleets = paged_fleets()
    names = [m.name for m in fleets[0][1]]
    tasks = long_prompt_workload(200, 24, seed=0, duplicate_rate=0.15)
    ref, port = stepped_pair(fleets, tasks, max_new_tokens=6,
                             chunk_tokens=8, batch_size=8)
    state = {}

    def base():
        if "base" not in state:
            _, state["base"] = ref()
            _, tres = port()
            check_served_equal("uninterrupted", tasks, state["base"],
                               tres, names)
        return state["base"]

    def crash(which, torn):
        b = base()
        tick = crash_ticks(b.step.ticks)[which]
        restored = check_crash_leg(ref, port, tasks, b, names, workdir,
                                   tick, torn)
        return f"tick {tick} of {b.step.ticks}, restored {restored}"

    def degraded():
        res = check_degraded(ref, port, tasks, names)
        kinds: dict = {}
        for f in res.faults:
            kinds[f["kind"]] = kinds.get(f["kind"], 0) + 1
        return f"fault events {kinds}"

    def obs():
        got = check_obs(ref, port, tasks, base(), names, workdir)
        return ", ".join(f"{k} {v}" for k, v in got.items())

    return [("crash kill@mid", lambda: crash(0, False)),
            ("crash kill@3/4", lambda: crash(1, False)),
            ("crash torn@3/4", lambda: crash(1, True)),
            ("degraded fleet (no shard loss)", degraded),
            ("obs (step, recover@3/4, lineage, attribution)", obs)]


def queued_legs(workdir):
    """The 200-task legs of the queued wave engine and the scheduler,
    port against reference at the harness's knobs: ``run_equivalence``
    (both schedulers over ``generate_workload``'s 200 ``paper_suite``
    tasks, and the port's scheduler against its orchestrator),
    ``run_engine_compaction_equivalence`` (compacted and masked, each
    against the reference's, and against each other), the wave side of
    ``run_step_loop_equivalence`` (``run_queued`` against the
    reference's, and against the port's ``run_stepped``) and the wave
    leg of ``run_obs_equivalence``."""
    from harness.simulate import (
        WorkloadConfig, generate_workload, long_prompt_workload)
    from repro.data.tasks import arithmetic_suite
    workdir = Path(workdir)

    def scheduler():
        sched_dir = workdir / "scheduler"
        sched_dir.mkdir()
        ts, outs = check_scheduler_against_reference(
            generate_workload(WorkloadConfig(n_tasks=200, seed=0)),
            sched_dir)
        return (f"cache hits {ts.cache.hits}, modes "
                f"{dict(collections.Counter(o.trace.mode for o in outs))}"
                f"; port orchestrator head equal")

    def compaction():
        # sigma sends nearly every arithmetic task of the random tiny
        # zoo to the full arena, where compaction skips no row; forced
        # routes mix the modes
        notes = []
        for route, fn in (("sigma", None), ("forced", forced_route(200))):
            got = check_compaction_equivalence(arithmetic_suite(200, seed=0),
                                               route_fn=fn)
            notes.append(f"{route} routes: " + ", ".join(
                f"{k} {v:.3f}x" for k, v in got.items()))
        return "; ".join(notes)

    long = long_prompt_workload(200, 24, seed=0, duplicate_rate=0.15)

    def step_loop():
        fleets = paged_fleets()
        _, res = check_run_queued_against_reference(fleets, long, {})
        check_queued_against_stepped(fleets, long, chunk_tokens=8)
        return (f"batch sizes {len(res.batch_sizes)} x 8; queued head "
                f"= stepped head")

    def obs():
        got = check_queued_obs(paged_fleets(), long, workdir)
        return ", ".join(f"{k} {v}" for k, v in got.items())

    return [("scheduler (run_equivalence)", scheduler),
            ("compacted vs masked (engine compaction)", compaction),
            ("queued vs reference and vs stepped (step loop)", step_loop),
            ("obs (queued, lineage, attribution)", obs)]


def main(argv=None) -> int:
    """The 200-task legs, each once: ``engine`` (the engine gate),
    ``faults`` (crash recovery, the degraded fleet, spans), ``queued``
    (the queued wave engine and the scheduler), ``hetero`` (the
    heterogeneous fleets' legs, the default fleet's engine legs and its
    ``serve`` reports), ``moe`` (the gather-MoE ``mesh2d_zoo`` leg at
    megastep 1 and "auto", and the serve CLI's MoE/MLA fleet stepped and
    queued), ``vision`` (the serve CLI's llava fleet stepped and queued,
    and whisper's and llava's ``generate`` / ``generate_samples`` with
    frames and patches), ``mesh`` (the serving mesh's legs), or all
    seven when no group is named."""
    groups = list(argv if argv is not None else sys.argv[1:]) \
        or ["engine", "faults", "queued", "hetero", "moe", "vision",
            "mesh"]
    failed = 0
    with tempfile.TemporaryDirectory(prefix="acar-port-legs-") as d:
        legs = []
        if "engine" in groups:
            legs += engine_legs()
        if "faults" in groups:
            legs += fault_legs(d)
        if "queued" in groups:
            legs += queued_legs(d)
        if "hetero" in groups:
            legs += [(f"hetero {k}", v) for k, v in hetero_legs(d).items()]
            legs += list(default_fleet_legs().items())
            legs += list(serve_legs().items())
        if "moe" in groups:
            legs += list(mesh2d_legs().items())
            legs += list(moe_fleet_legs().items())
        if "vision" in groups:
            legs += list(vision_fleet_legs().items())
            legs += list(frontend_generate_legs().items())
        if "mesh" in groups:
            # ACAR_MESH_REFERENCE names a file that keeps the reference's
            # 200-task mesh results between runs
            import os
            legs += list(mesh_legs(
                cache=os.environ.get("ACAR_MESH_REFERENCE")).items())
        for name, leg in legs:
            t = time.perf_counter()
            sampling = "generate" in name     # no engine, no records
            try:
                note = leg()
                if sampling:
                    verdict = note
                else:
                    verdict = ("reports equal" if name.startswith("serve")
                               else "0 mismatches (sigma, mode, answer, "
                               "member, probe text, record hash); heads "
                               "equal") + (f"; {note}" if note else "")
            except AssertionError as e:
                failed += 1
                verdict = f"MISMATCH {str(e)[:2000]}"
            scale = "" if sampling else " 200 tasks,"
            print(f"{name}:{scale} wall "
                  f"{time.perf_counter() - t:.1f} s: {verdict}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
