"""The port's fault injection (``repro_torch.serving.faults`` and the
stepped engine's fault sites) against the reference's on the CPU.

The machinery first: the same ``FaultPlan.generate`` seeds give equal
plans, ``FaultSpec`` rejects the same coordinates with the same
messages, and an injector fed one call sequence fires the same specs
in the same order. Then the stepped engine at ``tests/test_faults.py``'s
scale (``paged_zoo``, long prompts of 20 characters, batch 4, 4 new
tokens, chunk 7), both packages under the same plan: an admission-time
pool exhaustion that requeues rows, the harness's degraded-fleet plan
on one device (a launch retry and NaN quarantines of both arena-lite
members), an SLO deadline that aborts every row, and three generated
plans. Each must give equal results, record hashes, chain heads and
fault-event lists (``_torch_port.check_served_equal``), and leak no
page.
"""
import dataclasses

import numpy as np
import pytest

from _torch_port import (
    assert_no_leaks, check_degraded, check_records_against_reference,
    check_served_equal, fault_plans, one_torch_thread, paged_fleets,
    stepped_pair, stream)
from repro.serving import faults as jfaults
from repro_torch.serving import faults as tfaults
from repro_torch.serving.metrics import (
    FAULTS_INJECTED, ROW_DEADLINE_ABORTS, STEP_REQUEUES)

MODELS = ("m1", "m2", "m3")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


# ----------------------------------------------------------------------
# plans and the injector
# ----------------------------------------------------------------------
def _plan_dict(plan):
    return dataclasses.asdict(plan)


def test_sites_match_reference():
    assert tfaults.SITES == jfaults.SITES


@pytest.mark.parametrize("kw", [
    dict(tick=0, site="not-a-site"), dict(tick=-1, site="crash"),
    dict(tick=0, site="crash", count=0), dict(tick=-3, site="nope"),
])
def test_fault_spec_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultSpec(**kw)
    with pytest.raises(ValueError) as got:
        tfaults.FaultSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 7, 11, 12345])
@pytest.mark.parametrize("topology", [
    dict(), dict(models=MODELS), dict(models=MODELS, shards=4),
    dict(models=MODELS[:1], shards=2, n_faults=16, max_tick=20),
    dict(models=MODELS, sites=jfaults.SITES, slo_deadline=9),
])
def test_generate_matches_reference(seed, topology):
    assert _plan_dict(tfaults.FaultPlan.generate(seed, **topology)) == \
        _plan_dict(jfaults.FaultPlan.generate(seed, **topology))


@pytest.mark.parametrize("torn", [False, True])
def test_crash_at_matches_reference(torn):
    assert _plan_dict(tfaults.FaultPlan.crash_at(5, torn=torn)) == \
        _plan_dict(jfaults.FaultPlan.crash_at(5, torn=torn))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_injector_firing_sequence_matches_reference(seed):
    """Both injectors over one generated plan and one seeded call
    sequence: every call returns the same spec (or none), and the
    fired lists and ``exhausted`` agree."""
    kw = dict(n_faults=12, max_tick=30, models=MODELS, shards=3,
              sites=jfaults.SITES)
    jinj = jfaults.FaultInjector(jfaults.FaultPlan.generate(seed, **kw))
    tinj = tfaults.FaultInjector(tfaults.FaultPlan.generate(seed, **kw))
    rng = np.random.default_rng(seed)
    for tick in sorted(rng.integers(0, 40, size=80).tolist()):
        site = jfaults.SITES[int(rng.integers(len(jfaults.SITES)))]
        model = MODELS[int(rng.integers(3))] if rng.random() < 0.7 \
            else None
        shard = int(rng.integers(3)) if rng.random() < 0.5 else None
        want = jinj.fire(site, tick, model=model, shard=shard)
        got = tinj.fire(site, tick, model=model, shard=shard)
        assert (got is None) == (want is None)
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert tinj.exhausted == jinj.exhausted
    assert tinj.fired == jinj.fired and tinj.fired


# ----------------------------------------------------------------------
# the stepped engine under injected faults
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleets():
    return paged_fleets()


def _names(fleets):
    return [m.name for m in fleets[0][1]]


def test_requeue_under_admit_alloc_matches_reference(fleets):
    """Injected admission-time pool exhaustion requeues rows with
    their admission indices: equal to the reference, and the port's
    outputs equal to its fault-free run."""
    tasks = stream(8, seed=1)
    ref, port = stepped_pair(fleets, tasks)
    jplan, tplan = fault_plans(dict(tick=1, site="admit_alloc", count=2))
    _, jres = ref(faults=jplan)
    teng, tres = port(faults=tplan)
    check_served_equal("requeue", tasks, jres, tres, _names(fleets))
    assert tres.step.requeues >= 1
    assert tres.metrics.get(STEP_REQUEUES) == \
        jres.metrics.get(STEP_REQUEUES) >= 1
    assert any(f["kind"] == "requeued" for f in tres.faults)
    _, base = port()
    check_records_against_reference("requeue-vs-fault-free",
                                    _names(fleets), [(tasks, base, tres)])
    assert_no_leaks(teng)


def test_degraded_plan_matches_reference(fleets):
    """The harness's single-device degraded plan: equal results,
    records, heads, fault events and counters, replayed identically,
    two members quarantined, routes degraded, no leaks."""
    tasks = stream(10, seed=2)
    ref, port = stepped_pair(fleets, tasks)
    res = check_degraded(ref, port, tasks, _names(fleets))
    assert res.metrics.get(FAULTS_INJECTED, site="member_nan") == 2


def test_member_launch_retries_then_quarantines_matches_reference(fleets):
    """Launch failures past ``max_retries`` quarantine the member."""
    tasks = stream(8, seed=3)
    ref, port = stepped_pair(fleets, tasks)
    jplan, tplan = fault_plans(
        dict(tick=2, site="member_launch", model="m1", count=10),
        max_retries=2)
    _, jres = ref(faults=jplan)
    teng, tres = port(faults=tplan)
    check_served_equal("retries", tasks, jres, tres, _names(fleets))
    kinds = [f["kind"] for f in tres.faults]
    assert "member_retry" in kinds and "member_quarantined" in kinds
    assert tres.step.retries == 3
    assert all(a is not None for a in tres.final_answers)
    assert_no_leaks(teng)


def test_slo_deadline_abort_matches_reference(fleets):
    """A one-tick SLO deadline aborts every row: null answers, traced
    ``row_aborted`` events, equal records and heads."""
    tasks = stream(6, seed=4)
    ref, port = stepped_pair(fleets, tasks)
    jplan, tplan = fault_plans(slo_deadline=1)
    _, jres = ref(faults=jplan)
    teng, tres = port(faults=tplan)
    check_served_equal("slo", tasks, jres, tres, _names(fleets))
    assert tres.step.aborted == len(tasks)
    assert all(a is None for a in tres.final_answers)
    assert tres.metrics.get(ROW_DEADLINE_ABORTS) == len(tasks)
    assert sorted(f["admission"] for f in tres.faults
                  if f["kind"] == "row_aborted") == list(range(len(tasks)))
    assert_no_leaks(teng)


# seeds whose plans fire: a degraded route, a requeue, a launch retry
@pytest.mark.parametrize("seed", [2, 3, 90001])
def test_generated_plan_matches_reference(fleets, seed):
    """``FaultPlan.generate`` plans (the chaos property's): equal to
    the reference, every row answered or abort-traced, no leaks."""
    tasks = stream(6, seed=seed % 13, duplicate_rate=0.25)
    ref, port = stepped_pair(fleets, tasks)
    kw = dict(n_faults=3, max_tick=40, models=_names(fleets))
    _, jres = ref(faults=jfaults.FaultPlan.generate(seed, **kw))
    teng, tres = port(faults=tfaults.FaultPlan.generate(seed, **kw))
    check_served_equal(f"chaos-{seed}", tasks, jres, tres, _names(fleets))
    assert tres.faults
    aborted = {f["admission"] for f in tres.faults
               if f["kind"] == "row_aborted"}
    assert all(a is not None or i in aborted
               for i, a in enumerate(tres.final_answers))
    assert_no_leaks(teng)
