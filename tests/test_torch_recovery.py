"""The port's write-ahead journal and crash recovery
(``repro_torch.serving.journal``, ``BatchedACAREngine.recover``)
against the reference's on the CPU.

The journal first: the same events appended in either package make
byte-identical files with equal heads, each package loads the other's
file to the same ``RecoveryState``, and a torn append kills the
process and recovers to the previous head in both. Then the reference
harness's single-device crash legs (``run_crash_recovery_equivalence``)
at ``tests/test_faults.py``'s scale: a journaled run killed at the
midpoint and at 3/4 of the uninterrupted run's ticks, and killed
mid-journal-append at 3/4. Both packages' journals load to equal states
in both loaders, both recover to equal results and restored rows, and
the recovered records and chain heads equal the reference's
uninterrupted run's. One uninterrupted run per package is shared by the
module.
"""
import dataclasses

import numpy as np
import pytest

from _torch_port import (
    check_crash_leg, check_served_equal, crash_ticks, journal_state,
    one_torch_thread, paged_fleets, stepped_pair, stream)
from repro.serving import faults as jfaults
from repro.serving.journal import StepJournal as JJournal
from repro_torch.serving import faults as tfaults
from repro_torch.serving.journal import StepJournal as TJournal


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _events(journal):
    journal.admit(0, "r-0", 1)
    journal.admit(1, "r-1", 2)
    journal.emit(3, "m1", [[0, 100, 1, 0, [5]], [1, 101, 1, 1, [6]]])
    journal.fault({"event": "fault", "kind": "member_retry",
                   "model": "m1", "tick": 4}, 4)
    journal.retire({"adm": 0, "task_id": "t0", "sigma": 0.5, "mode": 1,
                    "probe_texts": ["a"], "probe_answers": ["a"],
                    "member_answers": ["a", None, None],
                    "final_answer": "a", "aborted": None,
                    "timeline": [0, 1, 9]}, 9)


def test_journal_round_trip_matches_reference(tmp_path):
    jpath, tpath = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    jj, tj = JJournal(jpath), TJournal(tpath)
    _events(jj)
    _events(tj)
    assert tj.head == jj.head
    assert tpath.read_bytes() == jpath.read_bytes()
    want = journal_state(JJournal.load(jpath))
    assert journal_state(TJournal.load(tpath)) == want
    assert journal_state(TJournal.load(jpath)) == want
    assert journal_state(JJournal.load(tpath)) == want
    assert want["records"] == 5 and set(want["retired"]) == {0}
    assert want["admitted"] == {0, 1} and not want["torn_recovered"]


def test_torn_append_matches_reference(tmp_path):
    """A kill mid-append leaves the same torn prefix in both packages;
    either loader truncates it back to the previous head. (No append
    here is stamped at tick 0: the store takes a falsy wall time for
    "now", so only later appends make equal bytes.)"""
    paths, heads = {}, {}
    for name, faults, journal in (("ref", jfaults, JJournal),
                                  ("port", tfaults, TJournal)):
        p = paths[name] = tmp_path / f"{name}.jsonl"
        j = journal(p, injector=faults.FaultInjector(
            faults.FaultPlan.crash_at(3, torn=True)))
        j.admit(0, "r-0", 1)
        j.retire({"adm": 0, "final_answer": "a"}, 2)
        heads[name] = j.head
        with pytest.raises(faults.SimulatedCrash):
            j.admit(1, "r-1", 3)
        assert not p.read_text().endswith("\n")
    assert heads["port"] == heads["ref"]
    torn = paths["port"].read_bytes()
    assert torn == paths["ref"].read_bytes()
    # each loader truncates the torn tail of its own copy
    states = []
    for loader, name in ((JJournal.load, "ref"), (TJournal.load, "port")):
        p = tmp_path / f"torn-{name}.jsonl"
        p.write_bytes(torn)
        states.append(journal_state(loader(p)))
    assert states[0] == states[1]
    assert states[0]["torn_recovered"] and states[0]["records"] == 2
    assert states[0]["head"] == heads["ref"]


# ----------------------------------------------------------------------
# kill -> recover on the stepped engine
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    """The fleets, the stream, both packages' servers and one
    uninterrupted run each."""
    fleets = paged_fleets()
    tasks = stream(8, seed=5)
    ref, port = stepped_pair(fleets, tasks)
    names = [m.name for m in fleets[0][1]]
    _, jbase = ref()
    _, tbase = port()
    check_served_equal("uninterrupted", tasks, jbase, tbase, names)
    return tasks, ref, port, names, jbase, tbase


def _leg_tick(base, leg):
    mid, late = crash_ticks(base.step.ticks)
    return mid if leg == "kill@mid" else late


@pytest.mark.parametrize("leg", ["kill@mid", "kill@3/4", "torn@3/4"])
def test_crash_leg_recovers_like_reference(served, leg, tmp_path):
    tasks, ref, port, names, jbase, _ = served
    restored = check_crash_leg(ref, port, tasks, jbase, names, tmp_path,
                               _leg_tick(jbase, leg), leg.startswith("torn"))
    if leg == "kill@3/4":
        # the harness requires restored rows of the late kill leg only:
        # the midpoint may predate the first retirement, and the torn
        # leg dies at the first append at-or-after that instant of the
        # virtual clock, which comes earlier than the loop tick
        assert restored > 0


def test_recover_keeps_the_schedule_side_channel(served, tmp_path):
    """Restored rows carry their journaled timeline verbatim (the
    uninterrupted run's); re-executed rows step through real ticks;
    both as in the reference."""
    tasks, ref, port, names, jbase, tbase = served
    tick = crash_ticks(tbase.step.ticks)[1]
    jp = tmp_path / "journal.jsonl"
    with pytest.raises(tfaults.SimulatedCrash):
        port(journal_path=jp, faults=tfaults.FaultPlan.crash_at(tick))
    state = TJournal.load(jp)
    assert state.retired
    _, res = port(recover=jp)
    assert res.restored_rows == len(state.retired)
    for adm, rec in state.retired.items():
        assert res.step.timeline[adm] == tuple(rec["timeline"]) == \
            tbase.step.timeline[adm]
    reexec = [a for a in tbase.step.timeline if a not in state.retired]
    assert reexec
    for adm in reexec:
        arr, admitted, retired = res.step.timeline[adm]
        assert arr == tbase.step.timeline[adm][0]
        assert 0 <= admitted <= retired
    np.testing.assert_array_equal(res.sigma, tbase.sigma)
    assert res.final_answers == tbase.final_answers
    assert res.member_answers == tbase.member_answers
    assert res.probe_texts == tbase.probe_texts


def test_armed_journal_keeps_records(served, tmp_path):
    """Attaching a journal to a fault-free run moves nothing: equal
    results, records and heads to the untraced run, and a journal that
    retires every row with the reference's head."""
    tasks, ref, port, names, jbase, tbase = served
    jp, tp = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    _, jres = ref(journal_path=jp)
    _, tres = port(journal_path=tp)
    check_served_equal("journaled", tasks, jres, tres, names)
    check_served_equal("journaled-vs-plain", tasks, tbase, tres, names)
    state = journal_state(TJournal.load(tp))
    assert state == journal_state(JJournal.load(jp))
    assert sorted(state["retired"]) == list(range(len(tasks)))
    assert dataclasses.asdict(tres.step)["restored"] == 0
