"""Algorithm 1 in the port (``repro_torch.core.orchestrator``) held
against the reference's, record for record: each orchestrator runs over
its own package's backends (the orchestrator passes ``retrieval_sim``
only to its own ``SyntheticBackend``), and every task's record hash,
both chains' audits and their heads must be equal. Then the real-model
backend: ``TorchModelBackend`` against ``JaxModelBackend`` on the
reduced f32 ``paged_zoo`` models, generation for generation and through
the orchestrator."""
import dataclasses

import numpy as np
import pytest

from _torch_port import pallas_zoo, torch_zoo
from repro.configs import acar as j_acar
from repro.core import backends as j_back
from repro.core import orchestrator as j_orch
from repro.core import retrieval as j_ret
from repro.data import tasks as j_tasks
from repro.teamllm import artifacts as j_art
from repro_torch.configs import acar as t_acar
from repro_torch.core import backends as t_back
from repro_torch.core import orchestrator as t_orch
from repro_torch.core import retrieval as t_ret
from repro_torch.data import tasks as t_tasks
from repro_torch.teamllm import artifacts as t_art

N_TASKS = 200


def as_port(task):
    return t_tasks.Task(**dataclasses.asdict(task))


@pytest.fixture(scope="module")
def suite():
    """200 tasks drawn across the four benchmarks of ``paper_suite``."""
    tasks = j_tasks.paper_suite(0)
    idx = np.random.default_rng(19).choice(len(tasks), N_TASKS,
                                           replace=False)
    ref = [tasks[int(i)] for i in np.sort(idx)]
    return ref, [as_port(t) for t in ref]


def experience_stores():
    """Each package's ``ExperienceStore`` over the same 300 past
    experiences (another seed's suite)."""
    past = j_tasks.paper_suite(1)[:300]
    js, ts = j_ret.ExperienceStore(), t_ret.ExperienceStore()
    for i, t in enumerate(past):
        e = dict(task_text=t.text, answer=t.gold, correct=bool(i % 2),
                 benchmark=t.benchmark)
        js.add(j_ret.Experience(**e))
        ts.add(t_ret.Experience(**e))
    return js, ts


def compare_chains(jouts, touts, jpath, tpath) -> None:
    """Equal hashed views and record hashes task for task (the view
    first, so a mismatch names its field), both files auditing OK under
    their own package, and equal heads."""
    assert len(touts) == len(jouts)
    for j, t in zip(jouts, touts):
        assert t.trace.hashed_view() == j.trace.hashed_view(), \
            j.trace.task_id
        assert t.trace.record_hash() == j.trace.record_hash()
        assert (t.semantic_answer, t.correct, t.latency_ms) == \
            (j.semantic_answer, j.correct, j.latency_ms)
    ja = j_art.ArtifactStore(jpath).audit()
    ta = t_art.ArtifactStore(tpath).audit()
    assert ja["ok"] and ta["ok"] and ta["records"] == ja["records"]
    assert ta["head"] == ja["head"]


@pytest.mark.parametrize("variant", ["ACAR_U", "ACAR_UJ"])
def test_orchestrator_records_equal_over_paper_suite(tmp_path, suite,
                                                     variant):
    jtasks, ttasks = suite
    jexp, texp = experience_stores() if variant == "ACAR_UJ" \
        else (None, None)
    jb, tb = j_back.paper_backends(), t_back.paper_backends()
    jo = j_orch.ACAROrchestrator(
        getattr(j_acar, variant), jb["gemini-2.0-flash"], jb,
        store=j_art.ArtifactStore(tmp_path / "j.jsonl"),
        experience=jexp, run_id=variant)
    to = t_orch.ACAROrchestrator(
        getattr(t_acar, variant), tb["gemini-2.0-flash"], tb,
        store=t_art.ArtifactStore(tmp_path / "t.jsonl"),
        experience=texp, run_id=variant)
    jouts, touts = jo.run_suite(jtasks), to.run_suite(ttasks)
    compare_chains(jouts, touts, tmp_path / "j.jsonl", tmp_path / "t.jsonl")
    modes = {o.trace.mode for o in touts}
    assert modes == {"single_agent", "arena_lite", "full_arena"}
    if variant == "ACAR_UJ":
        assert all(o.trace.retrieval["hit"] for o in touts)
        sims = [o.trace.retrieval["similarity"] for o in touts]
        assert all(type(s) is float for s in sims)
    else:
        assert all(o.trace.retrieval is None for o in touts)


@pytest.mark.parametrize("members", [
    ["claude-sonnet-4"], ["gpt-4o"], ["gemini-2.0-flash"],
    ["claude-sonnet-4", "gpt-4o"],
    ["claude-sonnet-4", "gpt-4o", "gemini-2.0-flash"]],
    ids=["single-claude", "single-gpt", "single-gemini", "arena2",
         "arena3"])
def test_fixed_mode_records_equal_over_paper_suite(tmp_path, suite,
                                                   members):
    jtasks, ttasks = suite
    jouts = j_orch.run_fixed_mode(
        jtasks, j_back.paper_backends(), members,
        store=j_art.ArtifactStore(tmp_path / "j.jsonl"), seed=3)
    touts = t_orch.run_fixed_mode(
        ttasks, t_back.paper_backends(), members,
        store=t_art.ArtifactStore(tmp_path / "t.jsonl"), seed=3)
    compare_chains(jouts, touts, tmp_path / "j.jsonl", tmp_path / "t.jsonl")
    assert {len(o.trace.responses) for o in touts} == {len(members)}


def test_phase_functions_equal(suite):
    """The per-task phases the orchestrator composes, one by one."""
    jtasks, ttasks = suite
    jb, tb = j_back.paper_backends(), t_back.paper_backends()
    jexp, texp = experience_stores()
    jcfg, tcfg = j_acar.ACAR_UJ, t_acar.ACAR_UJ
    for jt, tt in zip(jtasks[:40], ttasks[:40]):
        jr = j_orch.retrieve_exemplar(jcfg, jexp, jt)
        tr = t_orch.retrieve_exemplar(tcfg, texp, tt)
        assert tr == jr
        prompt, sim = f"prompt {jt.task_id}", jr[1]
        jp = j_orch.probe_task(jcfg, jb["gemini-2.0-flash"], jt, prompt,
                               sim)
        tp = t_orch.probe_task(tcfg, tb["gemini-2.0-flash"], tt, prompt,
                               sim)
        assert [dataclasses.asdict(p) for p in tp[0]] == \
            [dataclasses.asdict(p) for p in jp[0]]
        assert [dataclasses.asdict(r) for r in tp[1]] == \
            [dataclasses.asdict(r) for r in jp[1]]
        assert tp[2] == jp[2]
        names = list(jb)
        je = j_orch.execute_ensemble(jcfg, jb, names, jt, prompt, sim)
        te = t_orch.execute_ensemble(tcfg, tb, names, tt, prompt, sim)
        assert [dataclasses.asdict(r) for r in te[0]] == \
            [dataclasses.asdict(r) for r in je[0]]
        assert te[2] == je[2]
        for mode in ("single_agent", "arena_lite", "full_arena"):
            k = {"single_agent": 0, "arena_lite": 2, "full_arena": 3}[mode]
            assert t_orch.aggregate(
                tt, mode, tp[0][0].answer, tp[0], tp[1], te[0][:k],
                te[1]) == j_orch.aggregate(
                jt, mode, jp[0][0].answer, jp[0], jp[1], je[0][:k], je[1])
        assert t_orch.task_cost_latency(tp[0], te[0], tp[2], te[2]) == \
            j_orch.task_cost_latency(jp[0], je[0], jp[2], je[2])


# ----------------------------------------------------------------------
# the real-model backend against the reference's
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_backends():
    """``JaxModelBackend`` over the reference's ``paged_zoo`` with
    ``use_pallas=True`` configs, and ``TorchModelBackend`` over the same
    params converted by ``from_jax_numpy`` (CPU tensors, so every
    kernel runs its plain version)."""
    from harness.simulate import paged_zoo
    from repro.serving import JaxModelBackend
    from repro_torch.serving import TorchModelBackend
    probe, ensemble = paged_zoo(seed=0)
    jprobe, jens = pallas_zoo(probe, ensemble)
    tprobe, tens = torch_zoo(probe, ensemble)
    jb = [JaxModelBackend(z.name, z.cfg, z.params) for z in [jprobe] + jens]
    tb = [TorchModelBackend(z.name, z.cfg, z.params)
          for z in [tprobe] + tens]
    return jb, tb


def test_torch_backend_prices_like_the_reference(model_backends):
    jb, tb = model_backends
    for j, t in zip(jb, tb):
        assert t._active_params == j._active_params > 0
        assert t.device.type == "cpu"


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_torch_backend_generates_like_the_reference(model_backends,
                                                    temperature):
    jb, tb = model_backends
    tasks = j_tasks.arithmetic_suite(4, seed=4)
    seen = set()
    for k, task in enumerate(tasks):
        idx, seed = ((0, 0), (2, 7))[k % 2]
        for j, t in zip(jb, tb):
            ref = j.generate(task, "p", temperature=temperature,
                             sample_idx=idx, seed=seed)
            got = t.generate(as_port(task), "p", temperature=temperature,
                             sample_idx=idx, seed=seed)
            assert (got.response, got.semantic_answer, got.cost,
                    got.score) == (ref.response, ref.semantic_answer,
                                   ref.cost, ref.score), \
                (task.task_id, j.name, idx, seed)
            assert type(got.cost) is float and got.latency_ms > 0
            seen.add(got.response)
    assert len(seen) > 1


def test_orchestrator_over_model_backends_equal(tmp_path, model_backends):
    """8 arithmetic tasks through each package's orchestrator over its
    own real-model backends (probe, two members and the probe's twin),
    the probes sampled at temperature 0.9."""
    jb, tb = model_backends
    tasks = j_tasks.arithmetic_suite(8, seed=0)
    cfg = dict(probe_temperature=0.9, seed=0)
    jo = j_orch.ACAROrchestrator(
        j_acar.ACARConfig(**cfg), jb[0], {b.name: b for b in jb[1:]},
        store=j_art.ArtifactStore(tmp_path / "j.jsonl"), run_id="models")
    to = t_orch.ACAROrchestrator(
        t_acar.ACARConfig(**cfg), tb[0], {b.name: b for b in tb[1:]},
        store=t_art.ArtifactStore(tmp_path / "t.jsonl"), run_id="models")
    jouts = jo.run_suite(tasks)
    touts = to.run_suite([as_port(t) for t in tasks])
    for j, t in zip(jouts, touts):
        assert t.trace.hashed_view() == j.trace.hashed_view()
        assert t.trace.record_hash() == j.trace.record_hash()
    ja = j_art.ArtifactStore(tmp_path / "j.jsonl").audit()
    ta = t_art.ArtifactStore(tmp_path / "t.jsonl").audit()
    assert ja["ok"] and ta["ok"] and ta["records"] == 8
    assert ta["head"] == ja["head"]
    assert {o.trace.mode for o in touts} != {"single_agent"}
