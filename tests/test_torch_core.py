"""The port's ACAR core beside the routing (``repro_torch.core``: judge,
retrieval, backends, attribution) and its task suites
(``repro_torch.data.tasks``) held against the reference's, value for
value: the suites task for task, embeddings bit for bit, experience
queries, the judge, every attribution function, and the calibrated
synthetic backends' generations."""
import dataclasses

import numpy as np
import pytest

from repro.core import attribution as j_attr
from repro.core import backends as j_back
from repro.core import judge as j_judge
from repro.core import retrieval as j_ret
from repro.data import tasks as j_tasks
from repro.teamllm import trace as j_trace
from repro_torch.core import attribution as t_attr
from repro_torch.core import backends as t_back
from repro_torch.core import judge as t_judge
from repro_torch.core import retrieval as t_ret
from repro_torch.data import tasks as t_tasks
from repro_torch.teamllm import trace as t_trace

PAPER = j_tasks.paper_suite(0)


def as_port(task):
    return t_tasks.Task(**dataclasses.asdict(task))


# ----------------------------------------------------------------------
# task suites
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_paper_suite_equal_task_for_task(seed):
    ref = PAPER if seed == 0 else j_tasks.paper_suite(seed)
    got = t_tasks.paper_suite(seed)
    assert len(got) == len(ref) == sum(t_tasks.PAPER_MIX.values())
    for a, b in zip(got, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t_tasks.BENCHMARKS == j_tasks.BENCHMARKS
    assert t_tasks.PAPER_MIX == j_tasks.PAPER_MIX
    assert t_tasks.BENCH_KIND == j_tasks.BENCH_KIND
    assert t_tasks.BENCH_DIFFICULTY == j_tasks.BENCH_DIFFICULTY
    assert t_tasks.BENCH_CONFUSION == j_tasks.BENCH_CONFUSION


@pytest.mark.parametrize("n,seed,max_operand", [(64, 0, 9), (200, 5, 99)])
def test_arithmetic_suite_equal_task_for_task(n, seed, max_operand):
    got = t_tasks.arithmetic_suite(n, seed, max_operand)
    ref = j_tasks.arithmetic_suite(n, seed, max_operand)
    assert [dataclasses.asdict(t) for t in got] == \
        [dataclasses.asdict(t) for t in ref]


def test_split_by_benchmark_equal():
    got = t_tasks.split_by_benchmark([as_port(t) for t in PAPER])
    ref = j_tasks.split_by_benchmark(PAPER)
    assert list(got) == list(ref)
    for k in ref:
        assert [t.task_id for t in got[k]] == [t.task_id for t in ref[k]]


# ----------------------------------------------------------------------
# retrieval
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dim", [512, 64])
def test_embed_text_bit_equal(dim):
    texts = [t.text for t in PAPER[::37]] + [
        "", "What is 2 + 2?", "ÉCOLE école 12 x_y", "a a a a b"]
    for text in texts:
        got, ref = t_ret.embed_text(text, dim), j_ret.embed_text(text, dim)
        assert got.dtype == ref.dtype == np.float32
        assert got.tobytes() == ref.tobytes(), text


def _stores(exps):
    js, ts = j_ret.ExperienceStore(), t_ret.ExperienceStore()
    for e in exps:
        js.add(j_ret.Experience(**e))
        ts.add(t_ret.Experience(**e))
    return js, ts


def test_experience_store_query_and_stats_equal():
    exps = [dict(task_text=t.text, answer=t.gold, correct=bool(i % 3),
                 benchmark=t.benchmark) for i, t in enumerate(PAPER[:300])]
    js, ts = _stores(exps)
    assert len(ts) == len(js) == 300
    queries = [t.text for t in PAPER[300:420]] + [PAPER[5].text]
    for q in queries:
        for top_k, thr in ((1, 0.0), (3, 0.0), (2, 0.2), (1, -1.0)):
            got, ref = ts.query(q, top_k, thr), js.query(q, top_k, thr)
            assert [(dataclasses.asdict(e), s) for e, s in got] == \
                [(dataclasses.asdict(e), s) for e, s in ref]
            assert all(type(s) is float for _, s in got)
    assert ts.similarity_stats(queries) == js.similarity_stats(queries)
    assert t_ret.ExperienceStore().query("x") == []


# ----------------------------------------------------------------------
# judge and attribution on seeded responses
# ----------------------------------------------------------------------
def seeded_responses(rng, n_models=3):
    answers = [str(a) for a in rng.integers(0, 3, size=n_models)]
    words = ["answer:", "x", "the", "7", "so"]
    return [dict(model=f"m{k}", answer=answers[k],
                 response=" ".join(rng.choice(words, size=int(
                     rng.integers(1, 6)))) + f" {answers[k]}",
                 cost=float(rng.random()),
                 score=float(rng.standard_normal()))
            for k in range(n_models)]


def both(resps):
    return ([j_trace.ModelResponse(**r) for r in resps],
            [t_trace.ModelResponse(**r) for r in resps])


@pytest.mark.parametrize("seed", range(3))
def test_judge_select_and_arena_verify_equal(seed):
    rng = np.random.default_rng(seed)
    for i in range(200):
        jr, tr = both(seeded_responses(rng, int(rng.integers(1, 5))))
        tid = f"task-{i}"
        probe = str(int(rng.integers(0, 4)))
        for pa in (None, probe):
            assert t_judge.judge_select(tr, tid, pa) == \
                j_judge.judge_select(jr, tid, pa)
        assert t_judge.judge_select(tr, tid, score_weight=0.0) == \
            j_judge.judge_select(jr, tid, score_weight=0.0)
        assert t_judge.arena_verify(probe, tr[:2], tid) == \
            j_judge.arena_verify(probe, jr[:2], tid)


@pytest.mark.parametrize("seed", range(3))
def test_attribution_functions_equal(seed):
    rng = np.random.default_rng(100 + seed)
    truth_j, truth_t, proxy_j, proxy_t = [], [], {}, {}
    for i in range(150):
        jr, tr = both(seeded_responses(rng))
        tid, gold = f"task-{i}", str(int(rng.integers(0, 3)))
        final = j_judge.judge_select(jr, tid)
        assert t_attr.coalition_accuracy(tr, tid, gold) == \
            j_attr.coalition_accuracy(jr, tid, gold)
        loo_t = t_attr.leave_one_out(tr, tid, gold)
        loo_j = j_attr.leave_one_out(jr, tid, gold)
        assert loo_t == loo_j
        assert t_attr.shapley(tr, tid, gold) == j_attr.shapley(jr, tid, gold)
        truth_t.append(loo_t)
        truth_j.append(loo_j)
        for name, args_t, args_j in (
                ("proxy_similarity", (tr, final), (jr, final)),
                ("proxy_entropy", (tr,), (jr,)),
                ("proxy_agreement", (tr,), (jr,))):
            got = getattr(t_attr, name)(*args_t)
            assert got == getattr(j_attr, name)(*args_j), name
            proxy_t.setdefault(name, []).append(got)
            proxy_j.setdefault(name, []).append(got)
    for name in proxy_t:
        got = t_attr.proxy_vs_truth_correlation(truth_t, proxy_t[name])
        assert got == j_attr.proxy_vs_truth_correlation(truth_j,
                                                        proxy_j[name])
        assert type(got) is float
    assert t_attr.proxy_vs_truth_correlation([], []) == 0.0
    assert t_attr.coalition_accuracy([], "t", "a") == 0.0


# ----------------------------------------------------------------------
# the calibrated synthetic backends
# ----------------------------------------------------------------------
def test_paper_models_equal():
    assert t_back.PAPER_MODELS.keys() == j_back.PAPER_MODELS.keys()
    for k in j_back.PAPER_MODELS:
        assert dataclasses.asdict(t_back.PAPER_MODELS[k]) == \
            dataclasses.asdict(j_back.PAPER_MODELS[k])
    for name in ("CODE_NONCE_P", "TRAP_BENCH_FACTOR",
                 "DEFAULT_RETRIEVAL_BETA", "JUDGE_SCORE_NOISE",
                 "RETRIEVAL_SIM0"):
        assert getattr(t_back, name) == getattr(j_back, name), name


@pytest.mark.parametrize("beta", [0.5, 1.25])
def test_synthetic_backends_generate_equal(beta):
    jb, tb = j_back.paper_backends(beta), t_back.paper_backends(beta)
    assert list(tb) == list(jb)
    rng = np.random.default_rng(int(beta * 100))
    tasks = [PAPER[int(i)] for i in rng.choice(len(PAPER), 120,
                                               replace=False)]
    for task in tasks:
        ptask = as_port(task)
        for name in jb:
            for temp, idx, seed, sim in ((0.0, 0, 0, None),
                                         (0.7, 2, 1, 0.167),
                                         (0.7, 1, 0, 0.9)):
                got = tb[name].generate(ptask, "p", temperature=temp,
                                        sample_idx=idx, seed=seed,
                                        retrieval_sim=sim)
                ref = jb[name].generate(task, "p", temperature=temp,
                                        sample_idx=idx, seed=seed,
                                        retrieval_sim=sim)
                assert dataclasses.asdict(got) == dataclasses.asdict(ref)
            assert tb[name].p_correct(ptask, 0.7, 0.3) == \
                jb[name].p_correct(task, 0.7, 0.3)
