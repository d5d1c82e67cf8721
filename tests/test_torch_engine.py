"""The port's stepped ACAR engine against the reference's, end to end on
the CPU at megastep 1 (``test_torch_engine_megastep.py`` runs megastep
4), plus the host-side pieces it is built from.

Both engines serve the same 16-task ``long_prompt_workload`` stream
through ``run_stepped`` with the same knobs (``chunk_tokens=8``,
``probe_temperature=0.9``, ``max_new_tokens=6``) over the same
``paged_zoo`` fleet: the reference on ``use_pallas=True`` configs, the
port on params converted by ``from_jax_numpy`` (once per params
object, so the probe twin shares the probe's pages). Sigma, modes,
final answers, member answers and probe texts must agree with zero
mismatches, and so must the prefill-chunk and tick counts and the
probe server's page high-water; each package's results, turned into
TraceRecords through its own ``teamllm``, must give equal record
hashes and chains with byte-identical heads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    check_run_stepped_against_reference, engine_fleets, torch_task)
from repro.core.sigma import majority_vote_batch as j_majority
from repro.core.sigma import route_batch as j_route
from repro.core.sigma import sigma as j_sigma
from repro.core.sigma import sigma_batch as j_sigma_batch
from repro.serving.engine import judge_batch as jjudge
from repro_torch.configs import ACARConfig
from repro_torch.core.sigma import majority_vote_batch as t_majority
from repro_torch.core.sigma import route_batch as t_route
from repro_torch.core.sigma import sigma as t_sigma
from repro_torch.core.sigma import sigma_batch as t_sigma_batch
from repro_torch.serving import (
    BatchedACAREngine, PagePool, PageAccountingError,
    PoolExhausted, StepPlanner, intern_answers)
from repro_torch.serving.engine import judge_batch as tjudge


@pytest.fixture(scope="module")
def fleets():
    return engine_fleets()


def test_run_stepped_matches_reference(fleets):
    check_run_stepped_against_reference(fleets, megastep=1)


def test_run_stepped_rejects_unported_options(fleets):
    _, (tprobe, tens), tasks = fleets
    eng = BatchedACAREngine(ACARConfig(), tprobe, tens, device="cpu")
    # faults, journal_path, tracer and the sharded loop are ported
    # (tests/test_torch_faults.py, test_torch_recovery.py,
    # test_torch_tracing.py, test_torch_engine_sharded.py); a mesh needs
    # its logical devices first, and model_shards needs data_shards
    from repro_torch.launch.mesh import clear_forced_devices
    clear_forced_devices()
    with pytest.raises(RuntimeError, match="force_device_count"):
        eng.run_stepped([torch_task(tasks[0])], data_shards=2)
    with pytest.raises(ValueError, match="data_shards"):
        eng.run_stepped([torch_task(tasks[0])], model_shards=2)


# ----------------------------------------------------------------------
# host-side pieces
# ----------------------------------------------------------------------
def _random_ids(seed, b, n, k):
    return np.random.default_rng(seed).integers(0, k, size=(b, n)).astype(
        np.int32)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sigma_route_majority_match_reference(k):
    ids = _random_ids(k, 64, 3, k)
    np.testing.assert_array_equal(
        t_sigma_batch(torch.from_numpy(ids)).numpy(),
        np.asarray(j_sigma_batch(jnp.asarray(ids))))
    sig = t_sigma_batch(torch.from_numpy(ids))
    np.testing.assert_array_equal(
        t_route(sig).numpy(), np.asarray(j_route(jnp.asarray(sig.numpy()))))
    np.testing.assert_array_equal(
        t_majority(torch.from_numpy(ids)).numpy(),
        np.asarray(j_majority(jnp.asarray(ids))))
    assert t_sigma(["a", "b", "a"]) == j_sigma(["a", "b", "a"])


@pytest.mark.parametrize("seed", [0, 1])
def test_judge_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    members = rng.integers(-1, 4, size=(128, 3)).astype(np.int32)
    probe = rng.integers(0, 4, size=128).astype(np.int32)
    modes = rng.integers(0, 3, size=128).astype(np.int32)
    np.testing.assert_array_equal(
        tjudge(torch.from_numpy(members), torch.from_numpy(probe),
               torch.from_numpy(modes)).numpy(),
        np.asarray(jjudge(jnp.asarray(members), jnp.asarray(probe),
                          jnp.asarray(modes))))


def test_intern_answers_threads_one_namespace():
    table = {}
    a = intern_answers(["x", "y", "x"], table)
    b = intern_answers(["y", "z"], table)
    assert a.tolist() == [0, 1, 0] and b.tolist() == [1, 2]


def test_page_pool_accounting():
    pool = PagePool(6, 8)
    a = pool.alloc(4)
    assert a.tolist() == [0, 1, 2, 3] and pool.highwater == 4
    pool.retain(a[:2])
    pool.release(a)
    assert pool.free_pages == 4 and pool.refcount(0) == 1
    with pytest.raises(PoolExhausted):
        pool.alloc(5)
    assert pool.free_pages == 4
    pool.release(a[:2])
    with pytest.raises(PageAccountingError):
        pool.release(a[:1])
    # LIFO: the most recently freed page is handed out first
    assert pool.alloc(1).tolist() == [1]


def test_step_planner_policy():
    p = StepPlanner(chunk_tokens=8, max_active_rows=4, megastep=4)
    assert p.chunk_span(16, 21) == 5 and p.chunk_count(21) == 3
    assert [p.decode_bucket(n) for n in (1, 3, 5, 8)] == [1, 4, 8, 8]
    assert p.may_admit(3, 10, 4, 6) and not p.may_admit(4, 10, 0, 1)
    assert not p.may_admit(0, 10, 5, 6)
    with pytest.raises(ValueError):
        StepPlanner(megastep=0)
