"""Rung 4 on the serving mesh: the port's ``run_stepped(data_shards=,
model_shards=)`` against the reference's same legs, and against the
port's own single-device run.

The reference's mesh legs need forced host devices, which jax fixes at
its first init, so they run once per module in a subprocess
(``_torch_port.reference_mesh_json``); the port's run on a CPU mesh of
four logical devices (``launch.mesh.force_device_count(4, "cpu")``).
The reference serves its harness's own fleets (``use_pallas`` off, as
its mesh legs run them). Like against like: the port's data=4 leg is held to the reference's
data=4 leg on ``paged_zoo`` (``tests/test_sharded_serving.py``'s
12-task stream, chunk 7), its (2, 2) leg to the reference's (2, 2) leg
on ``mesh2d_zoo`` (12 tasks at ``run_mesh2d_equivalence``'s knobs):
sigma, modes, answers, member answers, probe texts, record hashes,
chain heads, step accounting and placements.
"""
import numpy as np
import pytest

import _torch_port as tp

LEGS = {
    "paged data4": dict(fleet="paged", stream=("sharded", 12),
                        knobs=dict(max_new_tokens=4, chunk_tokens=7,
                                   batch_size=4),
                        run=dict(data_shards=4)),
    "mesh2d 2x2": dict(fleet="mesh2d", stream=("long", 12),
                       knobs=dict(max_new_tokens=6, chunk_tokens=4,
                                  batch_size=8),
                       run=dict(data_shards=2, model_shards=2)),
}
# the port's single-device runs of the same streams, and data=1
PORT_LEGS = dict(LEGS, **{
    "paged single": dict(LEGS["paged data4"], run={}),
    "paged data1": dict(LEGS["paged data4"], run=dict(data_shards=1)),
    "mesh2d single": dict(LEGS["mesh2d 2x2"], run={}),
    "mesh2d data4": dict(LEGS["mesh2d 2x2"], run=dict(data_shards=4)),
})


@pytest.fixture(scope="module")
def ref():
    return tp.reference_mesh_json(LEGS)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from repro_torch.launch import mesh
    try:
        with tp.one_torch_thread():
            yield tp.run_mesh_legs("port", PORT_LEGS,
                                   tmp_path_factory.mktemp("mesh"))
    finally:
        mesh.clear_forced_devices()


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_mesh_leg_equals_the_references_same_leg(leg, ref, port):
    eng, res = port[leg]
    names = [m.name for m in eng.ensemble]
    tp.check_mesh_leg(leg, LEGS[leg], ref[leg], res, names)
    placed = tp.result_json(res)["placements"]
    assert sum(placed) >= len(res.sigma)
    assert sum(1 for p in placed if p) >= 2


@pytest.mark.parametrize("leg,single", [
    ("paged data4", "paged single"), ("paged data1", "paged single"),
    ("mesh2d 2x2", "mesh2d single"), ("mesh2d data4", "mesh2d single")])
def test_mesh_leg_equals_the_ports_single_device_run(leg, single, port):
    eng, res = port[leg]
    names = [m.name for m in eng.ensemble]
    tasks = tp.mesh_stream(PORT_LEGS[leg]["stream"])
    tp.check_port_runs_equal(leg, tasks, port[single][1], res, names)
    np.testing.assert_array_equal(res.sigma, port[single][1].sigma)


@pytest.mark.parametrize("leg", ["paged data4", "mesh2d 2x2"])
def test_sharded_runner_pools_leak_no_pages(leg, port):
    """The runner on its own (as ``tests/test_sharded_serving.py``
    drives the reference's): the same answers as ``run_stepped``, and
    per shard nothing outlives the stream but the shard's scratch
    region and its prefix-cache retention."""
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import (
        AdmissionQueue, BatchedACAREngine, MicroBatchPolicy, ServingMesh,
        ShardedStepLoopRunner, StepPlanner)
    spec = LEGS[leg]
    knobs = spec["knobs"]
    probe, ens = tp._mesh_fleets(spec["fleet"])[1]
    eng = BatchedACAREngine(ACARConfig(probe_temperature=0.9, seed=0),
                            probe, ens,
                            max_new_tokens=knobs["max_new_tokens"],
                            device="cpu")
    queue = AdmissionQueue(MicroBatchPolicy(
        max_batch_size=knobs["batch_size"], max_batch_tokens=1 << 20))
    tasks = tp.mesh_stream(spec["stream"])
    for t in tasks:
        queue.submit(tp.torch_task(t))
    smesh = ServingMesh(data=spec["run"]["data_shards"],
                        model=spec["run"].get("model_shards", 1))
    runner = ShardedStepLoopRunner(
        eng, queue, StepPlanner(chunk_tokens=knobs["chunk_tokens"],
                                max_active_rows=knobs["batch_size"]),
        smesh)
    with tp.one_torch_thread():
        runner.run()
    smesh.close()
    rows = [runner.done_rows[i] for i in range(len(tasks))]
    assert [r.final_answer for r in rows] == port[leg][1].final_answers
    for srv in runner._sharded.values():
        assert srv.pages is not None
        for sv in srv.shards:
            cache = sum(e.pages_held for e in sv._prefix.values())
            assert sv.pool.pages_in_use == sv._scratch.size + cache, (
                sv.stats.model, sv.index)
        agg = srv.aggregate_stats()
        assert agg.pool_pages == sum(sv.stats.pool_pages
                                     for sv in srv.shards)


def test_model_shards_needs_data_shards():
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy
    _, (probe, ens) = tp.paged_fleets()
    eng = BatchedACAREngine(ACARConfig(), probe, ens, device="cpu")
    with pytest.raises(ValueError, match="data_shards"):
        eng.run_stepped([], MicroBatchPolicy(), model_shards=2)
