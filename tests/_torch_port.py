"""Shared helpers for the tests that hold the PyTorch port
(``repro_torch``) against the JAX reference (``repro``): the same
fixture models, converted once per params object, configs carried
across field by field, and the engine gates (ladder rung 4: equal
judge-visible outputs, record hashes and chain heads).

Run as a script, it serves the 200-task legs of the engine gate that
tier-1 runs at 16 tasks (stepped at megastep 1, 4 and "auto"; waves
paged and ``paged=False``) and prints each leg's wall and mismatch
counts::

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python tests/_torch_port.py
"""
from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import jax
import numpy as np

from repro_torch.configs.base import ModelConfig as TorchModelConfig
from repro_torch.data.tasks import Task as TorchTask
from repro_torch.models.params import from_jax_numpy
from repro_torch.serving import ZooModel as TorchZooModel


def torch_cfg(cfg) -> TorchModelConfig:
    """The port's ModelConfig with every field of the reference's."""
    return TorchModelConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})


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
    from harness.simulate import long_prompt_workload, paged_zoo
    probe, ensemble = paged_zoo(seed=0)
    jprobe, jens = pallas_zoo(probe, ensemble)
    tprobe, tens = torch_zoo(probe, ensemble)
    assert tens[2].params is tprobe.params
    tasks = long_prompt_workload(n_tasks, prompt_chars=prompt_chars,
                                 seed=0)
    return (jprobe, jens), (tprobe, tens), tasks


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


def forced_route(n_tasks: int):
    """A route_fn keyed by admission index that forces every mode:
    single, arena-lite and full-arena rows in a fixed shuffle."""
    modes = np.random.default_rng(0x45A).permutation(
        np.resize(np.asarray([0, 0, 1, 2], np.int32), n_tasks))

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
                                      ensemble_temperature=0.0) -> None:
    """Serve the stream through both packages' ``run_batch`` as
    ``waves`` consecutive waves on one engine (later waves hit the
    prompt prefix cache) with the same knobs and forced routes; require
    zero mismatches in sigma, mode, final answer, member answers and
    probe texts, equal compaction and paged-KV accounting, and equal
    record hashes and chain heads over the waves."""
    from repro.configs.acar import ACARConfig as JACARConfig
    from repro.serving import BatchedACAREngine as JEngine
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine

    (jprobe, jens), (tprobe, tens), tasks = fleets
    route = forced_route(len(tasks))
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
            (ensemble_temperature <= 0.0)
    elif paged is False:
        assert not tkv


def check_run_stepped_against_reference(fleets, megastep) -> None:
    """Serve the stream through both packages' ``run_stepped`` with the
    same knobs and require zero mismatches in sigma, mode, final
    answer, member answers and probe texts, equal prefill-chunk, tick
    and page accounting, and equal record hashes and chain heads."""
    from repro.configs.acar import ACARConfig as JACARConfig
    from repro.serving import BatchedACAREngine as JEngine
    from repro.serving import MicroBatchPolicy as JPolicy
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy

    (jprobe, jens), (tprobe, tens), tasks = fleets
    policy = dict(max_batch_size=8, max_batch_tokens=1 << 20)
    jeng = JEngine(JACARConfig(probe_temperature=0.9, seed=0), jprobe,
                   jens, max_new_tokens=6)
    jres = jeng.run_stepped(tasks, JPolicy(**policy), chunk_tokens=8,
                            megastep=megastep)
    teng = BatchedACAREngine(ACARConfig(probe_temperature=0.9, seed=0),
                             tprobe, tens, max_new_tokens=6, device="cpu")
    tres = teng.run_stepped([torch_task(t) for t in tasks],
                            MicroBatchPolicy(**policy), chunk_tokens=8,
                            megastep=megastep)
    mism = _mismatches(jres, tres, len(tasks))
    assert all(not v for v in mism.values()), mism
    check_records_against_reference(
        f"stepped-{megastep}", [m.name for m in jens],
        [(tasks, jres, tres)])
    # the stream exercises every route and the twin's page reuse
    assert set(tres.modes.tolist()) >= {1, 2}
    assert tres.step.prefill_chunks == jres.step.prefill_chunks
    assert tres.step.ticks == jres.step.ticks
    assert tres.step.decode_tokens == jres.step.decode_tokens
    jkv, tkv = jeng.kv_stats()[jprobe.name], teng.kv_stats()[tprobe.name]
    assert tkv.pages_highwater == jkv.pages_highwater
    assert tkv.prefill_tokens_reused_probe == \
        jkv.prefill_tokens_reused_probe > 0
    assert tkv.prefill_tokens_reused_prefix == \
        jkv.prefill_tokens_reused_prefix
    assert tkv.cow_forks == jkv.cow_forks


def main() -> int:
    """The 200-task legs of the engine gate, each once."""
    legs = [("stepped megastep 1", "stepped", 1),
            ("stepped megastep 4", "stepped", 4),
            ('stepped megastep "auto"', "stepped", "auto"),
            ("wave paged", "wave", None),
            ("wave paged=False", "wave", False)]
    # the prompt lengths of tier-1's legs: 24 characters stepped, 21
    # (a tail page off the page grid, COW-forked per sample) in waves
    fleets = {"stepped": engine_fleets(n_tasks=200),
              "wave": engine_fleets(prompt_chars=21, n_tasks=200)}
    failed = 0
    for name, kind, knob in legs:
        t = time.perf_counter()
        try:
            if kind == "stepped":
                check_run_stepped_against_reference(fleets[kind],
                                                    megastep=knob)
            else:
                # waves of 8 tasks, as tier-1's two waves of 16 tasks
                check_run_batch_against_reference(fleets[kind], knob,
                                                  waves=25)
            verdict = "0 mismatches (sigma, mode, answer, member, " \
                "probe text, record hash); chains audit OK; heads equal"
        except AssertionError as e:
            failed += 1
            verdict = f"MISMATCH {str(e)[:2000]}"
        print(f"{name}: 200 tasks, wall {time.perf_counter() - t:.1f} s: "
              f"{verdict}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
