"""Shared helpers for the tests that hold the PyTorch port
(``repro_torch``) against the JAX reference (``repro``): the same
fixture models, converted once per params object, and configs carried
across field by field."""
from __future__ import annotations

import dataclasses

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


def engine_fleets():
    """The reference's and the port's ``paged_zoo`` fleets and the
    16-task long-prompt stream the engine tests serve."""
    from harness.simulate import long_prompt_workload, paged_zoo
    probe, ensemble = paged_zoo(seed=0)
    jprobe, jens = pallas_zoo(probe, ensemble)
    tprobe, tens = torch_zoo(probe, ensemble)
    assert tens[2].params is tprobe.params
    tasks = long_prompt_workload(16, prompt_chars=24, seed=0)
    return (jprobe, jens), (tprobe, tens), tasks


def check_run_stepped_against_reference(fleets, megastep) -> None:
    """Serve the stream through both packages' ``run_stepped`` with the
    same knobs and require zero mismatches in sigma, mode, final
    answer, member answers and probe texts, and equal prefill-chunk,
    tick and page accounting."""
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
    n = len(tasks)
    mism = {
        "sigma": [i for i in range(n) if jres.sigma[i] != tres.sigma[i]],
        "mode": [i for i in range(n) if jres.modes[i] != tres.modes[i]],
        "answer": [i for i in range(n)
                   if jres.final_answers[i] != tres.final_answers[i]],
        "member": [i for i in range(n)
                   if jres.member_answers[i] != tres.member_answers[i]],
        "probe_text": [i for i in range(n)
                       if jres.probe_texts[i] != tres.probe_texts[i]],
    }
    assert all(not v for v in mism.values()), mism
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
