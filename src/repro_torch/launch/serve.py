"""ACAR serving entry point over the port's models.

The port of ``repro/launch/serve.py::serve``: a task stream goes
through the batched engine — one lockstep wave (``run_batch``, the
default) or the step-level loop (``step_loop=True`` or ``megastep > 1``:
``run_stepped``) — and ``serve`` reports accuracy, the routing
distribution, ensemble calls saved and the compaction savings. The
fleet's models are given (``ZooModel``s with params on ``device``), or
restored from npz checkpoints by ``build_zoo`` (written by either
package's trainer). ``build_zoo``'s training branch and ``main`` raise
``NotImplementedError``: the reference's default ensemble holds
recurrentgemma-2b, whose serving path is not ported yet.

Fleet members are registry arch names, optionally with a page-layout
variant suffix (``parse_member``): ``arch:quant`` serves from
int8-quantised KV (pages, or a contiguous int8 cache in the wave with
``paged=False``), ``arch:swaN`` an N-token sliding window (not ported
yet).

    from repro_torch.launch.serve import serve
    report = serve(tasks, probe, ensemble, ACARConfig(), device="cuda")
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs.acar import ACARConfig
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.extract import extract
from repro_torch.core.sigma import MODE_NAMES
from repro_torch.data.tasks import Task
from repro_torch.launch.train import reduced_for_data
from repro_torch.models import params as params_lib
from repro_torch.models.transformer import resolve_layout
from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy, ZooModel


def parse_member(spec: str):
    """``arch[:quant|:swaN]`` -> (base arch, cfg variant applier).

    The variant changes the member's serving cache layout only (int8
    KV / ring pages); training always runs on the base arch."""
    arch, _, var = spec.partition(":")
    if arch not in ARCH_IDS:
        raise SystemExit(
            f"unknown arch {arch!r} (choose from {sorted(ARCH_IDS)})")
    if not var:
        return arch, lambda cfg: cfg
    if var == "quant":
        return arch, lambda cfg: cfg.replace(kv_quant=True)
    if var.startswith("swa"):
        window = int(var[3:] or 16)
        return arch, lambda cfg: cfg.replace(window=window)
    raise SystemExit(
        f"unknown member variant {spec!r} "
        "(use arch, arch:quant, or arch:swaN)")


def build_zoo(archs: Sequence[str], train_steps: int, seed: int = 0,
              ckpts: Optional[Dict[str, str]] = None,
              verbose: bool = True,
              device: str = "cuda") -> List[ZooModel]:
    """Restore reduced arithmetic models for each member spec (``arch``
    or ``arch:variant``) from ``ckpts[spec]`` onto ``device``. Training
    a member without a checkpoint is not ported yet and raises."""
    zoo = []
    for i, spec in enumerate(archs):
        arch, variant = parse_member(spec)
        cfg = variant(reduced_for_data(arch, "arithmetic"))
        if not (ckpts and spec in ckpts):
            raise NotImplementedError(
                f"build_zoo: training {spec!r} ({train_steps} steps) "
                "is not ported yet; pass a checkpoint in ckpts")
        template = params_lib.init_params(cfg, seed + i, device=device)
        prm = restore_checkpoint(ckpts[spec], template)
        if verbose:
            print(f"-- restored {spec} from {ckpts[spec]}")
        zoo.append(ZooModel(name=spec, cfg=cfg, params=prm))
    return zoo


def main(argv=None):
    raise NotImplementedError(
        "repro_torch.launch.serve.main: the default ensemble holds "
        "recurrentgemma-2b, whose serving path is not ported yet")


def serve(tasks: Sequence[Task], probe: ZooModel,
          ensemble: Sequence[ZooModel], acfg: ACARConfig,
          verbose: bool = True,
          scheduler: bool = False,
          step_loop: bool = False,
          batch_size: int = 8,
          data_shards: Optional[int] = None,
          megastep: int = 1,
          trace_path: Optional[str] = None,
          lineage_task: Optional[str] = None,
          device: str = "cuda") -> dict:
    """Serve ``tasks`` through the batched engine on ``device``. By
    default the whole stream runs as one wave (``run_batch``); with
    ``step_loop=True`` or ``megastep > 1`` it runs the step-level loop
    (streaming admission, chunked prefill, mixed decode ticks; needs a
    paged-capable probe) with micro-batches of at most ``batch_size``
    rows and up to ``megastep`` decode ticks per launch. The queued
    wave engine (``scheduler=True``), the sharded loop
    (``data_shards``) and span tracing (``trace_path``,
    ``lineage_task``) are not ported yet and raise
    ``NotImplementedError``. Returns the report dict of the
    reference's ``serve``."""
    if trace_path is not None or lineage_task is not None:
        raise NotImplementedError(
            "serve(trace_path/lineage_task=...): span tracing is not "
            "ported yet")
    stepped = step_loop or data_shards is not None or megastep > 1
    if scheduler and not stepped:
        raise NotImplementedError(
            "serve(scheduler=True): run_queued is not ported yet")
    engine = BatchedACAREngine(acfg, probe, ensemble, device=device)
    if verbose:
        layouts = {m.name: (resolve_layout(m.cfg) or "dense*")
                   for m in [probe] + list(ensemble)}
        print("fleet layouts     : " + ", ".join(
            f"{n}={l}" for n, l in layouts.items()))
    if stepped:
        res = engine.run_stepped(
            list(tasks), MicroBatchPolicy(max_batch_size=batch_size),
            data_shards=data_shards, megastep=megastep)
        scheduler = True          # report the queued-shape extras
    else:
        res = engine.run_batch(list(tasks))
    correct = sum(
        1 for t, a in zip(tasks, res.final_answers)
        if extract(a, t.kind) == t.gold or a == t.gold)
    dist = collections.Counter(MODE_NAMES[m] for m in res.modes)
    out = {
        "accuracy": correct / len(tasks),
        "mode_distribution": dict(dist),
        "ensemble_calls_saved": res.ensemble_calls_saved,
        "wall_ms": res.wall_ms,
        "sigma_mean": float(res.sigma.mean()),
    }
    cs = res.compaction
    if cs is not None:
        out["ensemble_decode_tokens"] = cs.ensemble_decode_tokens
        out["ensemble_decode_tokens_saved"] = \
            cs.ensemble_decode_tokens_saved
        out["ensemble_decode_token_reduction"] = \
            cs.ensemble_decode_token_reduction
        out["probe_prefill_reduction"] = cs.probe_prefill_reduction
    if scheduler:
        out["batch_sizes"] = res.batch_sizes
    if verbose:
        print(f"served {len(tasks)} tasks in {res.wall_ms:.0f} ms")
        print(f"accuracy          : {out['accuracy']:.3f}")
        print(f"mode distribution : {out['mode_distribution']}")
        print(f"calls saved       : {out['ensemble_calls_saved']} "
              f"of {3 * len(tasks)}")
        if cs is not None:
            print(f"compaction        : "
                  f"{cs.ensemble_decode_tokens} ensemble decode tokens "
                  f"({cs.ensemble_decode_tokens_saved} saved, "
                  f"{out['ensemble_decode_token_reduction']:.2f}x), "
                  f"probe prefill "
                  f"{out['probe_prefill_reduction']:.2f}x fewer tokens")
        if scheduler:
            print(f"micro-batches     : {res.batch_sizes}")
            if getattr(res, "step", None) is not None:
                print(f"step loop         : {res.step.ticks} ticks, "
                      f"{res.step.invocations} program launches, "
                      f"{res.step.prefill_chunks} prefill chunks")
            print(res.metrics.render())
    return out
