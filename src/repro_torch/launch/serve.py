"""ACAR serving entry point over the port's models.

The port of ``repro/launch/serve.py::serve``: a task stream goes
through the batched engine — one lockstep wave (``run_batch``, the
default), micro-batches through the admission queue (``scheduler=True``
or a tracer: ``run_queued``) or the step-level loop (``step_loop=True``
or ``megastep > 1``: ``run_stepped``) — and ``serve`` reports accuracy,
the routing distribution, ensemble calls saved and the compaction
savings. The fleet's models are given (``ZooModel``s with params on
``device``), or built by ``build_zoo``: restored from npz checkpoints
(written by either package's trainer) or trained on arithmetic.
``main`` raises ``NotImplementedError``: the reference's default
ensemble holds recurrentgemma-2b, whose serving path is not ported
yet.

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
from repro_torch.launch.train import reduced_for_data, train
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
    """Train (or restore from ``ckpts[spec]``) reduced arithmetic
    models for each member spec (``arch`` or ``arch:variant``) on
    ``device``."""
    zoo = []
    for i, spec in enumerate(archs):
        arch, variant = parse_member(spec)
        cfg = variant(reduced_for_data(arch, "arithmetic"))
        if ckpts and spec in ckpts:
            template = params_lib.init_params(cfg, seed + i, device=device)
            prm = restore_checkpoint(ckpts[spec], template)
            if verbose:
                print(f"-- restored {spec} from {ckpts[spec]}")
        else:
            if verbose:
                print(f"-- training {spec} ({train_steps} steps)")
            _, prm, _ = train(arch=arch, data="arithmetic",
                              steps=train_steps, batch=64, seq=24,
                              lr=2e-3, seed=seed + i, verbose=False,
                              device=device)
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
    """Serve ``tasks`` through the batched engine on ``device``. With
    ``scheduler=True`` the stream flows through the admission queue and
    is served as micro-batches of at most ``batch_size`` (``run_queued``);
    with ``step_loop=True`` or ``megastep > 1`` it runs the step-level
    loop (streaming admission, chunked prefill, mixed decode ticks;
    needs a paged-capable probe) with up to ``megastep`` decode ticks
    per launch; otherwise the whole stream runs as one wave
    (``run_batch``). The sharded loop (``data_shards``) is not ported
    yet and raises ``NotImplementedError``.

    ``trace_path`` arms the deterministic span tracer and flushes the
    hash-chained span JSONL there; ``lineage_task`` (implies tracing)
    walks the PROV graph backwards from that task's final answer and
    reports the verified lineage. A traced stream runs the step loop
    when asked for, ``run_queued`` otherwise. Returns the report dict
    of the reference's ``serve``."""
    stepped = step_loop or data_shards is not None or megastep > 1
    tracer = None
    if trace_path is not None or lineage_task is not None:
        from repro_torch.serving.tracing import SpanTracer
        tracer = SpanTracer(trace_path)
    engine = BatchedACAREngine(acfg, probe, ensemble, device=device)
    if verbose:
        layouts = {m.name: (resolve_layout(m.cfg) or "dense*")
                   for m in [probe] + list(ensemble)}
        print("fleet layouts     : " + ", ".join(
            f"{n}={l}" for n, l in layouts.items()))
    if stepped:
        res = engine.run_stepped(
            list(tasks), MicroBatchPolicy(max_batch_size=batch_size),
            data_shards=data_shards, megastep=megastep,
            tracer=tracer)
        scheduler = True          # report the queued-shape extras
    elif scheduler or tracer is not None:
        res = engine.run_queued(
            list(tasks), MicroBatchPolicy(max_batch_size=batch_size),
            tracer=tracer)
        scheduler = True
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
    if tracer is not None and getattr(res, "spans", None) is not None:
        out["spans"] = len(res.spans)
        out["span_head"] = res.span_head
        if verbose:
            print(f"spans             : {len(res.spans)} "
                  f"(head {res.span_head[:16]}...)"
                  + (f" -> {trace_path}" if trace_path else ""))
        if lineage_task is not None:
            from repro_torch.teamllm.prov import lineage
            lin = lineage(res.spans, lineage_task)
            out["lineage_ok"] = lin["ok"]
            out["lineage_verified"] = lin["verified"]
            if verbose:
                print(f"lineage           : task {lineage_task} "
                      f"trace {lin['trace']} — "
                      f"{lin['verified']} span hashes verified, "
                      f"{'OK' if lin['ok'] else 'FAILED'}")
                for rec in lin["records"]:
                    if rec["kind"] == "entity":
                        print(f"  entity   {rec['id']}")
                    elif rec["kind"] == "wasDerivedFrom":
                        via = f" via {rec['via']}" if "via" in rec \
                            else ""
                        print(f"  derived  {rec['entity']} <- "
                              f"{rec['source']}{via}")
                    elif rec["kind"] == "wasGeneratedBy":
                        print(f"  genBy    {rec['entity']} <- "
                              f"{rec['activity']}")
                for f in lin["hash_failures"]:
                    print(f"  FAIL     {f}")
    return out
