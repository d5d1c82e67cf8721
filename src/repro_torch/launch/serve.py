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

Fleet members are registry arch names, optionally with a page-layout
variant suffix (``parse_member``): ``arch:quant`` serves from
int8-quantised KV (pages, or a contiguous int8 cache in the wave with
``paged=False``), ``arch:swaN`` an N-token sliding window (ring pages
in the stepped engine, a contiguous ring cache in the wave). The CLI
(``main``) trains the fleet's reduced models on arithmetic and serves
an arithmetic suite through it, on the card unless told otherwise; its
default ensemble is llama3-8b, deepseek-7b and recurrentgemma-2b
behind a smollm-135m probe, and ``--hetero-fleet`` the paper's
heterogeneous mix (a Mamba probe on recurrent-state lanes, an int8-KV
member, a sliding-window member on ring pages and a full-attention
llama3-8b). MoE members (mixtral-8x22b, deepseek-v2-236b with MLA)
serve over contiguous caches in every engine: their capacity dispatch
couples rows, so no page layout takes them. A vision member
(llava-next-mistral-7b) is served text only, as the reference's engine
serves it, over contiguous ring caches on the step loop's member
fallback. ``--shards N`` (``serve(data_shards=N)``) runs the step loop
on a data-sharded serving mesh (``serving/mesh.py``); the CLI makes N
logical devices over the visible cards first (``launch.mesh.
force_device_count``), so on one card every shard sits on it.

    python -m repro_torch.launch.serve --tasks 32 --train-steps 300
    python -m repro_torch.launch.serve --hetero-fleet --step-loop
    python -m repro_torch.launch.serve --shards 4
    python -m repro_torch.launch.serve --ensemble mixtral-8x22b \
        deepseek-v2-236b --step-loop
    python -m repro_torch.launch.serve --ensemble llava-next-mistral-7b \
        llama3-8b --step-loop

    from repro_torch.launch.serve import serve
    report = serve(tasks, probe, ensemble, ACARConfig(), device="cuda")
"""
from __future__ import annotations

import argparse
import collections
from typing import Dict, List, Optional, Sequence

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs.acar import ACARConfig
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.extract import extract
from repro_torch.core.sigma import MODE_NAMES
from repro_torch.data.tasks import Task, arithmetic_suite
from repro_torch.launch.train import reduced_for_data, train
from repro_torch.models import params as params_lib
from repro_torch.models.transformer import resolve_layout
from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy, ZooModel

DEFAULT_PROBE = "smollm-135m"
DEFAULT_ENSEMBLE = ("llama3-8b", "deepseek-7b", "recurrentgemma-2b")
# the paper's headline heterogeneous mix: a cheap recurrent probe, a
# quant-KV member and a sliding-window member beside a full-attention
# arena member — all four page layouts in one stepped fleet
HETERO_PROBE = "falcon-mamba-7b"
HETERO_ENSEMBLE = ("smollm-135m:quant", "smollm-135m:swa16",
                   "llama3-8b")


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


def main(argv=None, *, device: str = "cuda") -> dict:
    """The serving CLI: train (reduced, on arithmetic) the probe and
    ensemble, serve an arithmetic suite through them on ``device`` and
    print the report, which it returns. The flags are the reference
    CLI's."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tasks", type=int, default=32)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--probe", default=DEFAULT_PROBE,
                    help="probe member spec: a registry arch name, "
                         "optionally with a page-layout variant "
                         "suffix (arch, arch:quant, arch:swaN)")
    ap.add_argument("--ensemble", nargs="+",
                    default=list(DEFAULT_ENSEMBLE),
                    help="ensemble member specs (same syntax as "
                         "--probe)")
    ap.add_argument("--hetero-fleet", action="store_true",
                    help="serve the paper's heterogeneous mix "
                         f"(probe {HETERO_PROBE}, ensemble "
                         f"{', '.join(HETERO_ENSEMBLE)}) — overrides "
                         "--probe/--ensemble")
    ap.add_argument("--probe-temperature", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", action="store_true",
                    help="serve via the admission queue as "
                         "micro-batches (continuous batching)")
    ap.add_argument("--step-loop", action="store_true",
                    help="serve via the step-level loop (streaming "
                         "admission, chunked prefill, mixed-phase "
                         "decode steps; needs a paged-capable probe)")
    ap.add_argument("--shards", type=int, default=None,
                    help="run the step loop on a data-sharded serving "
                         "mesh with this many shards (implies "
                         "--step-loop; makes that many logical devices "
                         "over the visible cards)")
    ap.add_argument("--megastep", type=int, default=1,
                    help="fuse up to K decode ticks per launch in the "
                         "step loop (implies --step-loop; the same "
                         "outputs at any K)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="micro-batch size budget for --scheduler")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="arm the deterministic span tracer and flush "
                         "the hash-chained span JSONL here")
    ap.add_argument("--lineage", default=None, metavar="TASK_ID",
                    help="after serving, walk the PROV lineage of this "
                         "task's final answer and verify every span "
                         "hash on the walk (implies tracing)")
    args = ap.parse_args(argv)
    if args.shards is not None:
        from repro_torch.launch.mesh import force_device_count
        force_device_count(args.shards, device)

    if args.hetero_fleet:
        args.probe = HETERO_PROBE
        args.ensemble = list(HETERO_ENSEMBLE)
    zoo = build_zoo([args.probe] + list(args.ensemble),
                    args.train_steps, seed=args.seed, device=device)
    probe, ensemble = zoo[0], zoo[1:]
    acfg = ACARConfig(probe_model=args.probe,
                      ensemble_models=tuple(args.ensemble),
                      probe_temperature=args.probe_temperature,
                      seed=args.seed)
    tasks = arithmetic_suite(args.tasks, seed=args.seed + 99)
    return serve(tasks, probe, ensemble, acfg,
                 scheduler=args.scheduler, step_loop=args.step_loop,
                 batch_size=args.batch_size, megastep=args.megastep,
                 data_shards=args.shards,
                 trace_path=args.trace, lineage_task=args.lineage,
                 device=device)


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
    (``run_batch``). ``data_shards`` runs the step loop on a
    data-sharded serving mesh of that many shards (it needs that many
    logical devices of ``device``'s kind: ``launch.mesh.
    force_device_count``).

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


if __name__ == "__main__":
    main()
