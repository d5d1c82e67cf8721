"""One run of a cell: set-up, the measured window, the check.

Set-up makes the fleet's weights from the seed, builds the engine and
serves a warm-up: the mix's longest prompts, as many as run at once,
each through every member (the page pools are sized once, for the
longest prompt; the kernel library loads; each path runs once). The
window serves streams back to back until ``seconds`` have passed and
counts every task of every stream it started: it runs from the first
stream's start to the last one's end. With ``trace`` a sub-window from
half the window on runs under the profiler (``harness/trace.py``); the
counts and ``serve_mfu`` are read over the whole window, the
profiler's start, stop and markers taken out of its time.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench.counts import model as model_counts
from perfbench.counts import peaks
from perfbench.harness import check, serve, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE_TOKENS = 192       # served greedy tokens the check scores
PROFILE_SPAN_S = 10.0     # the longest profiled sub-window


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def useful_flops(streams, config: dict) -> float:
    """Model FLOPs of what the streams served: each prompt a server
    prefilled (not a prefix-cache hit, not the twin's reuse of the
    probe's pages) and each token a lane decoded."""
    models = config["models"]
    probe = models[config["probe"]["model"]]
    total = 0.0
    for st in streams:
        for adm, task in enumerate(st.tasks):
            rec = st.records.get(adm)
            if rec is None:
                continue
            s = len(task.text) + 1
            if not rec.probe_from_cache:
                total += model_counts.prefill_flops(probe, s)
            for toks in rec.probe_tokens:
                total += sum(model_counts.decode_flops(probe, s + j)
                             for j in range(len(toks)))
            for mi, toks in rec.member_tokens.items():
                m = models[config["ensemble"][mi]["model"]]
                if rec.member_prefill.get(mi) == "prefill":
                    total += model_counts.prefill_flops(m, s)
                total += sum(model_counts.decode_flops(m, s + j)
                             for j in range(len(toks)))
    return total


def context(streams, prof: dict, fleet, wall_s: float) -> dict:
    """What the per-layer readers read (``metrics/__init__.py``)."""
    tasks = sum(len(s.tasks) for s in streams)
    return {"tasks": tasks, "wall_s": wall_s,
            "flops": useful_flops(streams, fleet.config),
            "peak_flops": peaks.PEAK_FLOPS["bfloat16"],
            "step": serve.step_totals(streams) if streams else None,
            "kv": serve.kv_totals(fleet), "profile": prof}


def device_info(device, peak: int, prof: Optional[dict]) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    if prof is not None:
        info["busy_s"] = prof["busy_s"]
        info["window_s"] = prof["window_s"]
    return info


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, pkg: Path = spec.PKG,
             log=print) -> Dict:
    """Run the cell and return the result line's object, or raise."""
    device = torch.device(device)
    cell = spec.load(root, workload, pkg)
    cuda = device.type == "cuda"
    log(f"set-up: imports done {time.perf_counter() - t_start:.3f} s "
        "since start")
    with serve.Fleet(cell.config, cell.traffic, seed, device) as fleet:
        log(f"set-up: {cell.config['name']}, {fleet.max_active_rows} "
            f"rows at most, weights made in "
            f"{time.perf_counter() - t_start:.3f} s since start")
        warm = fleet.serve(0, warmup=True)
        gib = 2 ** 30
        log(f"set-up: warm-up of {len(warm.tasks)} tasks in "
            f"{warm.wall_s:.3f} s; "
            + (f"{torch.cuda.memory_allocated(device) / gib:.2f} GiB "
               f"allocated, peak "
               f"{torch.cuda.max_memory_allocated(device) / gib:.2f}"
               if cuda else "on the CPU"))
        del warm
        # set-up's objects live to the end: keep the collector from
        # walking them again inside the window
        gc.collect()
        gc.freeze()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start

        streams: List[serve.StreamResult] = []
        sub = prof = None
        with contextlib.ExitStack() as stack:
            if traced:
                ranges = stack.enter_context(trace.Ranges())
                sub = trace.SubWindow(ranges, seconds / 2, PROFILE_SPAN_S)
                fleet.hooks.update(tick=sub.tick, phase=ranges.phase)
                stack.callback(fleet.hooks.clear)
            t0 = time.perf_counter()
            index = 1
            while True:
                streams.append(fleet.serve(index))
                if sub is not None and sub.state == "on":
                    sub.stop()
                    sub.stream_index = index
                elif sub is not None and sub.stream_index is None \
                        and sub.state == "done":
                    sub.stream_index = index
                log(f"window: stream {index}: {len(streams[-1].tasks)} "
                    f"tasks in {streams[-1].wall_s:.3f} s")
                index += 1
                if time.perf_counter() - t0 >= seconds and (
                        sub is None or sub.state == "done"):
                    break
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        found = forbidden_modules()
        if found:
            raise RuntimeError("modules of JAX or the JAX package are "
                               f"loaded: {found}")
        attempted = sum(len(s.tasks) for s in streams)
        if traced:
            prof = sub.result(streams[sub.stream_index - 1])
            log(f"trace: {prof['window_s']:.3f} s profiled in stream "
                f"{sub.stream_index}: {prof['device_ops']} device ops, "
                f"{prof['linked']} linked to their launch, "
                f"{prof['markers']} markers; profiler {sub.overhead_s:.1f} s,"
                f" read in {prof['read_s']:.1f} s")
            for name, k in prof["kernels"].items():
                log(f"trace: {name}: {k['calls']} calls, bound "
                    f"{k['bound_s']:.6f} s ({k['bytes_bound_calls']} by "
                    f"bytes), device {k['device_s']:.6f} s")
            ctx = context(streams, prof, fleet,
                          window_s - sub.overhead_s)
        fleet.close()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = check.replay(streams, cell.config)
    picked = check.sample(streams, cell.config, seed, SAMPLE_TOKENS)
    numbers.update(check.score(picked, cell.config, fleet.weights, device))
    log(f"check: {numbers['tokens_checked']} served tokens of "
        f"{len(picked)} member decodes scored in "
        f"{time.perf_counter() - t_check:.1f} s")
    checks = check.judge_numbers(numbers, cell.limits)
    correct = (all(c["ok"] for c in checks.values())
               and numbers["tokens_checked"] > 0)

    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"tasks_per_s": attempted / window_s,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": numbers["unanswered"],
           "metrics": metrics, "device": device_info(device, peak, prof)}
    if traced and prof is not None:
        out["breakdown"] = prof["breakdown"]
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out
