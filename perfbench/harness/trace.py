"""The traced sub-window: part of the window under ``torch.profiler``,
read into device busy time, kernel counts, each counted kernel's device
time against its bound, and the longest idle gaps.

Ranges. In the sub-window only, each kernel with a count file under
``counts/`` is wrapped, at its entry in ``repro_torch.kernels.ops``, in
a ``record_function`` range, and each call's shapes are kept for the
count; ``models.ssm.mamba_prefill`` (the serving scan) and the step
loop's phases get ranges too. A kernel belongs to a range when the
host launched it inside the range: the profiler links each kernel to
its launch call by correlation id, so a kernel counts for its range
whatever its name.

Markers. A profiler window loses records at its edges, so the window
opens with ``HEAD_MARKERS`` and closes with ``TAIL_MARKERS`` spin
kernels (``torch.cuda._sleep``); they are left out of every sum.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import pkgutil
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

from perfbench import counts as counts_pkg
from perfbench.counts import peaks

HEAD_MARKERS = 2_000
TAIL_MARKERS = 2_000
MARKER_KERNEL = "spin_kernel"
RANGE_PREFIX = "perfbench::"
# the launch calls of the CUDA runtime and driver that the profiler
# records on the host
_LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                    "cuMemcpy", "cuMemset", "cudaGraphLaunch")


def kernel_counts() -> Dict[str, object]:
    """wrapper name -> its count module, for every file of ``counts/``
    that names a ``WRAPPER``."""
    out = {}
    for info in pkgutil.iter_modules(counts_pkg.__path__):
        mod = importlib.import_module(f"perfbench.counts.{info.name}")
        if hasattr(mod, "WRAPPER"):
            out[mod.WRAPPER] = mod
    return out


class Ranges:
    """Installs the traced stream's ranges and keeps the calls made while
    ``active``."""

    def __init__(self):
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.active = False
        self._undo: List[Callable] = []

    def _wrap(self, module, attr: str, label: str, describe=None):
        orig = getattr(module, attr)
        calls = self.calls[label]
        name = RANGE_PREFIX + label

        def wrapped(*args, **kw):
            if not self.active:
                return orig(*args, **kw)
            if describe is not None:
                calls.append(describe(*args, **kw))
            with torch.profiler.record_function(name):
                return orig(*args, **kw)

        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, orig))

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import ssm
        for name, mod in kernel_counts().items():
            if hasattr(ops, name):
                self._wrap(ops, name, name, mod.describe)
        self._wrap(ssm, "mamba_prefill", "mamba_prefill")
        return self

    def __exit__(self, *exc):
        while self._undo:
            self._undo.pop()()
        return False

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.active:
            yield
            return
        with torch.profiler.record_function(RANGE_PREFIX + "phase:" + name):
            yield


def _markers(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


class SubWindow:
    """The profiled part of the window: the profiler starts at the
    loop's first tick ``lead_s`` after the window opened and stops at
    its first tick ``span_s`` later, or at the end of the stream it
    started in. ``overhead_s`` is the time the profiler's start and
    stop and the markers took, which the window's rates leave out."""

    def __init__(self, ranges: Ranges, lead_s: float, span_s: float):
        from torch.profiler import ProfilerActivity, profile
        self.ranges, self.lead_s, self.span_s = ranges, lead_s, span_s
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.state, self.t0, self.runner = "wait", time.perf_counter(), None
        self.t_on = self.t_off = self.overhead_s = 0.0
        self.retired_on = self.retired_off = 0
        self.launches_on = self.launches_off = 0
        self.stream_index = None

    def tick(self, runner) -> None:
        self.runner = runner
        now = time.perf_counter()
        if self.state == "wait" and now - self.t0 >= self.lead_s:
            self.prof.start()
            _markers(HEAD_MARKERS)
            self.retired_on = runner.stats.retired
            self.launches_on = runner.stats.launches
            self.ranges.active = True
            self.state, self.t_on = "on", time.perf_counter()
            self.overhead_s += self.t_on - now
        elif self.state == "on" and now - self.t_on >= self.span_s:
            self.stop()

    def stop(self) -> None:
        """Close the sub-window, where it is open."""
        if self.state != "on":
            return
        torch.cuda.synchronize()
        self.t_off = time.perf_counter()
        self.ranges.active = False
        self.retired_off = self.runner.stats.retired
        self.launches_off = self.runner.stats.launches
        _markers(TAIL_MARKERS)
        self.prof.stop()
        self.state = "done"
        self.overhead_s += time.perf_counter() - self.t_off

    def result(self, stream) -> dict:
        """``read_profile``'s reduction of the sub-window, with the tasks
        that retired and the step loop's launches in it, and the
        launches and tasks of ``stream``, the stream it lay in."""
        t = time.perf_counter()
        out = read_profile(self.prof, self.ranges.calls,
                           self.t_off - self.t_on)
        out.update(read_s=time.perf_counter() - t,
                   tasks=self.retired_off - self.retired_on,
                   launches=self.launches_off - self.launches_on,
                   stream_launches=stream.result.step.launches,
                   stream_tasks=len(stream.tasks))
        return out


def _containing(index, tid: int, ts: int):
    """The range of ``index`` (tid -> sorted starts, ranges) holding
    the host instant ``ts`` on thread ``tid``, or None."""
    starts, spans = index.get(tid, ((), ()))
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and spans[i][1] >= ts:
        return spans[i][2]
    return None


def read_profile(prof, calls: Dict[str, List[dict]], wall_s: float) -> dict:
    """Reduce the profiler's raw events (``kineto_results``; building
    ``key_averages`` over a serve window's events takes minutes)."""
    from torch.autograd import DeviceType
    ranges = defaultdict(list)            # category -> (tid, s, e, label)
    launches = {}                         # correlation id -> (tid, ts)
    device_ops = []                       # (start, end, name, corr ids)
    markers = 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(RANGE_PREFIX):
                label = name[len(RANGE_PREFIX):]
                cat = "phase" if label.startswith("phase:") else (
                    "scan" if label == "mamba_prefill" else "kernel")
                ranges[cat].append((e.start_thread_id(), e.start_ns(),
                                    e.start_ns() + e.duration_ns(), label))
            elif name.startswith(_LAUNCH_PREFIXES):
                launches[e.correlation_id()] = (e.start_thread_id(),
                                                e.start_ns())
            continue
        if MARKER_KERNEL in name:
            markers += 1
            continue
        if name.startswith(RANGE_PREFIX):
            continue          # a range's span on the device, not an op
        s = e.start_ns()
        device_ops.append((s, s + e.duration_ns(), name,
                           (e.correlation_id(), e.linked_correlation_id())))
    index = {}
    for cat, spans in ranges.items():
        by_tid = defaultdict(list)
        for tid, s, e, label in spans:
            by_tid[tid].append((s, e, label))
        index[cat] = {tid: ([x[0] for x in sorted(v)], sorted(v))
                      for tid, v in by_tid.items()}

    device_ops.sort()
    busy_ns = 0
    cur_s = cur_e = None
    by_name = defaultdict(float)
    in_range = defaultdict(lambda: defaultdict(float))
    linked = 0
    gaps = []
    prev_end = None
    for s, e, name, corrs in device_ops:
        by_name[name] += (e - s) / 1e9
        launch = next((launches[c] for c in corrs if c in launches), None)
        if launch is not None:
            linked += 1
            for cat in index:
                label = _containing(index[cat], launch[0], launch[1])
                if label is not None:
                    in_range[cat][label] += (e - s) / 1e9
        if prev_end is not None and s > prev_end:
            phase = (_containing(index.get("phase", {}), *launch)
                     if launch is not None else None)
            gaps.append(((s - prev_end) / 1e9, phase or "other"))
        prev_end = e if prev_end is None else max(prev_end, e)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s

    kernels = {}
    for wrapper, mod in kernel_counts().items():
        descs = calls.get(wrapper, [])
        if not descs:
            continue
        bound, by_bytes = 0.0, 0
        for d in descs:
            flops, nbytes = mod.count(d)
            bound += peaks.bound_s(nbytes, flops, d["dtype"])
            by_bytes += peaks.bound_term(nbytes, flops, d["dtype"]) == "bytes"
        kernels[wrapper] = {"calls": len(descs), "bound_s": bound,
                            "bytes_bound_calls": by_bytes,
                            "device_s": in_range["kernel"].get(wrapper, 0.0)}
    gaps.sort(key=lambda g: -g[0])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns / 1e9, "window_s": wall_s,
            "device_ops": len(device_ops), "linked": linked,
            "markers": markers, "kernels": kernels,
            "scan_s": dict(in_range["scan"]),
            "phase_s": dict(in_range["phase"]),
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                          "idle_gaps": [[p, g] for g, p in gaps[:10]]}}
