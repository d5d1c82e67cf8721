"""Finds everything of a cell by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file, its limits and the readers of
its per-layer metrics. A later cell, mix or metric is a new file and a
new entry; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

PKG = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    readers: Dict[str, Callable]


def _applies(metric: dict, name: str, reported: set) -> bool:
    """A metric with ``workloads`` is reported in those cells; a
    per-layer one without, in every cell that reports what it moves."""
    if "workloads" in metric:
        return name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def reader(pkg: Path, name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load(root: Path, workload: str, pkg: Path = PKG) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files under
    ``pkg``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (pkg / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, reported)]
    limits = json.loads(
        (pkg / "limits" / f"{workload}.json").read_text())["limits"]
    return Cell(w, config, traffic, e2e, per_layer, limits,
                {m["name"]: reader(pkg, m["name"]) for m in per_layer})
