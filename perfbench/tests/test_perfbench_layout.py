"""The harness takes every cell, mix and metric as data: a new
configuration, traffic mix and per-layer metric are new files and new
entries, found by name, with no existing file edited."""
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench.harness import spec, traffic

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("workload",
                         [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads(workload):
    cell = spec.load(ROOT, workload)
    names = {m["name"] for m in cell.end_to_end}
    assert {"tasks_per_s", "peak_mem_gib", "setup_s"} <= names
    assert cell.per_layer and set(cell.readers) == {
        m["name"] for m in cell.per_layer}
    assert set(cell.limits) == {"logit_gap", "answer_mismatches",
                                "unanswered"}
    tasks, routes = traffic.stream(cell.traffic, 2 ** 31 + 5, 1)
    assert len(tasks) == cell.traffic["stream_tasks"] == len(routes)


def test_benchmark_json_keeps_to_its_format():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PKG, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root / "perfbench")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pkg = root / "perfbench"

    config = json.loads((pkg / "configs" / "dsk7b-fleet.json").read_text())
    config["name"] = "fake-fleet"
    (pkg / "configs" / "fake-fleet.json").write_text(json.dumps(config))
    mix = json.loads((pkg / "traffic" / "prompt.json").read_text())
    mix.update(name="fake-mix", new_tokens=7, stream_tasks=48)
    (pkg / "traffic" / "fake-mix.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "fake_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (pkg / "limits" / "fake.cell.json").write_text(json.dumps(
        {"limits": {"logit_gap": 1.0, "answer_mismatches": 0,
                    "unanswered": 0}}))
    bench["configs"].append({"name": "fake-fleet", "source": "x",
                             "file": "perfbench/configs/fake-fleet.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "fake.cell", "config": "fake-fleet",
                               "traffic": "fake-mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "fake_metric", "unit": "%",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "tasks_per_s",
                               "workloads": ["fake.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load(root, "fake.cell", pkg)
    assert cell.config["name"] == "fake-fleet"
    assert cell.traffic["new_tokens"] == 7
    assert cell.readers["fake_metric"]({}) == 42.0
    assert len(traffic.stream(cell.traffic, 3, 1)[0]) == 48
    # the old cells still load, without the new metric
    old = spec.load(root, "dsk7b.prompt", pkg)
    assert "fake_metric" not in old.readers
    after = _digests(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
