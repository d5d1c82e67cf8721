"""A copy of the benchmark's layout at a size the CPU runs in seconds:
the real readers and code, tiny models and a tiny mix, written into a
temporary directory."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]

DENSE = {"family": "dense", "num_layers": 2, "d_model": 64,
         "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "vocab_size": 256,
         "rope_theta": 10000.0, "norm_eps": 1e-5, "tie_embeddings": False,
         "dtype": "bfloat16"}
MAMBA = {"family": "ssm", "num_layers": 2, "d_model": 64, "num_heads": 1,
         "num_kv_heads": 1, "d_ff": 0, "vocab_size": 256,
         "attn_kind": "none", "use_rope": False,
         "ssm": {"state_dim": 8, "conv_width": 4, "expand": 2,
                 "dt_rank": 0, "chunk": 8},
         "norm_eps": 1e-5, "tie_embeddings": False, "dtype": "bfloat16"}
TRAFFIC = {"name": "tiny", "users": "tests", "stream_tasks": 24,
           "prompt_tokens": {"lognormal_median": 32, "lognormal_sigma": 0.5,
                             "snap_to": [24, 40, 56]},
           "new_tokens": 4, "chunk_tokens": 16, "megastep": 2,
           "resubmit": {"share": 0.15, "within": 4},
           "routes_per_block": [13, 4, 7], "kind": "math"}
LIMITS = {"logit_gap": 0.004, "answer_mismatches": 0, "unanswered": 0}


def fleet(name: str, probe_model: str, models: dict) -> dict:
    member = "dense" if "dense" in models else probe_model
    return {"name": name, "source": "tests", "models": models,
            "probe": {"name": f"{name}-probe", "model": probe_model,
                      "weights": 0},
            "ensemble": [
                {"name": f"{name}-m1", "model": member, "weights": 1},
                {"name": f"{name}-m2", "model": member, "weights": 2},
                {"name": f"{name}-twin", "model": probe_model,
                 "weights": 0}],
            "kv_page_size": 8, "kv_prefix_cache": 2,
            "pool_budget_gib": 0.01}


def layout(tmp: Path) -> Path:
    """Write the tiny layout under ``tmp``; returns its package dir.
    Cells: ``tiny-dense.tiny`` and ``tiny-mamba.tiny``."""
    pkg = tmp / "perfbench"
    for sub in ("configs", "traffic", "limits"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(PKG / "metrics", pkg / "metrics")
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    configs = {"tiny-dense": fleet("tiny-dense", "dense", {"dense": DENSE}),
               "tiny-mamba": fleet("tiny-mamba", "mamba",
                                   {"mamba": MAMBA, "dense": DENSE})}
    bench["configs"], bench["workloads"] = [], []
    for name, cfg in configs.items():
        path = pkg / "configs" / f"{name}.json"
        path.write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "tests"})
        cell = f"{name}.tiny"
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "tests"})
        (pkg / "limits" / f"{cell}.json").write_text(
            json.dumps({"workload": cell, "limits": LIMITS}))
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w["name"] for w in bench["workloads"]]
    (pkg / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return pkg
