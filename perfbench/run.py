"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload dsk7b.prompt --seed 7 \\
        --seconds 30 --trace 0

Serves the cell's traffic through ``repro_torch``'s stepped engine on
one CUDA card for ``--seconds`` (see ``harness/cell.py``), checks what
it served against the plain reference, and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit (also the last lines of standard error). Exits non-zero, with no
result, where there is no CUDA card, where the cell asks for more cards
than there are, or where JAX or the JAX package is loaded.

Run from the root of a checkout. Every build and kernel cache stays in
the checkout's ``build/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library may load
    JAX for us; one host thread for the CPU's share of the work (the
    host runs the step loop, and pool threads only contend with it on a
    shared host)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    torch.set_num_threads(1)

    from perfbench.harness import cell, spec

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        _log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available():
        _log("no CUDA device is visible: the benchmark runs on the card "
             "only")
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        _log(f"{args.workload} needs {chips[args.workload]} CUDA devices, "
             f"{torch.cuda.device_count()} visible")
        return 2
    out = cell.run_cell(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START, spec.PKG, _log)
    found = cell.forbidden_modules()
    if found:
        _log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    for name, c in out["checks"].items():
        _log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
