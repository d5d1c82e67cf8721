"""The readings a cell's limits are set from, on the card: for each seed,
the program serves the cell's own mix for a short window, and the
served greedy tokens of a sample drawn as ``run.py`` draws it are
scored twice, by the float32 reference (the program's ``logit_gap``,
the lower reading) and by the control: the same reference computing
every weight product from float8 e4m3 codes, the precision below the
configuration's bf16, whose first token at each position is scored by
the float32 reference (``control_gap``, the upper reading).

    python3 perfbench/control.py --workload dsk7b.prompt \\
        --seeds 11,12,13 --seconds 10 --out build/control.jsonl

One JSON line a seed on standard output (and in ``--out``). The
benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, pkg: Path, workload: str, seed: int,
             seconds: float, device) -> dict:
    """One seed's readings."""
    import torch

    from perfbench.harness import cell as cell_mod
    from perfbench.harness import check, serve, spec
    cell = spec.load(root, workload, pkg)
    t0 = time.perf_counter()
    with serve.Fleet(cell.config, cell.traffic, seed, device) as fleet:
        streams, index = [], 1
        while not streams or time.perf_counter() - t0 < seconds:
            streams.append(fleet.serve(index))
            index += 1
        fleet.close()
    weights = fleet.weights
    del fleet
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": workload, "seed": seed,
           "tasks": sum(len(s.tasks) for s in streams)}
    out.update(check.replay(streams, cell.config))
    picked = check.sample(streams, cell.config, seed, cell_mod.SAMPLE_TOKENS)
    out.update(check.score(picked, cell.config, weights, device,
                           precisions=("f32", "fp8")))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench.harness import spec
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        rec = readings(ROOT, spec.PKG, args.workload, seed, args.seconds,
                       "cuda")
        rec["seconds"] = time.perf_counter() - t
        rec["card"] = torch.cuda.get_device_name(0)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
