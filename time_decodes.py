#!/usr/bin/env python3
"""Check and time some of the port's kernels of one source tree on one
NVIDIA GPU, with ``chip_smoke.py``'s phase-3 checks and timings for
them: the split-KV decodes (the paged decode and the dense-cache
decode; the default), the int8 decodes (the int8 paged decode and the
int8 dense-cache decode), the selective scan or the RG-LRU scan,
forward and backward; optionally, phase 7's training cells.

    python3 time_decodes.py [--src DIR]
        [--kernels {decodes,int8_decodes,selective_scan,rglru_scan} ...]
        [--train-cells {train_mamba,train_griffin} ...]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported and
built (default: this checkout's). To compare two commits on one card,
unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists and time parent, change, change, parent in one
call to the card:

    for s in build/parent/src src src build/parent/src; do
        python3 time_decodes.py --src $s --kernels rglru_scan \
            --train-cells train_griffin; done

Prints one JSON object (the tree it imported, and for each group of
kernels named, each kernel and dtype's error, kernel and plain times,
bound, and for the decodes the SDPA (none for int8) and long-shape
figures and the launch floor of the timing; hashes of the outputs
(equal hashes: two trees' kernels agree bit for bit); with
``--train-cells``, each cell's launch counts, its steps/s and profile
being logged), then the ``nvidia-smi`` name and power-limit line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch to import")
    ap.add_argument("--kernels", nargs="+", choices=tuple(TIMERS),
                    default=["decodes"], help="which kernels to time")
    ap.add_argument("--train-cells", nargs="*", default=[],
                    choices=("train_mamba", "train_griffin"),
                    help="phase 7's training cells to run after them")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decodes: no CUDA device visible", file=sys.stderr)
        return 2
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not Path(build.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {build.__file__}, not from {src}")
    cs.log(f"src: {src}")
    build.build()
    build.load()
    cs.report_ptxas(build)

    out = {"src": str(src)}
    for k in args.kernels:
        out[k] = TIMERS[k](torch, cs)
    if args.train_cells:
        out["train"] = cs.run_train_phase(
            torch, torch.cuda.get_device_name(0), args.train_cells)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))
    print(smi.splitlines()[0], flush=True)
    return 0


def time_selective_scan(torch, cs) -> dict:
    """Kernels 7 and 7b at ``SS_SHAPE``, f32 and bf16 (chip_smoke's
    ``selective_scan_checks``), the small-shape sweep, and where the
    tree has it, ``scan_plan`` against the compiled constants."""
    from repro_torch.kernels import selective_scan as ss
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    clock = cs.sm_clock_mhz(torch)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        results.update(cs.selective_scan_checks(torch, gen, dtype, clock))
    for (name, dname), r in results.items():
        cs.log(f"kernel {name} [{dname}]: max_abs_err {r['max_abs_err']:.3e}"
               f"  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
               f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    cs.log_scan_checks()
    if hasattr(ss, "scan_plan"):
        cs.check_scan_plan()
    cs.run_scan_geometry_checks(torch)
    return {f"{name}[{dname}]": r for (name, dname), r in results.items()}


def time_rglru_scan(torch, cs) -> dict:
    """Kernels 8 and 8b at ``RG_SHAPE``, f32 and bf16 (chip_smoke's
    ``rglru_checks``), the geometry sweep, and where the tree has it,
    ``rglru_plan`` against the compiled constants. A tree without
    ``rglru_plan`` (one before the staged kernels) is not held to a
    bitwise backward: whether its da and du are bitwise is recorded."""
    from repro_torch.kernels import rglru_scan as rg
    exact = hasattr(rg, "rglru_plan")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        results.update(cs.rglru_checks(torch, gen, dtype, exact))
    for (name, dname), r in results.items():
        cs.log(f"kernel {name} [{dname}]: max_abs_err {r['max_abs_err']:.3e}"
               f"  bitwise {r['bitwise']}  kernel {r['ms']:.4f} ms  plain "
               f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
               f"({r['bound_by']})")
    if exact:
        cs.log_rglru_checks()
        cs.check_rglru_plan()
    out = {f"{name}[{dname}]": r for (name, dname), r in results.items()}
    out["geometry_grads_bitwise"] = cs.run_rglru_geometry_checks(torch,
                                                                 exact)
    return out


def time_split_decodes(torch, cs) -> dict:
    """Kernels 1 and 4 (chip_smoke's phase-3 checks and timings)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gen_split = torch.Generator(device="cuda")
    gen_split.manual_seed(2)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        results[("paged_decode_attention", dname)] = cs.paged_decode_checks(
            torch, gen_split, dname, *cs.decode_case(torch, gen, dtype))
        results[("decode_attention", dname)] = cs.dense_decode_checks(
            torch, gen_split, dname, *cs.dense_cache_case(torch, gen, dtype))
    return _decode_results(torch, cs, results, cs.run_decode_geometry_checks)


def time_int8_decodes(torch, cs) -> dict:
    """Kernels 5 and 6 (chip_smoke's phase-3 checks and timings)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gen_quant = torch.Generator(device="cuda")
    gen_quant.manual_seed(4)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        results[("paged_decode_attention_quant", dname)] = (
            cs.paged_quant_checks(torch, gen_quant, dname,
                                  *cs.quant_pages_case(torch, gen, dtype)))
        results[("decode_attention_quant", dname)] = cs.dense_quant_checks(
            torch, gen_quant, dname, *cs.quant_cache_case(torch, gen, dtype))
    return _decode_results(torch, cs, results,
                           cs.run_quant_decode_geometry_checks)


def _decode_results(torch, cs, results: dict, geometry_checks) -> dict:
    """Log the decodes' figures, run their geometry sweep and return the
    JSON: one entry a kernel and dtype, and the launch floor."""
    for (name, dname), r in results.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        cs.log(f"kernel {name} [{dname}]: max_abs_err "
               f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms  plain "
               f"{r['plain_ms']:.4f} ms  library {lib}  "
               f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    cs.log_decode_checks(results)
    geometry_checks(torch)
    out = {f"{name}[{dname}]": r for (name, dname), r in results.items()}
    out["launch_floor_ms"] = cs.launch_floor_ms(torch)
    return out


TIMERS = {"decodes": time_split_decodes, "int8_decodes": time_int8_decodes,
          "selective_scan": time_selective_scan,
          "rglru_scan": time_rglru_scan}


if __name__ == "__main__":
    sys.exit(main())
