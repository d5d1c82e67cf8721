"""End-to-end example (the paper's kind: serving/orchestration).

Trains a 4-model zoo of reduced architectures on char-level arithmetic,
then serves a batch of tasks through the batched ACAR engine: (B x 3)
probe decode -> EXTRACT -> sigma/routing on the card -> masked ensemble
decodes -> vectorised judge, with the hand-written CUDA kernels on the
attention and MLP hot paths.

With ``--scheduler`` the request stream is admitted through the
continuous-batching queue and served as micro-batches, printing the
Prometheus-style scheduler counters at the end. With ``--step-loop``
it runs the step-level loop instead (streaming admission off
``AdmissionQueue.ready()``, chunked prefill, mixed-phase decode steps,
mid-stream retirement) — the same answers, different execution. With
``--shards N`` the step loop runs on a data-sharded serving mesh
(per-shard paged KV pools, least-loaded placement); the serve CLI makes
N logical devices over the visible cards itself
(``launch.mesh.force_device_count``), so one card serves every shard.
With ``--megastep K`` the step loop runs up to K decode ticks per
launch — again the same answers, fewer host round-trips.

Fleet selection uses registry arch names with optional page-layout
variant suffixes (``arch:quant`` int8 KV pages, ``arch:swaN`` ring
pages); ``--hetero-fleet`` serves the paper's headline mix (Mamba
probe + quant and sliding-window members + a full-attention arena
member) through the stepped engine's heterogeneous page layouts.

Runs on the card; ``--device cpu`` runs the kernels' plain versions on
the CPU instead.

    PYTHONPATH=src python examples_torch/serve_acar.py [--tasks 32]
        [--train-steps 300] [--scheduler | --step-loop | --shards 4]
        [--megastep 16] [--batch-size 8]
        [--probe ARCH[:quant|:swaN]] [--ensemble SPEC ...]
        [--hetero-fleet] [--device cuda|cpu]
"""
import argparse

from repro_torch.launch import serve as serve_mod
from repro_torch.runtime import require_device


def main(argv=None, *, device: str = "cuda") -> dict:
    """Parse the example's flags, run the serve CLI
    (``launch.serve.main``) with them on ``--device`` (default
    ``device``) and return its report."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tasks", type=int, default=32)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--scheduler", action="store_true")
    ap.add_argument("--step-loop", action="store_true")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--megastep", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--probe", default=None)
    ap.add_argument("--ensemble", nargs="+", default=None)
    ap.add_argument("--hetero-fleet", action="store_true")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    require_device(args.device)
    argv = ["--tasks", str(args.tasks),
            "--train-steps", str(args.train_steps),
            "--batch-size", str(args.batch_size)]
    if args.scheduler:
        argv.append("--scheduler")
    if args.step_loop:
        argv.append("--step-loop")
    if args.shards:
        argv.extend(["--shards", str(args.shards)])
    if args.megastep != 1:
        argv.extend(["--megastep", str(args.megastep)])
    if args.probe:
        argv.extend(["--probe", args.probe])
    if args.ensemble:
        argv.extend(["--ensemble"] + args.ensemble)
    if args.hetero_fleet:
        argv.append("--hetero-fleet")
    return serve_mod.main(argv, device=args.device)


if __name__ == "__main__":
    main()
