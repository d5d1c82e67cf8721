"""Quickstart: sigma-based routing with auditable traces in ~40 lines.

    PYTHONPATH=src python examples_torch/quickstart.py

Runs ACAR (Alg. 1) over a handful of tasks with the calibrated
synthetic model pool, prints each routing decision, and verifies the
hash-chained artifact store. The synthetic pool draws its answers on
the host and computes nothing on a device, so this example takes no
``--device``; ``examples_torch/serve_acar.py`` serves real models.
"""
import argparse
import tempfile
from pathlib import Path

from repro_torch.configs.acar import ACARConfig
from repro_torch.core.backends import paper_backends
from repro_torch.core.orchestrator import ACAROrchestrator
from repro_torch.core.sigma import sigma
from repro_torch.data.tasks import paper_suite
from repro_torch.teamllm.artifacts import ArtifactStore


def main(argv=None) -> dict:
    """Print sigma by hand, then each task's routing and the audit;
    returns the artifact store's audit. Takes no flags (``argv`` is
    parsed for ``--help`` alone)."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    # 1. sigma by hand (paper Def. 1)
    print("sigma(['42','42','42']) =", sigma(["42", "42", "42"]))
    print("sigma(['42','42','17']) =", sigma(["42", "42", "17"]))
    print("sigma(['42','17','99']) =", sigma(["42", "17", "99"]))

    # 2. full ACAR over tasks, with immutable decision traces
    backends = paper_backends()
    with tempfile.TemporaryDirectory() as d:
        store = ArtifactStore(Path(d) / "runs.jsonl")
        orch = ACAROrchestrator(
            ACARConfig(seed=0),
            probe=backends["gemini-2.0-flash"],
            ensemble=backends,
            store=store,
            run_id="quickstart")
        tasks = paper_suite(seed=0)[::130][:12]  # mix of benchmarks
        print(f"\n{'task':18s} {'sigma':>5s} {'mode':>12s} "
              f"{'models':>7s} {'correct':>7s}")
        for t in tasks:
            out = orch.run_task(t)
            tr = out.trace
            print(f"{t.task_id:18s} {tr.sigma:5.1f} {tr.mode:>12s} "
                  f"{len(tr.responses):7d} {str(out.correct):>7s}")

        audit = store.audit()
        print(f"\nartifact store: {audit['records']} records, "
              f"parse errors {audit['parse_errors']}, "
              f"chain head {audit['head'][:16]}…")
        saved = sum(3 - len(o["responses"])
                    for o in store.read_all())
        print(f"ensemble calls saved vs always-full-arena: {saved} "
              f"of {3 * len(tasks)}")
    return audit


if __name__ == "__main__":
    main()
