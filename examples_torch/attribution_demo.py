"""Attribution demo (paper §6.3): ground-truth counterfactuals vs
proxy signals on live ACAR runs.

    PYTHONPATH=src python examples_torch/attribution_demo.py

Like the quickstart, it runs over the synthetic model pool, which
computes nothing on a device: the leave-one-out and Shapley re-runs are
the judge's, on the host.
"""
import argparse

from repro_torch.configs.acar import ACARConfig
from repro_torch.core.attribution import (
    leave_one_out, proxy_agreement, proxy_entropy, proxy_similarity,
    shapley)
from repro_torch.core.backends import paper_backends
from repro_torch.core.orchestrator import ACAROrchestrator
from repro_torch.data.tasks import paper_suite

SHOWN = 5


def main(argv=None) -> int:
    """Print leave-one-out, Shapley and the three proxies for the first
    ``SHOWN`` full-arena tasks of the mixed benchmarks (LiveCodeBench
    skipped); returns how many were shown. Takes no flags
    (``argv`` is parsed for ``--help`` alone)."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    backends = paper_backends()
    orch = ACAROrchestrator(ACARConfig(seed=0),
                            backends["gemini-2.0-flash"], backends,
                            run_id="attr-demo")
    shown = 0
    for t in paper_suite(seed=0)[310:]:  # mixed benchmarks
        if t.benchmark == "livecodebench":
            continue
        out = orch.run_task(t)
        tr = out.trace
        if tr.mode != "full_arena":
            continue
        gold = t.gold.lower() if t.kind == "reasoning" else t.gold
        loo = leave_one_out(tr.responses, tr.task_id, gold)
        phi = shapley(tr.responses, tr.task_id, gold)
        agree = proxy_agreement(tr.responses)
        ent = proxy_entropy(tr.responses)
        sim = proxy_similarity(tr.responses, tr.final_answer)
        print(f"\n{t.task_id} ({t.benchmark}) correct={out.correct}")
        print(f"  {'model':18s} {'LOO':>7s} {'Shapley':>8s} "
              f"{'agree':>6s} {'entropy':>8s} {'sim':>6s}")
        for r in tr.responses:
            print(f"  {r.model:18s} {loo[r.model]:7.3f} "
                  f"{phi[r.model]:8.3f} {agree[r.model]:6.2f} "
                  f"{ent[r.model]:8.3f} {sim[r.model]:6.3f}")
        shown += 1
        if shown >= SHOWN:
            break
    print("\nGround truth (LOO/Shapley) requires explicit "
          "counterfactual judge re-runs; the proxy columns do not "
          "track it — the paper's §6.3 finding. The full correlation "
          "study is benchmarks/attribution_bench.py, which runs on the "
          "JAX package only.")
    return shown


if __name__ == "__main__":
    main()
