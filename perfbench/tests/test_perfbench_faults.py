"""``correct`` comes out false when the timed path is broken underneath
a run, and the control (the reference in fp8) fails the limit that the
program meets. A whole run of a tiny cell on the CPU, the look for a
card skipped."""
import time

import pytest
import torch

from perfbench import control
from perfbench.harness import cell
from perfbench.tests import tiny

CELLS = ("tiny-dense.tiny", "tiny-mamba.tiny")
SEED = 2 ** 31 + 101


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("bench")
    return root, tiny.layout(root)


def _run(layout, workload):
    root, pkg = layout
    return cell.run_cell(root, workload, SEED, 1.0, False, "cpu",
                         time.perf_counter(), pkg, log=lambda *_: None)


def _token_altered(mp):
    """Each served token one above the one the model chose."""
    from repro_torch.sampling import sampler
    orig = sampler.decode_megastep_rows

    def broken(cfg, params, *a, **kw):
        emits, dones, lg, pages = orig(cfg, params, *a, **kw)
        return (emits + 1) % cfg.vocab_size, dones, lg, pages

    mp.setattr(sampler, "decode_megastep_rows", broken)


def _answer_altered(mp):
    """Each member's answer changed where the loop extracts it."""
    from repro_torch.serving import step_loop
    orig = step_loop.extract
    mp.setattr(step_loop, "extract", lambda text, kind: orig(text, kind)
               + "1")


def _state_unchanged(mp):
    """A prefill that leaves the pages and lanes as they were."""
    from repro_torch.sampling import sampler
    for name in ("prefill_chunk_paged", "prefill_lanes"):
        orig = getattr(sampler, name)

        def broken(cfg, params, tokens, pages, *a, _orig=orig, **kw):
            lg, _ = _orig(cfg, params, tokens,
                          {n: t.clone() for n, t in pages.items()}, *a, **kw)
            return lg, pages

        mp.setattr(sampler, name, broken)


def _half_batch(mp):
    """A decode launch that computes the first half of its rows only."""
    from repro_torch.sampling import sampler
    orig = sampler.decode_megastep_rows

    def broken(*a, **kw):
        emits, dones, lg, pages = orig(*a, **kw)
        lg = lg.clone()
        lg[(lg.shape[0] + 1) // 2:] = 0
        return emits, dones, lg, pages

    mp.setattr(sampler, "decode_megastep_rows", broken)


FAULTS = {"token_altered": _token_altered,
          "answer_altered": _answer_altered,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(layout, workload):
    out = _run(layout, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(layout, workload, fault,
                                      monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(layout, workload)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limit_the_program_meets(layout, workload):
    root, pkg = layout
    limit = tiny.LIMITS["logit_gap"]
    for seed in (11, 12, 2 ** 31 + 13):
        r = control.readings(root, pkg, workload, seed, 0.5, "cpu")
        assert r["logit_gap"] <= limit < r["control_gap"], r
        assert r["answer_mismatches"] == 0 and r["unanswered"] == 0
