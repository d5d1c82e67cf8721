"""Tests that need a CUDA card; each decides so inside the test and
skips on the CPU. Run on the card from the checkout's root:

    python3 -m pytest -q perfbench/tests/test_perfbench_card.py
"""
import pytest
import torch

from perfbench.counts import projection as kp
from perfbench.harness import trace


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_the_profile_links_kernels_to_their_ranges():
    """Kernels launched inside a range count for it, whatever their
    names; the markers count for nothing; a product's share of its
    roofline stays under 100%."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    calls = {"projection": []}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace._markers(trace.HEAD_MARKERS)
        for _ in range(5):
            calls["projection"].append(kp.describe(x, w))
            with torch.profiler.record_function(
                    trace.RANGE_PREFIX + "projection"):
                x @ w
        torch.relu(x)                     # outside every range
        trace._markers(trace.TAIL_MARKERS)
    out = trace.read_profile(prof, calls, 1.0)
    assert out["markers"] > trace.HEAD_MARKERS
    assert out["linked"] == out["device_ops"] >= 6
    k = out["kernels"]["projection"]
    assert k["calls"] == 5 and k["device_s"] > 0
    assert 0 < k["bound_s"] / k["device_s"] <= 1.0
    assert out["busy_s"] > k["device_s"]
