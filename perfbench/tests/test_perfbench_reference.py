"""The plain reference agrees with ``repro_torch`` at reduced sizes, in
float32 on the CPU: the full forward, and prefill then decode through
the cache, give the reference's logits; the fp8 control does not."""
import ast
from pathlib import Path

import pytest
import torch

from perfbench.harness import serve, weights
from perfbench.reference import dense, mamba
from perfbench.tests import tiny

PKG = Path(__file__).resolve().parents[1]
CASES = {"dense": (dict(tiny.DENSE, dtype="float32"), dense),
         "ssm": (dict(tiny.MAMBA, dtype="float32"), mamba)}


def _setup(family):
    m, ref = CASES[family]
    w = weights.make_weights(m, 2 ** 31 + 3, 1, "cpu")
    # norm scales and D off one, so a wrong use of them shows
    gen = torch.Generator().manual_seed(5)
    for k, t in list(w["layers"].items()):
        for leaf in ("scale", "d_skip"):
            if isinstance(t, dict) and leaf in t:
                t[leaf] = 1 + 0.1 * torch.randn(t[leaf].shape, generator=gen)
    tokens = torch.randint(0, m["vocab_size"], (29,), generator=gen)
    return m, ref, w, tokens


@pytest.mark.parametrize("family", sorted(CASES))
def test_reference_matches_the_full_forward(family):
    from repro_torch.models.transformer import forward
    m, ref, w, tokens = _setup(family)
    cfg = serve.model_config(m, family)
    got, _ = forward(cfg, w, tokens[None])
    want = ref.logits(m, w, tokens, len(tokens))
    torch.testing.assert_close(got[0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", sorted(CASES))
def test_prefill_then_decode_through_the_cache(family):
    from repro_torch.models.transformer import decode_step, prefill
    m, ref, w, tokens = _setup(family)
    cfg = serve.model_config(m, family)
    s = 21
    logits, cache = prefill(cfg, w, tokens[None, :s], cache_len=len(tokens))
    got = [logits[0]]
    for p in range(s, len(tokens) - 1):
        logits, cache = decode_step(cfg, w, cache, tokens[p:p + 1], p)
        got.append(logits[0])
    want = ref.logits(m, w, tokens[:-1], len(tokens) - s)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", sorted(CASES))
def test_the_fp8_control_departs_from_float32(family):
    m, ref, w, tokens = _setup(family)
    exact = ref.logits(m, w, tokens, 8)
    low = ref.logits(m, w, tokens, 8, "fp8")
    assert (low - exact).abs().max() > 1e-3


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "jaxlib", "flax"), (
                    path.name, n)
