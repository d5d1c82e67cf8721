"""``counts/``: FLOPs per token against ``launch/dryrun.py::account``,
and each kernel's operations and bytes against a direct count."""
import json
from pathlib import Path

import pytest
import torch

from perfbench.counts import chunked_prefill_attention as k2
from perfbench.counts import fused_swiglu as k3
from perfbench.counts import model, peaks
from perfbench.counts import projection as kp
from perfbench.harness import serve

PKG = Path(__file__).resolve().parents[1]
MODELS = {name: m for f in sorted((PKG / "configs").glob("*.json"))
          for name, m in json.loads(f.read_text())["models"].items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flops_per_token_agree_with_account(name):
    """account's 2 N a token counts every parameter, the embedding and
    the norms too; ours counts the products a token takes. With the
    embedding added back the two agree to the norms and biases."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import account
    m = MODELS[name]
    tokens = 1024
    rec = account(serve.model_config(m, name),
                  InputShape("p", tokens, 1, "prefill"))
    ours = 2.0 * (model.params_per_token(m)
                  + m["vocab_size"] * m["d_model"]) * tokens
    assert abs(ours - rec["model_flops"]) / rec["model_flops"] < 2e-3


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_is_the_sum_of_its_positions(name):
    m = MODELS[name]
    s = 37
    head = 2.0 * model.head_weights(m)
    by_position = sum(model.decode_flops(m, p) - head for p in range(s))
    assert model.prefill_flops(m, s) == pytest.approx(by_position + head)


def test_projection_and_swiglu_counts():
    x = torch.zeros(3, 5, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 96, dtype=torch.bfloat16)
    flops, nbytes = kp.count(kp.describe(x, w))
    assert flops == 2 * 15 * 64 * 96
    assert nbytes == 2 * (15 * 64 + 64 * 96 + 15 * 96)
    wg = torch.zeros(64, 128, dtype=torch.bfloat16)
    wd = torch.zeros(128, 64, dtype=torch.bfloat16)
    flops, nbytes = k3.count(k3.describe(x.reshape(15, 64), wg, wg, wd))
    assert flops == 6 * 15 * 64 * 128 + 5 * 15 * 128
    assert nbytes == 2 * (2 * 15 * 64 + 3 * 64 * 128)


def test_chunked_prefill_count_follows_the_positions():
    """Two rows at different depths: row 0's chunk at 0..3, row 1's at
    8..11, over 16-position pages of 2 kv heads."""
    q = torch.zeros(2, 4, 4, 8, dtype=torch.bfloat16)
    pages = torch.zeros(6, 16, 2, 8, dtype=torch.bfloat16)
    pos = torch.tensor([[0, 1, 2, 3], [8, 9, 10, 11]], dtype=torch.int32)
    d = k2.describe(q, pages, pages, torch.zeros(2, 1, dtype=torch.int32),
                    pos, prompt_len=12)
    flops, nbytes = k2.count(d)
    keys = sum(p + 1 for p in range(4)) + sum(p + 1 for p in range(8, 12))
    assert flops == 2 * (8 + 8) * 4 * keys
    assert nbytes == 2 * (2 * 4 * 4 * 16 + (4 + 12) * 2 * 16)


def test_bounds_name_their_larger_term():
    assert peaks.bound_term(3.35e12, 1.0, torch.bfloat16) == "bytes"
    assert peaks.bound_s(0.0, 989e12, torch.bfloat16) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 67e12, torch.float32) == pytest.approx(1.0)
