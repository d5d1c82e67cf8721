"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), on the CPU:

- ``quickstart``: both ``main``s print the same bytes;
- ``attribution_demo``: the same task headers and per-model rows; the
  closing note differs by design (the port's says where the full
  correlation study runs);
- ``serve_acar``: for each flag set, the argv it hands the serve CLI
  equals the reference's, and only the reference forces a device count
  itself (the port's serve CLI does that, so the example must not);
  one real run on the CPU reports on every task;
- ``train_model``: ``train_full`` on a 2-layer cut of smollm-arith-100m,
  from the reference's init params, against the reference's
  ``_train_full`` (loaded by path) at ``tests/test_torch_train.py``'s
  tolerances; the tiny size prints the four samples;
- the examples that use a device refuse to run without a card unless
  ``--device cpu`` is given.
"""
import functools
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, torch_cfg

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def load(folder: str, name: str):
    """``folder/name.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(capsys, fn):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


def test_quickstart_prints_the_reference_bytes(capsys):
    want = _stdout(capsys, load("examples", "quickstart").main)
    audit = {}
    got = _stdout(capsys, lambda: audit.update(
        load("examples_torch", "quickstart").main([])))
    assert got == want
    assert audit["records"] == 12 and audit["parse_errors"] == 0, audit


def test_attribution_demo_prints_the_reference_table(capsys):
    want = _stdout(capsys, load("examples", "attribution_demo").main)
    got = _stdout(capsys,
                  lambda: load("examples_torch", "attribution_demo").main([]))
    want, got = want.splitlines(), got.splitlines()
    # the closing note, the last line, differs by design: the reference
    # points at its correlation benchmark, which has no port
    note = "Ground truth (LOO/Shapley) requires explicit counterfactual"
    assert want[-1].startswith(note) and got[-1].startswith(note)
    assert "benchmarks/attribution_bench.py" in got[-1]
    assert got[:-1] == want[:-1]
    headers = [ln for ln in got if re.match(r"^\S+ \(\S+\) correct=", ln)]
    assert len(headers) == 5, got


SERVE_FLAGS = {
    "default": [],
    "scheduler": ["--scheduler", "--batch-size", "4"],
    "megastep": ["--step-loop", "--megastep", "4"],
    "shards": ["--shards", "4", "--tasks", "8"],
    "hetero": ["--hetero-fleet", "--step-loop", "--train-steps", "40"],
    "fleet": ["--probe", "smollm-135m:quant", "--ensemble", "llama3-8b",
              "deepseek-7b:swa16"],
}


def _reference_serve_argv(monkeypatch, flags):
    """The argv the reference example hands ``repro.launch.serve.main``
    and the device counts it forces, run as a script."""
    import repro.launch.serve
    import repro.xla_flags
    calls, forced = [], []
    monkeypatch.setattr(repro.launch.serve, "main", calls.append)
    monkeypatch.setattr(repro.xla_flags, "force_host_device_count",
                        forced.append)
    monkeypatch.setattr(sys, "argv", ["serve_acar.py"] + flags)
    runpy.run_path(str(ROOT / "examples" / "serve_acar.py"),
                   run_name="__main__")
    return calls, forced


@pytest.mark.parametrize("flags", list(SERVE_FLAGS.values()),
                         ids=list(SERVE_FLAGS))
def test_serve_acar_forwards_the_reference_argv(monkeypatch, flags):
    import repro_torch.launch.mesh
    import repro_torch.launch.serve
    want, want_forced = _reference_serve_argv(monkeypatch, flags)
    calls, forced = [], []
    monkeypatch.setattr(repro_torch.launch.serve, "main",
                        lambda argv, device: calls.append((argv, device))
                        or {"forwarded": argv})
    monkeypatch.setattr(repro_torch.launch.mesh, "force_device_count",
                        lambda *a: forced.append(a))
    report = load("examples_torch", "serve_acar").main(
        flags + ["--device", "cpu"])
    assert calls == [(want[0], "cpu")] and len(want) == 1
    assert report == {"forwarded": want[0]}
    assert want_forced == ([4] if "--shards" in flags else [])
    assert forced == []


def test_serve_acar_serves_on_the_cpu(capsys):
    report = load("examples_torch", "serve_acar").main(
        ["--tasks", "4", "--train-steps", "2", "--device", "cpu"])
    assert sum(report["mode_distribution"].values()) == 4, report
    assert "served 4 tasks" in capsys.readouterr().out


@pytest.mark.parametrize("name,argv", [
    ("serve_acar", ["--tasks", "4", "--train-steps", "2"]),
    ("train_model", ["--size", "tiny", "--steps", "2"]),
])
def test_examples_refuse_to_run_without_a_card(monkeypatch, name, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load("examples_torch", name)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(argv)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(argv + ["--device", "cuda"], device="cpu")


CUT_LAYERS, CUT_STEPS = 2, 3


@functools.lru_cache(maxsize=None)
def _reference_cut():
    """The reference's smollm-arith-100m config (as its ``main`` builds
    it) cut to ``CUT_LAYERS`` layers, ``use_pallas=True`` so that its
    ops reach the oracles the port's plain versions port."""
    from repro.configs.registry import get_config
    from repro.data import tokenizer as jtok
    return get_config("smollm-135m").replace(
        vocab_size=jtok.VOCAB_SIZE, dtype="float32", tie_embeddings=True,
        name="smollm-arith-100m", num_layers=CUT_LAYERS, use_pallas=True)


def test_arith_100m_config_is_the_reference_one():
    cfg = load("examples_torch", "train_model").arith_100m_config()
    want = torch_cfg(_reference_cut().replace(num_layers=30,
                                              use_pallas=False))
    assert cfg == want
    assert (cfg.num_layers, cfg.d_model, cfg.dtype) == (30, 576, "float32")


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def test_train_full_matches_the_reference(capsys):
    from repro.models import params as jparams
    from repro_torch.models import params as tparams
    jcfg = _reference_cut()
    tcfg = torch_cfg(jcfg)
    start = tparams.from_jax_numpy(
        tcfg, jax.tree.map(np.asarray,
                           jparams.init_params(jcfg, jax.random.PRNGKey(0))),
        device="cpu")

    capsys.readouterr()
    _, jp, jm = load("examples", "train_model")._train_full(jcfg, CUT_STEPS)
    jlog = capsys.readouterr().out
    losses = []
    _, tp, tm = load("examples_torch", "train_model").train_full(
        tcfg, CUT_STEPS, params=start, device="cpu",
        on_step=lambda i, m: losses.append(float(m["loss"])))
    tlog = capsys.readouterr().out

    # the logged step 0: its loss, printed to 4 places, within half a
    # unit of the last place of the port's (the seconds differ)
    def logged(out):
        return [float(x) for x in re.findall(r"^step +0 loss (\S+) ", out,
                                             re.MULTILINE)]
    assert logged(tlog) == [round(losses[0], 4)]
    assert len(logged(jlog)) == 1
    assert abs(logged(jlog)[0] - losses[0]) <= 5e-5 + 1e-5 * losses[0]
    assert len(losses) == CUT_STEPS and losses[-1] < losses[0]
    for k in ("loss", "token_accuracy", "grad_norm", "total_loss"):
        assert _rel(float(tm[k]), float(jm[k])) <= 1e-5, (k, tm[k], jm[k])
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    assert losses[-1] == float(tm["loss"])

    # params after the steps: AdamW's early updates are about lr *
    # sign(g), so an element whose gradient is rounding noise near zero
    # may move the other way in one package; those are held to under
    # 0.1% of each leaf, the rest to 1e-5
    want = {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(tparams._leaves(tp))
    assert got.keys() == want.keys()
    for k, w in want.items():
        noisy = int((np.abs(got[k].numpy() - w) > 1e-5).sum())
        assert noisy <= max(1, w.size // 1000), (k, noisy, w.size)


def test_train_model_tiny_prints_the_samples(capsys):
    mod = load("examples_torch", "train_model")
    capsys.readouterr()
    cfg, _ = mod.main(["--size", "tiny", "--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()[-4:]
    assert cfg.name == "smollm-135m-reduced" and cfg.num_layers < 30
    for prompt, line in zip(mod.PROMPTS, lines):
        assert re.fullmatch(rf"  {re.escape(repr(prompt))} -> '[^']*'",
                            line), line
