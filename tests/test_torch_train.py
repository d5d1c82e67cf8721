"""The port's ``make_train_step`` against the reference's, on
smollm-135m (dense), falcon-mamba-7b (ssm) and recurrentgemma-2b
(hybrid), reduced and in f32, from the same params (converted leaf for
leaf) on the same numpy batches.

Against the reference's step on ``use_pallas=True`` configs (its ops
dispatch reaches the oracles the port's plain versions port):

- loss and token accuracy at each of 3 steps, relative 1e-5;
- every gradient leaf at the first step: atol 1e-6 plus rtol 1e-4 of
  the leaf's largest magnitude;
- grad_norm (relative 1e-5) and lr (equal) at each step;
- params after one step at atol 1e-5 wherever the reference's
  |gradient| exceeds 1e-6. AdamW's first update is about lr * sign(g),
  so an element whose gradient is rounding noise near zero may move by
  up to 2 lr the other way in one package; those elements are counted
  and held to under 0.1% of each leaf.

And against the reference's trainer as it runs (``use_pallas=False``:
the chunked associative scan and the blocked SwiGLU): losses at each of
3 steps, relative 1e-4, since the associative scan sums in another
order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, torch_cfg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget
from repro.data.pipeline import synthetic_lm_batches
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import params as jparams
from repro.models import transformer as JT
from repro.optim import init as jopt_init
from repro.optim import softmax_cross_entropy as jxent
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import params as tparams
from repro_torch.optim import init as topt_init

ARCHS = ("smollm-135m", "falcon-mamba-7b", "recurrentgemma-2b")
B, S, STEPS = 2, 80, 3
TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: under a 6-worker run, eight threads a
    worker oversubscribe the cores and the port's CPU training slows
    by an order of magnitude."""
    with one_torch_thread():
        yield


def jax_flat(tree):
    """A reference tree as {"/"-joined path: numpy array}, the port's
    ``params._leaves`` keys."""
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

def _batches(vocab):
    it = synthetic_lm_batches(B, S, vocab, seed=3)
    return [next(it) for _ in range(STEPS)]


def _jbatch(b):
    return {"tokens": jnp.asarray(b.tokens), "labels": jnp.asarray(b.labels),
            "loss_mask": jnp.asarray(b.loss_mask)}


def _tbatch(b):
    return {"tokens": torch.from_numpy(b.tokens),
            "labels": torch.from_numpy(b.labels),
            "loss_mask": torch.from_numpy(b.loss_mask)}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    base = jget(arch, reduced=True).replace(dtype="float32")
    jcfg = base.replace(use_pallas=True)
    jprm = jparams.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = torch_cfg(jcfg)
    tprm = tparams.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jprm),
                                  device="cpu")
    return base, jcfg, jprm, tcfg, tprm


def _run_reference(jcfg, jprm, batches):
    step = jax.jit(jmake_train_step(jcfg, JTrainConfig(**TC)))
    p, st = jprm, jopt_init(jprm)
    out = []
    for b in batches:
        p, st, m = step(p, st, _jbatch(b))
        out.append((p, {k: float(v) for k, v in m.items()}))
    return out


@functools.lru_cache(maxsize=None)
def _port_run(arch):
    """The port's 3 steps, shared by the tests that compare them."""
    _, _, _, tcfg, tprm = _setup(arch)
    return _run_port(tcfg, tprm, _batches(tcfg.vocab_size))


def _run_port(tcfg, tprm, batches):
    step = make_train_step(tcfg, TrainConfig(**TC))
    p, st = tprm, topt_init(tprm)
    out = []
    for b in batches:
        p, st, m = step(p, st, _tbatch(b))
        out.append((p, {k: float(v) for k, v in m.items()}))
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    _, jcfg, jprm, tcfg, tprm = _setup(arch)
    batches = _batches(tcfg.vocab_size)
    jrun = _run_reference(jcfg, jprm, batches)
    trun = _port_run(arch)
    for i, ((_, jm), (_, tm)) in enumerate(zip(jrun, trun)):
        for k in ("loss", "token_accuracy", "grad_norm", "total_loss"):
            assert _rel(tm[k], jm[k]) <= 1e-5, (i, k, tm[k], jm[k])
        assert tm["lr"] == pytest.approx(jm["lr"], rel=1e-7), i
    assert trun[-1][1]["loss"] < trun[0][1]["loss"]

    # params after one step, where the reference's gradient is not noise
    grads = _first_grads(arch)
    jp1, tp1 = jax_flat(jrun[0][0]), dict(tparams._leaves(trun[0][0]))
    flips = {}
    for k, g in grads.items():
        got, want = tp1[k].numpy(), jp1[k]
        sure = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5,
                                   rtol=0, err_msg=k)
        noisy = int((np.abs(got - want) > 1e-5).sum())
        if noisy:
            flips[k] = noisy
        assert noisy <= max(1, got.size // 1000), (k, noisy, got.size)
    print(f"{arch}: elements past 1e-5 after one step (gradient noise "
          f"near zero): {flips}")


@functools.lru_cache(maxsize=None)
def _first_grads(arch):
    """The reference's gradient leaves at the first step's batch."""
    _, jcfg, jprm, tcfg, _ = _setup(arch)
    return jax_flat(_reference_grads(jcfg, jprm,
                                   _batches(tcfg.vocab_size)[0]))


def _reference_grads(jcfg, jprm, b):
    def loss_fn(p):
        logits, _ = JT.forward(jcfg, p, jnp.asarray(b.tokens))
        return jxent(logits, jnp.asarray(b.labels),
                     jnp.asarray(b.loss_mask))[0]
    return jax.jit(jax.grad(loss_fn))(jprm)


def _port_grads(tcfg, tprm, b):
    _, _, grads = loss_and_grads(tcfg, tprm, _tbatch(b))
    return dict(tparams._leaves(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_gradients_match_reference(arch):
    _, _, _, tcfg, tprm = _setup(arch)
    want = _first_grads(arch)
    got = _port_grads(tcfg, tprm, _batches(tcfg.vocab_size)[0])
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(g, w, atol=1e-6 + 1e-4 * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_the_reference_trainer_as_it_runs(arch):
    """The reference trains with ``use_pallas=False`` (jax cannot
    differentiate its Pallas kernels): the chunked associative scans and
    the blocked SwiGLU sum in other orders than the kernels' oracles."""
    base, _, jprm, tcfg, tprm = _setup(arch)
    batches = _batches(tcfg.vocab_size)
    jrun = _run_reference(base, jprm, batches)
    trun = _port_run(arch)
    for i, ((_, jm), (_, tm)) in enumerate(zip(jrun, trun)):
        assert _rel(tm["loss"], jm["loss"]) <= 1e-4, (i, tm, jm)


def test_global_norm_sums_leaves_in_the_reference_order():
    """jax flattens dicts in sorted-key order; so does the port's leaf
    walk, which ``global_norm`` sums in, whatever order the dict was
    built in."""
    tree = {"b": torch.tensor([3.0]), "a": {"z": torch.tensor([1.0]),
                                            "c": torch.tensor([2.0])}}
    assert [float(x) for _, x in tparams._leaves(tree)] == [2.0, 1.0, 3.0]
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [float(x[0]) for x in jax.tree.leaves(jtree)] == [2.0, 1.0, 3.0]
