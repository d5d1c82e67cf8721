"""The training entry point and checkpoints across the two packages.

- The reference's ``train`` writes an npz that the port's
  ``restore_checkpoint`` loads, leaf for leaf, bit for bit.
- The port's ``train`` (on the CPU) runs, its loss falls, and the
  reference's ``restore_checkpoint`` loads its npz bit for bit. The two
  ``train`` runs are not compared step by step: the port's
  ``init_params`` draws from a torch generator, the reference's from
  jax's threefry, so they start from different weights
  (``tests/test_torch_train.py`` compares the steps from one start).
- npz -> torch -> npz is bit-identical, bf16 leaves and their dtype
  tags included.
- The port's ``build_zoo`` restores the reference's checkpoint, and the
  port's greedy tokens on a few prompts equal the reference's on it.
  Without a checkpoint it trains the member on arithmetic: the params
  are ``train``'s own at the reference's ``build_zoo`` knobs, on the
  device asked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, torch_cfg
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.registry import get_config as jget
from repro.launch.train import reduced_for_data as jreduced
from repro.launch.train import train as jtrain
from repro.models import params as jparams
from repro_torch.checkpoint import (
    load_metadata, restore_checkpoint, save_checkpoint)
from repro_torch.data import tokenizer as tok
from repro_torch.data.pipeline import arithmetic_batches
from repro_torch.launch.serve import build_zoo
from repro_torch.launch.steps import loss_and_grads
from repro_torch.launch.train import reduced_for_data, train
from repro_torch.models import params as tparams

STEPS = 40


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

def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """The reference trainer's reduced smollm-135m and its npz."""
    path = tmp_path_factory.mktemp("ref") / "ref_smollm.npz"
    _, params, _ = jtrain(arch="smollm-135m", steps=STEPS, batch=16,
                          seq=24, lr=2e-3, ckpt=str(path), verbose=False)
    return path, params


def test_port_restores_the_reference_trainers_checkpoint(ref_ckpt):
    path, jprm = ref_ckpt
    cfg = reduced_for_data("smollm-135m", "arithmetic")
    template = tparams.init_params(cfg, 0, device="cpu")
    got = dict(tparams._leaves(restore_checkpoint(path, template)))
    dtypes = {k: t.dtype for k, t in tparams._leaves(template)}
    want = jax_flat(jprm)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == dtypes[k]
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    meta = load_metadata(path)
    assert meta["step"] == STEPS
    assert meta["user"] == {"arch": "smollm-135m", "data": "arithmetic"}


def _initial_loss(cfg, seed, batch, seq):
    """The loss ``train`` starts from: its init params on its first
    batch."""
    b = next(arithmetic_batches(batch, seq, seed=seed))
    loss, _, _ = loss_and_grads(
        cfg, tparams.init_params(cfg, seed, device="cpu"),
        {n: torch.from_numpy(getattr(b, n))
         for n in ("tokens", "labels", "loss_mask")})
    return float(loss)


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-2b"])
def test_port_train_runs_and_the_reference_restores_it(arch, tmp_path):
    path = tmp_path / f"{arch}.npz"
    cfg, prm, metrics = train(arch=arch, steps=STEPS, batch=16, seq=24,
                              lr=2e-3, ckpt=str(path), verbose=False,
                              device="cpu")
    first = _initial_loss(cfg, 0, 16, 24)
    assert float(metrics["loss"]) < 0.75 * first, (metrics["loss"], first)
    jcfg = jreduced(arch, "arithmetic")
    template = jparams.init_params(jcfg, jax.random.PRNGKey(0))
    got = jax_flat(jrestore(path, template))
    want = dict(tparams._leaves(prm))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)


def test_npz_torch_npz_round_trip_is_bit_identical(tmp_path):
    """A bf16 hybrid model (f32 ``lam`` leaves beside bf16 weights)
    written by the reference, restored by the port and written again:
    the same arrays, bit for bit, and the same dtype tags."""
    jcfg = jget("recurrentgemma-2b", reduced=True)
    assert jcfg.dtype == "bfloat16"
    jprm = jparams.init_params(jcfg, jax.random.PRNGKey(4))
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    jsave(a, jprm, step=7, metadata={"arch": "recurrentgemma-2b"})
    template = tparams.init_params(torch_cfg(jcfg), 0, device="cpu")
    prm = restore_checkpoint(a, template)
    save_checkpoint(b, prm, step=7, metadata={"arch": "recurrentgemma-2b"})
    ma, mb = load_metadata(a), load_metadata(b)
    assert ma == mb
    assert set(ma["dtypes"].values()) == {"bfloat16", "float32"}
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k == "__meta__":
                continue
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    back = jax_flat(jrestore(b, jprm))
    for k, w in jax_flat(jprm).items():
        np.testing.assert_array_equal(_bits(back[k]), _bits(w), err_msg=k)


def test_build_zoo_restores_and_decodes_like_the_reference(ref_ckpt):
    from repro.launch.serve import build_zoo as jbuild_zoo
    from repro.sampling import generate as jgenerate
    from repro_torch.sampling import generate
    path, _ = ref_ckpt
    spec = "smollm-135m"
    (jm,) = jbuild_zoo([spec], train_steps=0, ckpts={spec: path},
                       verbose=False)
    (tm,) = build_zoo([spec], train_steps=0, ckpts={spec: path},
                      verbose=False, device="cpu")
    assert tm.cfg == torch_cfg(jm.cfg)
    prompts = ["3 + 4 = ", "9 - 2 = ", "5 + 5 = ", "1 - 8 = "]
    ids = np.asarray([tok.encode(p) for p in prompts], np.int32)
    jout = jgenerate(jm.cfg, jm.params, jnp.asarray(ids), max_new_tokens=4)
    tout = generate(tm.cfg, tm.params, ids, max_new_tokens=4)
    np.testing.assert_array_equal(np.asarray(tout.tokens),
                                  np.asarray(jout.tokens))


def test_build_zoo_trains_a_member_without_a_checkpoint():
    """Two steps of ``train`` at the reference's ``build_zoo`` knobs
    (arithmetic, batch 64 x 24, lr 2e-3, seed + member index): the
    member's params equal ``train``'s bit for bit, its loss is finite
    and has fallen from the init params', and every leaf sits on the
    device asked. One intra-op thread: the CPU's threaded reductions
    are not bitwise reproducible from run to run."""
    specs = ["smollm-135m", "smollm-135m:quant"]
    with one_torch_thread():
        zoo = build_zoo(specs, train_steps=2, seed=3, verbose=False,
                        device="cpu")
        runs = [train(arch="smollm-135m", data="arithmetic", steps=2,
                      batch=64, seq=24, lr=2e-3, seed=3 + i, verbose=False,
                      device="cpu") for i in range(len(specs))]
    assert [m.name for m in zoo] == specs
    assert zoo[1].cfg == zoo[0].cfg.replace(kv_quant=True)
    b = next(arithmetic_batches(64, 24, seed=4))
    batch = {n: torch.from_numpy(getattr(b, n))
             for n in ("tokens", "labels", "loss_mask")}
    for i, (zm, (cfg, want, metrics)) in enumerate(zip(zoo, runs)):
        assert zm.cfg.replace(kv_quant=False) == cfg
        assert np.isfinite(float(metrics["loss"]))
        got = dict(tparams._leaves(zm.params))
        for k, v in tparams._leaves(want):
            assert got[k].device == torch.device("cpu"), k
            assert torch.equal(got[k], v), k
        trained, _, _ = loss_and_grads(cfg, zm.params, batch)
        init, _, _ = loss_and_grads(
            cfg, tparams.init_params(cfg, 3 + i, device="cpu"), batch)
        assert np.isfinite(float(trained))
        assert float(trained) < float(init)
