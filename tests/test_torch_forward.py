"""The port's full-sequence ``forward`` (the training path) against the
reference's, on the three families it ports: smollm-135m (dense),
falcon-mamba-7b (ssm, through the selective-scan kernel's plain
version) and recurrentgemma-2b (hybrid: RG-LRU, local attention with
the window cut, fused SwiGLU MLPs). Reduced configs in f32, params
converted leaf for leaf from the reference's init, against the
reference's ``transformer.forward`` on ``use_pallas=True`` configs (so
its ops dispatch reaches the oracles the plain versions port). Logits
agree to 1e-5, the tolerance of the reference's own ``use_pallas``
parity test (``tests/test_pallas_wiring.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from repro.configs.registry import get_config as jget
from repro.models import params as jparams
from repro.models import transformer as JT
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import params as tparams
from repro_torch.models import transformer as TT

ARCHS = ("smollm-135m", "falcon-mamba-7b", "recurrentgemma-2b")
B, S = 2, 80           # past recurrentgemma-reduced's window of 64


@functools.lru_cache(maxsize=None)
def _models(arch, dtype="float32"):
    jcfg = jget(arch, reduced=True).replace(dtype=dtype, use_pallas=True)
    jprm = jparams.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(jcfg)
    tprm = tparams.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jprm),
                                  device="cpu")
    return jcfg, jprm, tcfg, tprm


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, jprm, tcfg, tprm = _models(arch)
    ids = _tokens(tcfg)
    want, _ = jax.jit(functools.partial(JT.forward, jcfg))(
        jprm, jnp.asarray(ids))
    with torch.no_grad():
        got, aux = TT.forward(tcfg, tprm, torch.from_numpy(ids))
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)
    assert float(aux) == 0.0
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= 1e-5, err


def _loss_and_grads(cfg, prm, ids, remat):
    batch = {"tokens": torch.from_numpy(ids),
             "labels": torch.from_numpy(np.roll(ids, -1, axis=1))}
    loss, _, grads = loss_and_grads(cfg, prm, batch, remat=remat)
    return loss, dict(tparams._leaves(grads))


def test_remat_gives_the_same_loss_and_gradients():
    """``remat`` recomputes every layer in the backward: the hybrid
    stack's loss and every gradient leaf are bit-identical to the run
    that keeps its activations."""
    _, _, tcfg, tprm = _models("recurrentgemma-2b")
    ids = _tokens(tcfg, 1)
    l0, g0 = _loss_and_grads(tcfg, tprm, ids, remat=False)
    l1, g1 = _loss_and_grads(tcfg, tprm, ids, remat=True)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_model_defs_match_reference(arch):
    """Paths, shapes and dtypes of the port's param tree equal the
    reference's for a bf16 model: ``a_log`` and ``lam`` stay f32, from
    ``init_params`` and through ``from_jax_numpy``."""
    jcfg, jprm, tcfg, tprm = _models(arch, "bfloat16")
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(
                jparams.abstract_params(jcfg))[0]}
    for tree in (tprm, tparams.init_params(tcfg, 0, device="cpu")):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in tparams._leaves(tree)}
        assert got == want
    f32 = {k for k, (_, dt) in want.items() if dt == "float32"}
    assert f32 == {k for k in want if k.endswith(("a_log", "lam"))}
    if arch != "smollm-135m":
        assert f32


def test_forward_rejects_unported_families():
    """Every family is ported; what ``forward`` still refuses is an
    audio model without its frames and patches longer than a vision
    model's prompt."""
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="frame"):
        TT.forward(torch_cfg(jget("whisper-medium", reduced=True)), {},
                   tokens)
    cfg = torch_cfg(jget("llava-next-mistral-7b", reduced=True).replace(
        dtype="float32"))
    prm = tparams.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="patch"):
        TT.forward(cfg, prm, tokens,
                   torch.zeros((1, cfg.num_patches, cfg.d_model)))
