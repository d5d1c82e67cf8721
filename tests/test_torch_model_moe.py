"""The MoE family and MLA at rung 2 of the ladder: the port's model
entry points against the reference's on reduced f32 configs, params
converted leaf for leaf from the reference's init, the reference on
``use_pallas=True`` configs (its ops dispatch reaches the oracles the
port's plain versions port). Cases: mixtral-8x22b (capacity MoE,
sliding window), mixtral-8x22b with ``impl="gather"`` and
deepseek-v2-236b (capacity MoE with MLA, a shared expert and a dense
layer 0).

- ``forward``: logits within 1e-4, the summed router aux within 1e-6.
- ``prefill`` and ``decode_step`` over a contiguous cache (MLA: the
  latent cache): logits within 1e-4 of the reference's; and, at
  capacity 8.0 (no token dropped), teacher-forcing parity with the
  port's own ``forward`` (``tests/test_arch_smoke.py``'s check, at
  1e-4 here).
- ``generate`` greedy: equal tokens.
- ``make_train_step``: loss (with the router aux term) after one step
  relative 1e-5, every gradient leaf at atol 1e-6 + 1e-4 of its
  largest magnitude, params after a step at ``tests/test_torch_train.py``'s
  tolerances; the step without the aux term differs from the
  reference's.
- Full configs carry the published hyperparameters; an audio prefill
  without frames and a vision prefill with too short a prompt raise.
"""
import dataclasses
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
from repro.sampling import sampler as JS
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import params as tparams
from repro_torch.models import transformer as TT
from repro_torch.optim import init as topt_init
from repro_torch.sampling import sampler as TS

CASES = [("mixtral-8x22b", None), ("mixtral-8x22b", "gather"),
         ("deepseek-v2-236b", None)]
IDS = [f"{a}-{i or 'capacity'}" for a, i in CASES]
B, S = 2, 24
TOL = 1e-4
TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@functools.lru_cache(maxsize=None)
def _models(arch, impl, capacity=None):
    jcfg = jget(arch, reduced=True).replace(dtype="float32",
                                            use_pallas=True)
    moe = {}
    if impl:
        moe["impl"] = impl
    if capacity:
        moe["capacity_factor"] = capacity
    if moe:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
    jprm = jparams.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = torch_cfg(jcfg)
    tprm = tparams.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jprm),
                                  device="cpu")
    return jcfg, jprm, tcfg, tprm


def _ids(cfg, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, s)).astype(np.int32)


def _err(got, want):
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_forward_matches_reference(arch, impl):
    jcfg, jprm, tcfg, tprm = _models(arch, impl)
    ids = _ids(tcfg)
    want, waux = jax.jit(functools.partial(JT.forward, jcfg))(
        jprm, jnp.asarray(ids))
    with torch.no_grad():
        got, aux = TT.forward(tcfg, tprm, torch.from_numpy(ids))
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)
    assert _err(got, want) <= TOL
    assert float(aux) > 0
    assert abs(float(aux) - float(waux)) <= 1e-6


@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(arch, impl):
    """Prefill a 24-token prompt into a 28-position cache and decode 3
    teacher-forced tokens: logits within 1e-4 of the reference's at
    each step; at capacity 8.0, also within 1e-4 of the port's own
    ``forward`` at the same positions."""
    jcfg, jprm, tcfg, tprm = _models(arch, impl, capacity=8.0)
    ids = _ids(tcfg, S + 3, seed=1)
    jl, jc = JT.prefill(jcfg, jprm, jnp.asarray(ids[:, :S]),
                        cache_len=S + 4)
    with torch.no_grad():
        full, _ = TT.forward(tcfg, tprm, torch.from_numpy(ids))
        tl, tc = TT.prefill(tcfg, tprm, torch.from_numpy(ids[:, :S]),
                            cache_len=S + 4)
    if tcfg.attn_kind == "mla":
        assert set(tc["layer_00"]) == {"c_kv", "k_rope"}
        assert tuple(tc["layers"]["c_kv"].shape) == (
            tcfg.num_layers - 1, B, S + 4, tcfg.mla.kv_lora_rank)
    assert _err(tl, jl) <= TOL
    assert _err(tl, full[:, S - 1]) <= TOL
    step = jax.jit(functools.partial(JT.decode_step, jcfg))
    for i in range(3):
        jl, jc = step(jprm, jc, jnp.asarray(ids[:, S + i]),
                      jnp.int32(S + i))
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, tprm, tc,
                                    torch.from_numpy(ids[:, S + i]), S + i)
        assert _err(tl, jl) <= TOL, i
        if i < 2:
            assert _err(tl, full[:, S + i]) <= TOL, i


@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_greedy_generate_matches_reference(arch, impl):
    jcfg, jprm, tcfg, tprm = _models(arch, impl)
    ids = _ids(tcfg, 17, seed=2)
    key = jax.random.PRNGKey(5)
    jout = JS.generate(jcfg, jprm, jnp.asarray(ids), max_new_tokens=6,
                       temperature=0.0, key=key, eos_id=-1, pad_id=0)
    with torch.no_grad():
        tout = TS.generate(tcfg, tprm, ids, max_new_tokens=6,
                           temperature=0.0, key=np.asarray(key),
                           eos_id=-1, pad_id=0)
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def _batches(vocab, n=1):
    it = synthetic_lm_batches(B, S, vocab, seed=3)
    return [next(it) for _ in range(n)]


def _jbatch(b):
    return {"tokens": jnp.asarray(b.tokens), "labels": jnp.asarray(b.labels),
            "loss_mask": jnp.asarray(b.loss_mask)}


def _tbatch(b):
    return {"tokens": torch.from_numpy(b.tokens),
            "labels": torch.from_numpy(b.labels),
            "loss_mask": torch.from_numpy(b.loss_mask)}


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _train_runs(arch, impl):
    """Both packages' first step from the same params on the same batch,
    and the reference's gradient of the first step's total loss."""
    jcfg, jprm, tcfg, tprm = _models(arch, impl)
    batches = _batches(tcfg.vocab_size)
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(**TC)))
    tstep = tsteps.make_train_step(tcfg, TrainConfig(**TC))
    jp, js, tp, ts = jprm, jopt_init(jprm), tprm, topt_init(tprm)
    runs = []
    for b in batches:
        jp, js, jm = jstep(jp, js, _jbatch(b))
        tp, ts, tm = tstep(tp, ts, _tbatch(b))
        runs.append((jp, {k: float(v) for k, v in jm.items()},
                     tp, {k: float(v) for k, v in tm.items()}))

    def total(p):
        logits, aux = JT.forward(jcfg, p, jnp.asarray(batches[0].tokens))
        from repro.optim import softmax_cross_entropy
        loss, _ = softmax_cross_entropy(logits,
                                        jnp.asarray(batches[0].labels),
                                        jnp.asarray(batches[0].loss_mask))
        return loss + jcfg.moe.router_aux_weight * aux

    grads = _flat(jax.jit(jax.grad(total))(jprm))
    return runs, grads, batches


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_train_step_matches_reference(arch, impl):
    """Loss, total loss (cross-entropy + router_aux_weight x aux), aux,
    grad_norm at each step and params after the first, against the
    reference's ``make_train_step``."""
    runs, grads, _ = _train_runs(arch, impl)
    for i, (_, jm, _, tm) in enumerate(runs):
        for k in ("loss", "total_loss", "grad_norm", "token_accuracy"):
            assert _rel(tm[k], jm[k]) <= 1e-5, (i, k, tm[k], jm[k])
        assert abs(tm["aux_loss"] - jm["aux_loss"]) <= 1e-6, i
        assert tm["total_loss"] > tm["loss"]
    jp1, tp1 = _flat(runs[0][0]), dict(tparams._leaves(runs[0][2]))
    for k, g in grads.items():
        got, want = tp1[k].numpy(), jp1[k]
        sure = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5,
                                   rtol=0, err_msg=k)
        noisy = int((np.abs(got - want) > 1e-5).sum())
        assert noisy <= max(1, got.size // 1000), (k, noisy, got.size)


@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_first_step_gradients_match_reference(arch, impl):
    """Every gradient leaf of the total loss, the router's included."""
    _, grads, batches = _train_runs(arch, impl)
    _, _, tcfg, tprm = _models(arch, impl)
    _, _, got = tsteps.loss_and_grads(tcfg, tprm, _tbatch(batches[0]))
    got = dict(tparams._leaves(got))
    assert got.keys() == grads.keys()
    assert any(k.endswith("router") for k in got)
    for k, w in grads.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=1e-6 + 1e-4 * scale, rtol=0,
                                   err_msg=k)


def _ce_only_grads(cfg, params, batch):
    """``loss_and_grads`` as the port computed it before it added the
    router's aux: the cross-entropy alone and its gradients."""
    p = {k: v for k, v in tparams._leaves(params)}
    leaves = [t.detach().requires_grad_(True) for t in p.values()]
    tree: dict = {}
    for k, t in zip(p, leaves):
        tparams._set(tree, k, t)
    logits, _ = TT.forward(cfg, tree, batch["tokens"])
    from repro_torch.optim import softmax_cross_entropy
    loss, _ = softmax_cross_entropy(logits, batch["labels"],
                                    batch.get("loss_mask"))
    return loss.detach(), dict(zip(p, torch.autograd.grad(
        loss, leaves, allow_unused=True)))


def test_step_without_the_aux_term_differs_from_reference():
    """Leaving the router's aux out of the loss misses the reference's
    total loss and router gradient by more than the tolerances above:
    the aux term is what makes the step match."""
    runs, grads, batches = _train_runs("mixtral-8x22b", None)
    _, _, tcfg, tprm = _models("mixtral-8x22b", None)
    loss, got = _ce_only_grads(tcfg, tprm, _tbatch(batches[0]))
    assert _rel(float(loss), runs[0][1]["total_loss"]) > 1e-5
    k = "layers/mlp/router"
    scale = float(np.abs(grads[k]).max())
    assert float(np.abs(got[k].numpy() - grads[k]).max()) > \
        1e-6 + 1e-4 * scale


# ----------------------------------------------------------------------
# configs and what still raises
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_full_config_matches_published(arch):
    """``tests/test_arch_smoke.py::test_full_config_matches_assignment``'s
    values, and the port's config equal to the reference's field for
    field, reduced too."""
    L, d, h, kv, ff, v = {
        "deepseek-v2-236b": (60, 5120, 128, 128, 1536, 102400),
        "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768)}[arch]
    cfg = tget(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.moe.d_ff_expert, cfg.vocab_size) == (L, d, h, kv, ff, v)
    if arch == "deepseek-v2-236b":
        assert (cfg.moe.num_experts, cfg.moe.top_k,
                cfg.moe.num_shared_experts, cfg.moe.first_moe_layer,
                cfg.mla.kv_lora_rank, cfg.attn_kind) == (
                    160, 6, 2, 1, 512, "mla")
    else:
        assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.window) == (
            8, 2, 4096)
    for reduced in (False, True):
        assert tget(arch, reduced) == torch_cfg(jget(arch, reduced))


@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_model_defs_match_reference(arch, impl):
    """Paths, shapes and dtypes of the port's bf16 param tree equal the
    reference's, from ``init_params`` and through ``from_jax_numpy``:
    the router, the (E, d, f) experts, shared experts, MLA's leaves and
    deepseek-v2's unrolled ``layer_00``."""
    jcfg, _, _, _ = _models(arch, impl)
    jcfg = jcfg.replace(dtype="bfloat16")
    want = {"/".join(str(k.key) for k in path): (tuple(a.shape),
                                                 str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(
                jparams.abstract_params(jcfg))[0]}
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in tparams._leaves(
               tparams.init_params(torch_cfg(jcfg), 0, device="cpu"))}
    assert got == want
    if arch == "deepseek-v2-236b":
        assert "layer_00/mlp/w_gate" in got
        assert "layers/attn/wkv_a" in got
        assert "layers/mlp/shared_w_down" in got


@pytest.mark.parametrize("arch", ["whisper-medium",
                                  "llava-next-mistral-7b"])
def test_audio_and_vision_still_raise(arch):
    """The audio and vision families are ported (their checks are
    ``tests/test_torch_frontends.py`` and
    ``tests/test_torch_model_audio_vision.py``); what still raises is a
    prefill without the inputs their frontends need: no frames for
    whisper, patches longer than the prompt for llava. Their param
    trees and caches build."""
    tcfg = torch_cfg(jget(arch, reduced=True).replace(dtype="float32"))
    prm = tparams.init_params(tcfg, 0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    if tcfg.frontend == "audio":
        with pytest.raises(ValueError, match="frame"):
            TT.prefill(tcfg, prm, tokens)
        cache = TT.init_cache(tcfg, 1, 8, device="cpu")
        assert set(cache) == {"dec_layers", "cross"}
    else:
        with pytest.raises(ValueError, match="patch"):
            TT.prefill(tcfg, prm, tokens,
                       torch.zeros((1, tcfg.num_patches, tcfg.d_model)))
        assert set(TT.init_cache(tcfg, 1, 8, device="cpu")) == {"layers"}
    assert tparams.model_defs(tcfg)
