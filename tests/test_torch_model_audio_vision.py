"""The audio and vision families at rungs 2 and 3 of the ladder: the
port's model entry points against the reference's on reduced f32
configs, params converted leaf for leaf from the reference's init, the
reference on ``use_pallas=True`` configs (its ops dispatch reaches the
oracles the port's plain versions port), the same numpy frames or
patches fed to both. Cases: whisper-medium (64 frames, 2 + 2 layers)
and llava-next-mistral-7b (16 patches, a 128-token window).

- ``forward``: logits within 1e-4.
- ``prefill`` and ``decode_step`` over the contiguous cache: logits
  within 1e-4 of the reference's at each step, and within 1e-4 of the
  port's own ``forward`` at the same positions (teacher forcing,
  ``tests/test_arch_smoke.py``'s check); whisper's prompt runs past its
  128-row learned position table, so positions wrap; the cross cache
  comes out of each decode step bit for bit as it went in.
- an audio prefill without frames, or patches longer than the prompt,
  raise ``ValueError``.
- ``generate`` greedy: equal tokens; ``generate_samples(n=3)`` at
  temperature 0.9 with the reference's key: equal tokens, logprobs
  within 1e-4 (this reaches ``tile_cache``'s ``dec_layers`` and
  ``cross`` rule).
- ``make_train_step`` with ``frontend_embeds``: loss, token accuracy
  and grad_norm relative 1e-5; every gradient leaf at atol 1e-6 + 1e-4
  of its largest magnitude; params after the step at
  ``tests/test_torch_train.py``'s tolerances (atol 1e-5 where the
  reference's |gradient| exceeds 1e-6; noisy elements under 0.1%).
- ``train(arch, steps=2, device="cpu")``: finite losses.
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
from repro.sampling import sampler as JS
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import params as tparams
from repro_torch.models import transformer as TT
from repro_torch.optim import init as topt_init
from repro_torch.sampling import sampler as TS

ARCHS = ("whisper-medium", "llava-next-mistral-7b")
B = 2
TOL = 1e-4
LOGPROB_ATOL = 1e-4
TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jget(arch, reduced=True).replace(dtype="float32",
                                            use_pallas=True)
    jprm = jparams.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = torch_cfg(jcfg)
    tprm = tparams.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jprm),
                                  device="cpu")
    return jcfg, jprm, tcfg, tprm


def _frontend(cfg, b=B, seed=0):
    """The same frames (B, F, d) or patches (B, P, d), scale 0.02, for
    both packages."""
    n = cfg.encoder.num_frames if cfg.frontend == "audio" \
        else cfg.num_patches
    return (np.random.default_rng(100 + seed).standard_normal(
        (b, n, cfg.d_model)) * 0.02).astype(np.float32)


def _ids(cfg, s, b=B, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _err(got, want):
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, jprm, tcfg, tprm = _models(arch)
    ids, fe = _ids(tcfg, 24), _frontend(tcfg)
    want, _ = jax.jit(functools.partial(JT.forward, jcfg))(
        jprm, jnp.asarray(ids), jnp.asarray(fe))
    with torch.no_grad():
        got, aux = TT.forward(tcfg, tprm, torch.from_numpy(ids),
                              torch.from_numpy(fe))
    assert tuple(got.shape) == (B, 24, tcfg.vocab_size)
    assert float(aux) == 0
    assert _err(got, want) <= TOL


# whisper's prompt crosses its 128-row position table while decoding
PROMPT = {"whisper-medium": 124, "llava-next-mistral-7b": 24}
STEPS = 6


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill the prompt into a cache of prompt + 8 positions and
    decode 6 teacher-forced tokens: logits within 1e-4 of the
    reference's and of the port's ``forward`` at each step; whisper's
    cross cache unchanged, bit for bit, by every step."""
    jcfg, jprm, tcfg, tprm = _models(arch)
    s = PROMPT[arch]
    ids, fe = _ids(tcfg, s + STEPS, seed=1), _frontend(tcfg, seed=1)
    jl, jc = JT.prefill(jcfg, jprm, jnp.asarray(ids[:, :s]),
                        jnp.asarray(fe), cache_len=s + 8)
    with torch.no_grad():
        full, _ = TT.forward(tcfg, tprm, torch.from_numpy(ids),
                             torch.from_numpy(fe))
        tl, tc = TT.prefill(tcfg, tprm, torch.from_numpy(ids[:, :s]),
                            torch.from_numpy(fe), cache_len=s + 8)
    assert set(tc) == set(jc)
    for k in tc:
        for n in tc[k]:
            assert tuple(tc[k][n].shape) == jc[k][n].shape, (k, n)
            assert _err(tc[k][n], jc[k][n]) <= TOL, (k, n)
    assert _err(tl, jl) <= TOL
    assert _err(tl, full[:, s - 1]) <= TOL
    step = jax.jit(functools.partial(JT.decode_step, jcfg))
    for i in range(STEPS):
        cross = ({n: t.clone() for n, t in tc["cross"].items()}
                 if "cross" in tc else None)
        jl, jc = step(jprm, jc, jnp.asarray(ids[:, s + i]),
                      jnp.int32(s + i))
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, tprm, tc,
                                    torch.from_numpy(ids[:, s + i]), s + i)
        assert _err(tl, jl) <= TOL, i
        if i < STEPS - 1:
            assert _err(tl, full[:, s + i]) <= TOL, i
        if cross is not None:
            for n, t in cross.items():
                assert torch.equal(tc["cross"][n], t), (i, n)
    if arch == "whisper-medium":
        assert s + STEPS > tcfg.max_position


def test_frontend_inputs_are_checked():
    jcfg, jprm, tcfg, tprm = _models("whisper-medium")
    ids = torch.from_numpy(_ids(tcfg, 8))
    with pytest.raises(ValueError, match="frame"):
        TT.prefill(tcfg, tprm, ids)
    with pytest.raises(ValueError, match="frame"):
        TT.forward(tcfg, tprm, ids)
    _, _, vcfg, vprm = _models("llava-next-mistral-7b")
    short = torch.from_numpy(_ids(vcfg, vcfg.num_patches - 1))
    with pytest.raises(ValueError, match="patch"):
        TT.prefill(vcfg, vprm, short, torch.from_numpy(_frontend(vcfg)))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    jcfg, jprm, tcfg, tprm = _models(arch)
    ids, fe = _ids(tcfg, 19, seed=2), _frontend(tcfg, seed=2)
    key = jax.random.PRNGKey(5)
    jout = JS.generate(jcfg, jprm, jnp.asarray(ids), max_new_tokens=6,
                       temperature=0.0, key=key, eos_id=-1, pad_id=0,
                       frontend_embeds=jnp.asarray(fe))
    with torch.no_grad():
        tout = TS.generate(tcfg, tprm, ids, max_new_tokens=6,
                           temperature=0.0, key=np.asarray(key),
                           eos_id=-1, pad_id=0,
                           frontend_embeds=torch.from_numpy(fe))
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_samples_matches_reference(arch):
    jcfg, jprm, tcfg, tprm = _models(arch)
    ids, fe = _ids(tcfg, 18, seed=3), _frontend(tcfg, seed=3)
    key = jax.random.PRNGKey(7)
    jout = JS.generate_samples(jcfg, jprm, jnp.asarray(ids), 3,
                               max_new_tokens=5, temperature=0.9, key=key,
                               eos_id=-1, pad_id=0,
                               frontend_embeds=jnp.asarray(fe))
    with torch.no_grad():
        tout = TS.generate_samples(tcfg, tprm, ids, 3, max_new_tokens=5,
                                   temperature=0.9, key=np.asarray(key),
                                   eos_id=-1, pad_id=0,
                                   frontend_embeds=torch.from_numpy(fe))
    assert tuple(tout.tokens.shape) == (3 * B, 5)
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))
    np.testing.assert_allclose(tout.logprobs.numpy(),
                               np.asarray(jout.logprobs),
                               atol=LOGPROB_ATOL, rtol=LOGPROB_ATOL)


def test_tile_cache_checks_the_audio_batch_axis():
    _, _, tcfg, tprm = _models("whisper-medium")
    cache = TT.init_cache(tcfg, B, 12, device="cpu")
    tiled = TS.tile_cache(cache, 3, batch=B)
    assert tuple(tiled["cross"]["k"].shape)[:2] == (tcfg.num_layers, 3 * B)
    assert tuple(tiled["dec_layers"]["v"].shape)[:2] == (tcfg.num_layers,
                                                         3 * B)
    with pytest.raises(ValueError, match="batch"):
        TS.tile_cache(cache, 3, batch=B + 1)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@functools.lru_cache(maxsize=None)
def _train_run(arch):
    """Both packages' first step from the same params on the same batch
    and frontend inputs, and the reference's gradient of its loss."""
    jcfg, jprm, tcfg, tprm = _models(arch)
    b = next(synthetic_lm_batches(B, 24, tcfg.vocab_size, seed=3))
    fe = _frontend(tcfg, seed=4)
    jb = {"tokens": jnp.asarray(b.tokens), "labels": jnp.asarray(b.labels),
          "loss_mask": jnp.asarray(b.loss_mask),
          "frontend_embeds": jnp.asarray(fe)}
    tb = {"tokens": torch.from_numpy(b.tokens),
          "labels": torch.from_numpy(b.labels),
          "loss_mask": torch.from_numpy(b.loss_mask),
          "frontend_embeds": torch.from_numpy(fe)}
    jp, _, jm = jax.jit(jmake_train_step(jcfg, JTrainConfig(**TC)))(
        jprm, jopt_init(jprm), jb)
    tp, _, tm = tsteps.make_train_step(tcfg, TrainConfig(**TC))(
        tprm, topt_init(tprm), tb)

    def loss(p):
        logits, _ = JT.forward(jcfg, p, jb["tokens"], jb["frontend_embeds"])
        return jxent(logits, jb["labels"], jb["loss_mask"])[0]

    grads = _flat(jax.jit(jax.grad(loss))(jprm))
    return ((_flat(jp), {k: float(v) for k, v in jm.items()}),
            (dict(tparams._leaves(tp)), {k: float(v) for k, v in tm.items()}),
            grads, tb)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    (jp, jm), (tp, tm), grads, _ = _train_run(arch)
    for k in ("loss", "grad_norm", "token_accuracy"):
        assert _rel(tm[k], jm[k]) <= 1e-5, (k, tm[k], jm[k])
    assert tp.keys() == jp.keys()
    for k, g in grads.items():
        got, want = tp[k].numpy(), jp[k]
        sure = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5,
                                   rtol=0, err_msg=k)
        noisy = int((np.abs(got - want) > 1e-5).sum())
        assert noisy <= max(1, got.size // 1000), (k, noisy, got.size)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_gradients_match_reference(arch):
    """Every gradient leaf; whisper's encoder, cross-attention, biases
    and learned positions among them."""
    _, _, grads, tb = _train_run(arch)
    _, _, tcfg, tprm = _models(arch)
    _, _, got = tsteps.loss_and_grads(tcfg, tprm, tb)
    got = dict(tparams._leaves(got))
    assert got.keys() == grads.keys()
    if arch == "whisper-medium":
        for k in ("enc_layers/attn/wq", "dec_layers/cross/wk",
                  "dec_layers/mlp/b_in", "enc_final_norm/bias", "dec_pos"):
            assert float(np.abs(grads[k]).max()) > 0, k
    for k, w in grads.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=1e-6 + 1e-4 * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_entry_point_runs(arch):
    """``train()`` passes synthetic frames or patches on every step."""
    from repro_torch.launch.train import train
    cfg, prm, met = train(arch=arch, steps=2, device="cpu", verbose=False)
    assert np.isfinite(float(met["loss"])) and float(met["loss"]) > 0
    assert cfg.frontend in ("audio", "vision")
