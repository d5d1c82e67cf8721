"""The port's MoE dispatches (``models/moe.py``) and DeepSeek-V2's
multi-head latent attention (``attention.mla_*``) against the
reference's functions on the same numpy inputs, f32, reduced widths
(ladder rungs 1-2):

- ``router_topk`` (ties broken by the lower expert index, as
  ``jax.lax.top_k`` does), ``load_balance_aux``, ``moe_ffn`` at capacity
  1.25 (tokens dropped) and 8.0, ``moe_ffn_gather`` and
  ``moe_ffn_token`` (with and without shared experts), ``mla_attention``
  and ``mla_decode``: outputs within 1e-5, aux within 1e-6, expert
  indices equal.
- The reference's four gather-MoE properties
  (``tests/test_batch_invariant_ops.py``), held bitwise on the port's
  plain path: a token's bits do not depend on the batch's composition or
  order, a token decoded in a batch equals it decoded alone, and every
  expert goes through ``ops.fused_swiglu`` (in fixed 8-row blocks on the
  CPU).
- The f32 fused SwiGLU takes d_model up to 6144 (mixtral-8x22b's and
  granite-34b's width) and beyond (it runs the two stage kernels).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, torch_cfg
from repro.configs.registry import get_config as jget
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import params as jparams
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.blocking import TOKEN_BLOCK

TOL = 1e-5
AUX_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _moe_cfg(arch, **moe_kw):
    jcfg = jget(arch, reduced=True).replace(dtype="float32",
                                            use_pallas=True)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
    return jcfg, torch_cfg(jcfg)


@functools.lru_cache(maxsize=None)
def _moe_params(arch):
    """One MoE layer's params of the reduced config (the stacked
    layers' first), in both packages."""
    jcfg, _ = _moe_cfg(arch)
    prm = jparams.init_params(jcfg, jax.random.PRNGKey(2))["layers"]
    jp = jax.tree.map(lambda a: a[0], prm["mlp"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


@functools.lru_cache(maxsize=None)
def _mla_params():
    jcfg, _ = _moe_cfg("deepseek-v2-236b")
    jp = jparams.init_params(jcfg, jax.random.PRNGKey(4))["layer_00"]["attn"]
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg):
    """The reference function of ``cfg``, compiled once."""
    return jax.jit(functools.partial(fn, cfg))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    err = float(np.abs(got.detach().numpy() - np.asarray(want)).max())
    assert err <= tol, err


# ----------------------------------------------------------------------
# router
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 6])
def test_router_topk_matches_reference_with_ties(k):
    """Random softmax rows and rows with exact ties: equal expert
    indices (the lower index first among equal probabilities) and gates
    within 1e-6."""
    rng = np.random.default_rng(k)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.normal(size=(40, 8)).astype(np.float32)), axis=-1))
    ties = np.tile(np.float32([0.1, 0.2, 0.2, 0.05, 0.2, 0.1, 0.1,
                               0.05]), (4, 1))
    ties[1] = np.float32(0.125)
    ties[2, ::2] = np.float32(0.25)
    ties[2, 1::2] = 0.0
    ties[3] = ties[3][::-1]
    for p in (probs, ties):
        jg, ji = JM.router_topk(jnp.asarray(p), k)
        tg, ti = TM.router_topk(torch.from_numpy(p.copy()), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tg, jg, 1e-6)


def test_load_balance_aux_matches_reference():
    rng = np.random.default_rng(5)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.normal(size=(3, 11, 4)).astype(np.float32)), axis=-1))
    _, ji = JM.router_topk(jnp.asarray(probs), 2)
    want = JM.load_balance_aux(jnp.asarray(probs), ji, 4)
    got = TM.load_balance_aux(torch.from_numpy(probs.copy()),
                              torch.from_numpy(np.array(ji)), 4)
    assert abs(float(got) - float(want)) <= AUX_TOL


# ----------------------------------------------------------------------
# the three dispatches
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
@pytest.mark.parametrize("capacity", [1.25, 8.0])
def test_moe_ffn_capacity_matches_reference(arch, capacity):
    """The capacity dispatch over 2 x 23 tokens: at 1.25 some choices
    overflow their expert's bucket and are dropped (the output differs
    from 8.0's, where none are); both packages drop the same ones."""
    jcfg, tcfg = _moe_cfg(arch, capacity_factor=capacity)
    jp, tp = _moe_params(arch)
    # lean every token toward expert 0, so that its bucket overflows
    r0 = np.asarray(jp["router"])[:, 0]
    x = _x((2, 23, jcfg.d_model), 1) + 3.0 * r0 / float(r0 @ r0)
    want, waux = _jit(JM.moe_ffn, jcfg)(jp, jnp.asarray(x))
    got, aux = TM.moe_ffn(tcfg, tp, torch.from_numpy(x))
    _close(got, want)
    assert abs(float(aux) - float(waux)) <= AUX_TOL
    if capacity < 8.0:
        roomy, _ = _jit(JM.moe_ffn, _moe_cfg(arch, capacity_factor=8.0)[0])(
            jp, jnp.asarray(x))
        assert float(jnp.abs(roomy - want).max()) > 1e-3


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_ffn_gather_matches_reference(arch):
    jcfg, tcfg = _moe_cfg(arch, impl="gather")
    jp, tp = _moe_params(arch)
    x = _x((3, 7, jcfg.d_model), 2)
    want, waux = _jit(JM.moe_ffn_gather, jcfg)(jp, jnp.asarray(x))
    got, aux = TM.moe_ffn_gather(tcfg, tp, torch.from_numpy(x))
    _close(got, want)
    assert abs(float(aux) - float(waux)) <= AUX_TOL


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_ffn_token_matches_reference(arch):
    jcfg, tcfg = _moe_cfg(arch)
    jp, tp = _moe_params(arch)
    x = _x((5, jcfg.d_model), 3)
    want = _jit(JM.moe_ffn_token, jcfg)(jp, jnp.asarray(x))
    got = TM.moe_ffn_token(tcfg, tp, torch.from_numpy(x))
    _close(got, want)


# ----------------------------------------------------------------------
# MLA
# ----------------------------------------------------------------------
def test_mla_attention_matches_reference():
    """Full-sequence MLA: dk = nope + rope (48) for q and k, dv 32,
    scaled by 1/sqrt(48), causal over 19 positions."""
    jcfg, tcfg = _moe_cfg("deepseek-v2-236b")
    jp, tp = _mla_params()
    x = _x((2, 19, jcfg.d_model), 4)
    pos = np.arange(19, dtype=np.int32)
    want = _jit(JA.mla_attention, jcfg)(jp, jnp.asarray(x),
                                        jnp.asarray(pos))
    got = TA.mla_attention(tcfg, tp, torch.from_numpy(x),
                           torch.from_numpy(pos).long())
    _close(got, want)


@pytest.mark.parametrize("pos", [0, 9, 15])
def test_mla_decode_matches_reference(pos):
    """The absorbed-form decode over a 16-slot latent cache holding
    random values (slots past ``pos`` are masked): output within 1e-5,
    the cache written at ``pos`` and nowhere else, bit for bit."""
    jcfg, tcfg = _moe_cfg("deepseek-v2-236b")
    jp, tp = _mla_params()
    m = jcfg.mla
    x = _x((3, jcfg.d_model), 5 + pos)
    cache = {"c_kv": _x((3, 16, m.kv_lora_rank), 6),
             "k_rope": _x((3, 16, m.qk_rope_head_dim), 7)}
    want, wc = _jit(JA.mla_decode, jcfg)(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.int32(pos))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gc = TA.mla_decode(tcfg, tp, torch.from_numpy(x), tc, pos)
    _close(got, want)
    for k in cache:
        np.testing.assert_array_equal(np.delete(gc[k].numpy(), pos, 1),
                                      np.delete(cache[k], pos, 1))
        _close(gc[k][:, pos], np.asarray(wc[k])[:, pos], 1e-6)


# ----------------------------------------------------------------------
# the gather MoE's bit contract on the port's plain path
# ----------------------------------------------------------------------
def _gather_setup(seed, t, d=64):
    """The reference test's fixture: 4 experts of width 256, top 2, at
    d_model 64."""
    jcfg, tcfg = _moe_cfg("mixtral-8x22b", impl="gather")
    tcfg = tcfg.replace(d_model=d)
    rng = np.random.default_rng(seed)

    def mat(*shape):
        return torch.from_numpy(
            (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
                np.float32))

    p = {"router": mat(d, 4), "w_gate": mat(4, d, 256),
         "w_up": mat(4, d, 256), "w_down": mat(4, 256, d)}
    return tcfg.replace(moe=dataclasses.replace(
        tcfg.moe, num_experts=4, d_ff_expert=256)), p, mat(t, d)


@pytest.mark.parametrize("t,cuts,seed", [
    (1, (), 0), (9, (4,), 1), (17, (3, 11), 2), (24, (8, 23), 3),
    (21, (1, 20), 4)])
def test_gather_batch_composition_invariant(t, cuts, seed):
    cfg, p, x = _gather_setup(seed, t)
    full, _ = TM.moe_ffn_gather(cfg, p, x[None])
    bounds = sorted({c % t for c in cuts} | {0, t})
    pieces = [TM.moe_ffn_gather(cfg, p, x[a:b][None])[0][0]
              for a, b in zip(bounds, bounds[1:])]
    assert torch.equal(full[0], torch.cat(pieces))


@pytest.mark.parametrize("t,seed", [(2, 0), (13, 1), (24, 2)])
def test_gather_permutation_invariant(t, seed):
    cfg, p, x = _gather_setup(seed, t)
    perm = torch.from_numpy(
        np.random.default_rng(seed ^ 0x5bd1e995).permutation(t))
    y, _ = TM.moe_ffn_gather(cfg, p, x[None])
    yp, _ = TM.moe_ffn_gather(cfg, p, x[perm][None])
    assert torch.equal(y[0][perm], yp[0])


def test_gather_decode_matches_isolated_rows():
    cfg, p, x = _gather_setup(11, 7)
    batch = TT.mlp_apply_token(cfg, p, x)
    solo = torch.cat([TT.mlp_apply_token(cfg, p, x[i:i + 1])
                      for i in range(7)])
    assert torch.equal(batch, solo)


def test_gather_routes_experts_through_fused_swiglu(monkeypatch):
    """Every expert's SwiGLU (and the shared experts') goes through
    ``ops.fused_swiglu``, on the CPU in 8-row blocks, bit for bit the
    blocked plain oracle; prefill and decode alike."""
    calls = []
    real = ops.fused_swiglu

    def spy(x, wg, wu, wd):
        calls.append(tuple(x.shape))
        return real(x, wg, wu, wd)

    monkeypatch.setattr(ops, "fused_swiglu", spy)
    cfg, p, x = _gather_setup(5, 6)
    TM.moe_ffn_gather(cfg, p, x[None])
    assert calls == [(TOKEN_BLOCK, 64)] * 4
    calls.clear()
    TT.mlp_apply_token(cfg, p, x[:3])
    assert calls == [(TOKEN_BLOCK, 64)] * 4


# ----------------------------------------------------------------------
# the f32 fused SwiGLU's widths (any d_model since the stage route)
# ----------------------------------------------------------------------
def _meta(t, d, f):
    m = dict(device="meta", dtype=torch.float32)
    return (torch.empty(t, d, **m), torch.empty(d, f, **m),
            torch.empty(d, f, **m), torch.empty(f, d, **m))


@pytest.mark.parametrize("d", [4096, 5120, 6144])
def test_f32_swiglu_takes_d_model_up_to_6144(d):
    """deepseek-v2-236b's 5120 and mixtral-8x22b's 6144 pass the shape
    checks and raise only because ``meta`` has no kernel."""
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_swiglu(*_meta(8, d, 64))


def test_f32_swiglu_raises_above_6144():
    """The f32 route runs the two stage kernels, which stream x through
    shared memory and take any d_model: d 6400 and 8192 also pass the
    shape checks and raise only because ``meta`` has no kernel."""
    for d in (6400, 8192):
        with pytest.raises(ValueError, match="no kernel"):
            ops.fused_swiglu(*_meta(8, d, 64))
