"""The port's wave generators against the reference's on the CPU:
``prng.split`` bit for bit, the one-key-per-step draw
(``sample_token``), ``generate`` with and without per-row key streams,
``generate_samples``, ``tile_cache``, the page fork over every leaf of
the int8 page layout, and ``decode_paged`` over shared int8 prompt
pages. The fixture is ``paged_zoo``'s reduced smollm-135m (f32), with
dense and int8 caches; tokens must be equal, and logprobs agree to
1e-4: the f32 K/V of the two packages differ by float rounding, and in
an int8 cache a value on a rounding boundary quantises one code apart,
which moves a logit by a few 1e-5 (dense caches agree to about 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from harness.simulate import paged_zoo
from repro.sampling import sampler as JS
from repro_torch.models import params as tparams
from repro_torch.models import transformer as TT
from repro_torch.sampling import prng
from repro_torch.sampling import sampler as TS

LOGPROB_ATOL = 1e-4
PAGE = 8


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "int8"])
def zoo(request):
    probe, _ = paged_zoo(seed=0)
    jcfg = probe.cfg.replace(use_pallas=True, kv_quant=request.param)
    tcfg = torch_cfg(probe.cfg).replace(kv_quant=request.param)
    tprm = tparams.from_jax_numpy(
        tcfg, jax.tree.map(np.asarray, probe.params), device="cpu")
    return jcfg, probe.params, tcfg, tprm


def _same_output(tout, jout) -> None:
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.lengths.numpy(),
                                  np.asarray(jout.lengths))
    np.testing.assert_allclose(tout.logprobs.numpy(),
                               np.asarray(jout.logprobs),
                               atol=LOGPROB_ATOL, rtol=LOGPROB_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 99, 2**31 - 1])
def test_split_matches_jax_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    for n in (1, 2, 8, 33):
        np.testing.assert_array_equal(prng.split(np.asarray(key), n),
                                      np.asarray(jax.random.split(key, n)))
    sub = np.asarray(jax.random.split(key, 4))[3]
    np.testing.assert_array_equal(
        prng.split(sub, 5), np.asarray(jax.random.split(jnp.asarray(sub),
                                                         5)))


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_token_matches_reference(temperature):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(6, 37)) * 3).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = JS.sample_token(jnp.asarray(logits), temperature, key)
        got = TS.sample_token(torch.from_numpy(logits), temperature,
                              torch.from_numpy(np.asarray(key).astype(
                                  np.int64)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("row_keys", [False, True],
                         ids=["step_keys", "row_keys"])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_generate_matches_reference(zoo, temperature, row_keys):
    jcfg, jprm, tcfg, tprm = zoo
    rng = np.random.default_rng(int(temperature * 10) + row_keys)
    ids = rng.integers(3, tcfg.vocab_size, size=(4, 19)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    rk = np.asarray(JS.probe_row_keys(key, [3, 4], 2)) if row_keys \
        else None
    jout = JS.generate(jcfg, jprm, jnp.asarray(ids), max_new_tokens=5,
                       temperature=temperature, key=key, eos_id=2,
                       pad_id=0,
                       row_keys=None if rk is None else jnp.asarray(rk))
    tout = TS.generate(tcfg, tprm, ids, max_new_tokens=5,
                       temperature=temperature, key=np.asarray(key),
                       eos_id=2, pad_id=0, row_keys=rk)
    _same_output(tout, jout)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_generate_samples_matches_reference(zoo, temperature):
    jcfg, jprm, tcfg, tprm = zoo
    rng = np.random.default_rng(8)
    ids = rng.integers(3, tcfg.vocab_size, size=(3, 21)).astype(np.int32)
    key = jax.random.PRNGKey(2)
    jout = JS.generate_samples(jcfg, jprm, jnp.asarray(ids), 3,
                               max_new_tokens=6, temperature=temperature,
                               key=key)
    tout = TS.generate_samples(tcfg, tprm, ids, 3, max_new_tokens=6,
                               temperature=temperature,
                               key=np.asarray(key))
    _same_output(tout, jout)


def test_tile_cache_matches_reference(zoo):
    jcfg, jprm, tcfg, tprm = zoo
    ids = np.random.default_rng(0).integers(
        3, tcfg.vocab_size, size=(2, 9)).astype(np.int32)
    from repro.models import transformer as JT
    _, jc = JT.prefill(jcfg, jprm, jnp.asarray(ids), cache_len=12)
    _, tc = TT.prefill(tcfg, tprm, torch.from_numpy(ids), cache_len=12)
    jt = JS.tile_cache(jc, 3, batch=2)
    tt = TS.tile_cache(tc, 3, batch=2)
    for name, a in jt["layers"].items():
        assert tuple(tt["layers"][name].shape) == a.shape
        # row i's replicas are rows 3i..3i+2, each equal to row i
        for r in range(6):
            assert torch.equal(tt["layers"][name][:, r],
                               tc["layers"][name][:, r // 3])
    with pytest.raises(ValueError):
        TS.tile_cache(tc, 3, batch=5)


def _quant_pages(cfg, n_pages, rng):
    shape = (cfg.num_layers, n_pages, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    pages = {"k": rng.integers(-127, 128, size=shape).astype(np.int8),
             "v": rng.integers(-127, 128, size=shape).astype(np.int8),
             "k_scale": rng.uniform(0.01, 0.1, size=shape[:-1]).astype(
                 np.float32),
             "v_scale": rng.uniform(0.01, 0.1, size=shape[:-1]).astype(
                 np.float32)}
    return ({n: jnp.asarray(a) for n, a in pages.items()},
            {n: torch.from_numpy(a.copy()) for n, a in pages.items()})


def test_fork_pages_copies_every_quant_leaf(zoo):
    _, _, tcfg, _ = zoo
    jp, tp = _quant_pages(tcfg, 10, np.random.default_rng(1))
    src, dst = [2, 2, 5], [7, 8, 9]
    jp = JS.fork_pages(jp, jnp.asarray(src), jnp.asarray(dst))
    TS.fork_pages(tp, src, dst)
    assert set(tp) == {"k", "v", "k_scale", "v_scale"}
    for name in jp:
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
        assert torch.equal(tp[name][:, 7], tp[name][:, 2])


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_decode_paged_over_shared_quant_pages_matches_reference(
        temperature):
    """Three samples of each of two prompts decode over the prompt's
    shared int8 pages, each with its own tail pages, as the probe wave
    lays them out."""
    probe, _ = paged_zoo(seed=0)
    jcfg = probe.cfg.replace(use_pallas=True, kv_quant=True)
    tcfg = torch_cfg(probe.cfg).replace(kv_quant=True)
    tprm = tparams.from_jax_numpy(
        tcfg, jax.tree.map(np.asarray, probe.params), device="cpu")
    b, n, s, new = 2, 3, 16, 6
    rng = np.random.default_rng(3)
    ids = rng.integers(3, tcfg.vocab_size, size=(b, s)).astype(np.int32)
    n_shared = s // PAGE
    n_tail = -(-(s + new) // PAGE) - n_shared
    n_pages = b * n_shared + b * n * n_tail
    jp, tp = _quant_pages(tcfg, n_pages, rng)      # stale bytes
    prompt = np.arange(b * n_shared, dtype=np.int32).reshape(b, n_shared)
    jl, jp = JS.prefill_paged(jcfg, probe.params, jnp.asarray(ids), jp,
                              jnp.asarray(prompt))
    tl, tp = TS.prefill_paged(tcfg, tprm, torch.from_numpy(ids), tp,
                              torch.from_numpy(prompt))
    tails = b * n_shared + np.arange(b * n * n_tail, dtype=np.int32)
    table = np.concatenate([np.repeat(prompt, n, axis=0),
                            tails.reshape(b * n, n_tail)], axis=1)
    key = jax.random.PRNGKey(1)
    rk = np.asarray(JS.probe_row_keys(key, [0, 1], n))
    jout, jp = JS.decode_paged(
        jcfg, probe.params, jnp.repeat(jl, n, axis=0), jp,
        jnp.asarray(table), key, start_pos=s, max_new_tokens=new,
        temperature=temperature, row_keys=jnp.asarray(rk))
    tout, tp = TS.decode_paged(
        tcfg, tprm, torch.repeat_interleave(tl, n, dim=0), tp,
        torch.from_numpy(table), np.asarray(key), start_pos=s,
        max_new_tokens=new, temperature=temperature, row_keys=rk)
    _same_output(tout, jout)


def test_batch_invariant_matches_reference():
    from repro.configs.registry import all_configs
    for name, jc in all_configs(reduced=True).items():
        assert TS.batch_invariant(torch_cfg(jc)) == \
            JS.batch_invariant(jc), name
