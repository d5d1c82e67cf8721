"""The port's wave-path model math against the reference on the CPU:
one-shot prefill into a contiguous cache (dense and int8) followed by
decode steps over it, one-shot prefill into int8 pages followed by
paged decode steps, and the attention pieces under them.

The fixture is the reduced smollm-135m of
``tests/harness/simulate.py::paged_zoo`` (f32, 2 layers, head_dim 64, 3
query heads per kv head), converted leaf for leaf; the reference runs
on ``use_pallas=True`` configs so its ops reach the oracles the port's
plain versions port. Logits agree to 1e-5 and greedy tokens are equal.
int8 scales agree to 1e-6 relative. int8 codes are equal except where
a value sits on a rounding boundary: the two packages' f32 K/V differ
by float rounding (different matmul orders), so such a value may
round one code apart; each test counts those codes and holds them to
at most one in ten thousand, never more than one code apart.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from harness.simulate import paged_zoo
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro.sampling import sampler as JS
from repro_torch.models import attention as tattn
from repro_torch.models import params as tparams
from repro_torch.models import transformer as TT

ATOL = 1e-5
SCALE_RTOL = 1e-6
PAGE = 8
# codes allowed one apart, per code compared (see the module docstring)
MAX_CODE_FLIPS = 1e-4


def _zoo(kv_quant: bool):
    probe, _ = paged_zoo(seed=0)
    jcfg = probe.cfg.replace(use_pallas=True, kv_quant=kv_quant)
    tcfg = torch_cfg(probe.cfg).replace(kv_quant=kv_quant)
    tprm = tparams.from_jax_numpy(
        tcfg, jax.tree.map(np.asarray, probe.params), device="cpu")
    return jcfg, probe.params, tcfg, tprm


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "int8"])
def zoo(request):
    return _zoo(request.param)


@pytest.fixture(scope="module")
def qzoo():
    return _zoo(True)


def _check_leaf(name, got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, name
        assert (diff > 0).sum() <= MAX_CODE_FLIPS * diff.size, name
    elif name.endswith("_scale"):
        np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL,
                                   err_msg=name)


_jprefill = jax.jit(JT.prefill, static_argnames=("cfg", "cache_len"))
_jdecode = jax.jit(JT.decode_step, static_argnames=("cfg",))


# ----------------------------------------------------------------------
# contiguous cache: prefill + decode_step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,s,new", [(3, 21, 4), (4, 16, 3), (2, 9, 5)])
def test_prefill_and_decode_steps_match_reference(zoo, b, s, new):
    jcfg, jprm, tcfg, tprm = zoo
    rng = np.random.default_rng(b * s)
    ids = rng.integers(3, tcfg.vocab_size, size=(b, s)).astype(np.int32)
    jl, jc = _jprefill(jcfg, jprm, jnp.asarray(ids), cache_len=s + new)
    tl, tc = TT.prefill(tcfg, tprm, torch.from_numpy(ids),
                        cache_len=s + new)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    assert set(tc["layers"]) == set(jc["layers"])
    for name in jc["layers"]:
        _check_leaf(name, tc["layers"][name], jc["layers"][name])
    for step in range(new):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())
        jl, jc = _jdecode(jcfg, jprm, jc, jnp.asarray(tok),
                          jnp.int32(s + step))
        tl, tc = TT.decode_step(tcfg, tprm, tc, torch.from_numpy(tok),
                                s + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL, err_msg=f"step {step}")
    for name in jc["layers"]:
        _check_leaf(name, tc["layers"][name], jc["layers"][name])


def test_init_cache_matches_reference(zoo):
    jcfg, _, tcfg, _ = zoo
    for seq in (21, 512, 513, 1100):
        jc = JT.init_cache(jcfg, 2, seq)
        tc = TT.init_cache(tcfg, 2, seq)
        assert set(tc["layers"]) == set(jc["layers"])
        for name, a in jc["layers"].items():
            t = tc["layers"][name]
            assert tuple(t.shape) == a.shape, (seq, name)
            assert str(t.dtype).split(".")[-1] == str(a.dtype), name
            assert not t.any()
        assert TT._attn_cache_len(tcfg, seq) == \
            JT._attn_cache_len(jcfg, seq)


# ----------------------------------------------------------------------
# int8 pages: prefill_paged + decode_step_paged
# ----------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("cfg", "cache_len"))
def _jdecode_paged(cfg, params, pages, table, token, pos, *, cache_len):
    return JT.decode_step_paged(cfg, params, pages, table, token, pos,
                                cache_len=cache_len)


def _quant_pages(cfg, n_pages):
    shape = (cfg.num_layers, n_pages, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    jp = {"k": jnp.zeros(shape, jnp.int8), "v": jnp.zeros(shape, jnp.int8),
          "k_scale": jnp.zeros(shape[:-1], jnp.float32),
          "v_scale": jnp.zeros(shape[:-1], jnp.float32)}
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    return jp, tp


@pytest.mark.parametrize("per_row", [False, True],
                         ids=["wave_pos", "row_pos"])
def test_quant_prefill_paged_and_decode_match_reference(qzoo, per_row):
    jcfg, jprm, tcfg, tprm = qzoo
    b, s, new = 3, 21, 4
    nbp = -(-s // PAGE)
    nb = -(-(s + new) // PAGE) + 1           # one spare slot
    rng = np.random.default_rng(11)
    ids = rng.integers(3, tcfg.vocab_size, size=(b, s)).astype(np.int32)
    n_pages = b * nb + 2
    table = rng.permutation(b * nb).astype(np.int32).reshape(b, nb)
    jp, tp = _quant_pages(tcfg, n_pages)
    jl, jp = JS.prefill_paged(jcfg, jprm, jnp.asarray(ids), jp,
                              jnp.asarray(table[:, :nbp]))
    tl, tp = TT.prefill_paged(tcfg, tprm, torch.from_numpy(ids), tp,
                              torch.from_numpy(table[:, :nbp]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    for name in jp:
        _check_leaf(name, tp[name], jp[name])
    for step in range(new):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())
        pos = s + step
        jpos = jnp.full((b,), pos, jnp.int32) if per_row else jnp.int32(pos)
        tpos = torch.full((b,), pos, dtype=torch.int32) if per_row \
            else torch.tensor(pos, dtype=torch.int32)
        jl, jp = _jdecode_paged(jcfg, jprm, jp, jnp.asarray(table),
                                jnp.asarray(tok), jpos, cache_len=s + new)
        tl, tp = TT.decode_step_paged(tcfg, tprm, tp,
                                      torch.from_numpy(table),
                                      torch.from_numpy(tok), tpos,
                                      cache_len=s + new)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL, err_msg=f"step {step}")
    for name in jp:
        _check_leaf(name, tp[name], jp[name])


def test_quant_pages_hold_the_int8_cache_bytes(qzoo):
    """The quant page layout packs exactly what the contiguous int8
    cache holds: same ``quantize_kv`` codes and scales, position by
    position (the reference's bit-equivalence contract)."""
    _, _, tcfg, tprm = qzoo
    b, s = 2, 19
    nbp = -(-s // PAGE)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        3, tcfg.vocab_size, size=(b, s)).astype(np.int32))
    _, tp = _quant_pages(tcfg, b * nbp)
    table = torch.arange(b * nbp, dtype=torch.int32).reshape(b, nbp)
    lp, tp = TT.prefill_paged(tcfg, tprm, ids, tp, table)
    lc, cache = TT.prefill(tcfg, tprm, ids)
    assert torch.equal(lp, lc)
    for name, a in cache["layers"].items():
        pages = tp[name][:, table.long()]            # (L, B, nbp, ps, ..)
        flat = pages.reshape((a.shape[0], b, nbp * PAGE) + a.shape[3:])
        assert torch.equal(flat[:, :, :s], a), name


# ----------------------------------------------------------------------
# attention pieces
# ----------------------------------------------------------------------
def test_flash_attention_blockwise_and_full_match_reference():
    rng = np.random.default_rng(0)
    for s in (97, 1024):              # full-mask branch / 2 key blocks
        q = rng.normal(size=(1, s, 6, 32)).astype(np.float32)
        k = rng.normal(size=(1, s, 2, 32)).astype(np.float32)
        v = rng.normal(size=(1, s, 2, 32)).astype(np.float32)
        pos = np.arange(s, dtype=np.int32)
        for window in (None, 200):
            want = jattn.flash_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(pos), jnp.asarray(pos), window=window)
            got = tattn.flash_attention(
                torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v), torch.from_numpy(pos),
                torch.from_numpy(pos), window=window)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=ATOL,
                                       err_msg=f"s={s} window={window}")


def test_ring_decode_is_refused(zoo):
    """Ring (sliding-window) decode over a contiguous ring cache, once
    refused, now computes: at a position past the ring's length the
    token lands at slot pos mod S and attention masks by the position
    each slot holds, as the reference's ``gqa_decode(ring=True)``, on
    the dense and the int8 cache."""
    jcfg, jprm, tcfg, tprm = zoo
    b, ring, pos = 2, 8, 13
    rng = np.random.default_rng(5)
    jc = JT.init_cache(jcfg.replace(window=ring), b, 40)
    jc = {n: jnp.asarray(rng.normal(size=a.shape[1:]).astype(np.float32)
                         if a.dtype == jnp.float32 else
                         rng.integers(-127, 128, size=a.shape[1:]).astype(
                             np.int8))
          for n, a in jc["layers"].items()}
    if "k_scale" in jc:
        jc["k_scale"] = jnp.abs(jc["k_scale"]) * 0.01
        jc["v_scale"] = jnp.abs(jc["v_scale"]) * 0.01
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    jlp = jax.tree.map(lambda a: a[0], jprm["layers"]["attn"])
    tlp = {k: v[0] for k, v in tprm["layers"]["attn"].items()}
    x = rng.normal(size=(b, tcfg.d_model)).astype(np.float32)
    jy, jc = jattn.gqa_decode(jcfg, jlp, jnp.asarray(x), jc,
                              jnp.int32(pos), ring=True)
    ty, tc = tattn.gqa_decode(tcfg, tlp, torch.from_numpy(x), tc, pos,
                              ring=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    for name in jc:
        _check_leaf(name, tc[name], jc[name])
