"""The port's ring, recurrent-state and hybrid model math against the
reference on the CPU (ladder rung 2).

Over contiguous caches: one-shot ``prefill`` then ``decode_step`` of a
sliding-window smollm-135m (window 16, prompts shorter and longer than
the window, so the ring wraps), of reduced falcon-mamba-7b (ssm) and of
reduced recurrentgemma-2b (hybrid: two RG-LRU layers and one windowed
attention layer). Over the page pool: ``prefill_paged`` into ring pages
then ``decode_step_paged`` at per-row positions, and ``prefill_lanes``
into a lane arena then lane decode steps. The reference runs on
``use_pallas=True`` configs; its ring decode and its serving prefills of
the recurrent layers are plain there (no Pallas kernel), as the port's
are. Logits agree to 1e-5 and greedy tokens are equal. The page
layouts hold the contiguous caches' bytes: ``ring_compress``'s ring and
``prefill_lanes``' parked states are the contiguous path's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, torch_cfg
from repro.configs.registry import get_config as jget
from repro.data import tokenizer as jtok
from repro.models import params as jparams
from repro.models import transformer as JT
from repro.sampling import sampler as JS
from repro_torch.models import params as tparams
from repro_torch.models import transformer as TT
from repro_torch.sampling import sampler as TS

ATOL = 1e-5
PAGE = 8
WINDOW = 16

_jprefill = jax.jit(JT.prefill, static_argnames=("cfg", "cache_len"))
_jdecode = jax.jit(JT.decode_step, static_argnames=("cfg",))
_jdecode_paged = jax.jit(JT.decode_step_paged,
                         static_argnames=("cfg", "cache_len"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _model(arch: str, **kw):
    jcfg = jget(arch, reduced=True).replace(
        vocab_size=jtok.VOCAB_SIZE, dtype="float32", tie_embeddings=True,
        **kw)
    jprm = jparams.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = torch_cfg(jcfg)
    tprm = tparams.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jprm),
                                  device="cpu")
    return jcfg.replace(use_pallas=True), jprm, tcfg, tprm


MODELS = {
    "swa": lambda: _model("smollm-135m", window=WINDOW),
    "ssm": lambda: _model("falcon-mamba-7b"),
    "hybrid": lambda: _model("recurrentgemma-2b"),
}
_CACHE: dict = {}


def model(name: str):
    if name not in _CACHE:
        _CACHE[name] = MODELS[name]()
    return _CACHE[name]


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(
        3, jtok.VOCAB_SIZE, size=(b, s)).astype(np.int32)


def _close(got: torch.Tensor, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL, err_msg=msg)


def _greedy(jl, tl):
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert np.array_equal(tok, tl.argmax(-1).numpy())
    return tok


# ----------------------------------------------------------------------
# contiguous caches
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,s", [("swa", 10), ("swa", 23), ("ssm", 19),
                                    ("hybrid", 19)])
def test_prefill_and_decode_steps_match_reference(name, s):
    jcfg, jprm, tcfg, tprm = model(name)
    b, new = 2, 9                        # swa at s 10 wraps mid-decode
    ids = _ids(b, s, seed=s)
    jl, jc = _jprefill(jcfg, jprm, jnp.asarray(ids), cache_len=s + new)
    tl, tc = TT.prefill(tcfg, tprm, torch.from_numpy(ids),
                        cache_len=s + new)
    _close(tl, jl, "prefill")
    jleaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(jleaves) == sum(len(v) for v in tc.values())
    for path, a in jleaves:
        keys = [k.key for k in path]
        t = tc[keys[0]][keys[1]]
        assert tuple(t.shape) == a.shape, keys
        np.testing.assert_allclose(t.float().numpy(), np.asarray(a),
                                   atol=ATOL, rtol=ATOL, err_msg=str(keys))
    for step in range(new):
        tok = _greedy(jl, tl)
        jl, jc = _jdecode(jcfg, jprm, jc, jnp.asarray(tok),
                          jnp.int32(s + step))
        tl, tc = TT.decode_step(tcfg, tprm, tc, torch.from_numpy(tok),
                                s + step)
        _close(tl, jl, f"step {step}")
    _greedy(jl, tl)


@pytest.mark.parametrize("name", ["swa", "ssm", "hybrid"])
def test_init_cache_matches_reference(name):
    jcfg, _, tcfg, _ = model(name)
    want = JT.init_cache(jcfg, 3, 40)
    got = TT.init_cache(tcfg, 3, 40)
    jleaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(jleaves) == sum(len(v) for v in got.values())
    for path, a in jleaves:
        keys = [k.key for k in path]
        t = got[keys[0]][keys[1]]
        assert tuple(t.shape) == a.shape, keys
        assert str(t.dtype).split(".")[-1] == str(a.dtype), keys
        assert not t.any()


@pytest.mark.parametrize("s", [5, 16, 27])
def test_ring_compress_matches_reference(s):
    k = np.random.default_rng(s).normal(size=(2, s, 3, 4)).astype(
        np.float32)
    got = TT.ring_compress(torch.from_numpy(k), WINDOW)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JT.ring_compress(jnp.asarray(k), WINDOW)))


# ----------------------------------------------------------------------
# ring pages and lanes
# ----------------------------------------------------------------------
def _ring_pages(cfg, n_pages):
    shape = (cfg.num_layers, n_pages, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    jp = {"k": jnp.zeros(shape, jnp.float32),
          "v": jnp.zeros(shape, jnp.float32)}
    return jp, {n: torch.zeros(shape) for n in jp}


def _lanes(cfg, n_lanes):
    from repro.models import ssm as jssm
    d_in, _, n = jssm.ssm_dims(cfg)
    w = cfg.ssm.conv_width
    jp = {"conv": jnp.zeros((cfg.num_layers, n_lanes, w - 1, d_in)),
          "h": jnp.zeros((cfg.num_layers, n_lanes, d_in, n))}
    return jp, {n: torch.zeros(a.shape) for n, a in jp.items()}


@pytest.mark.parametrize("s", [11, 23])
def test_ring_pages_prefill_and_decode_match_reference(s):
    """Rows at different depths (per-row positions) decode over ring
    pages in a shuffled pool; the ring wraps in prefill (s 23) or
    during decode (s 11)."""
    jcfg, jprm, tcfg, tprm = model("swa")
    b, new = 3, 8
    cl = min(s + new, WINDOW)
    nb = -(-cl // PAGE)
    rng = np.random.default_rng(s)
    table = rng.permutation(b * nb + 2)[:b * nb].astype(
        np.int32).reshape(b, nb)
    ids = _ids(b, s, seed=7)
    jp, tp = _ring_pages(tcfg, b * nb + 2)
    jl, jp = JS.prefill_paged(jcfg, jprm, jnp.asarray(ids), jp,
                              jnp.asarray(table), cache_len=s + new)
    tl, tp = TS.prefill_paged(tcfg, tprm, torch.from_numpy(ids), tp,
                              torch.from_numpy(table), cache_len=s + new)
    _close(tl, jl, "prefill")
    # a row starts one step later than the next: per-row positions
    offs = np.arange(b)
    for step in range(new):
        tok = _greedy(jl, tl)
        pos = (s + np.minimum(step, new - 1 - offs)).astype(np.int32)
        jl, jp = _jdecode_paged(jcfg, jprm, jp, jnp.asarray(table),
                                jnp.asarray(tok), jnp.asarray(pos),
                                cache_len=s + new)
        tl, tp = TT.decode_step_paged(tcfg, tprm, tp,
                                      torch.from_numpy(table),
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos),
                                      cache_len=s + new)
        _close(tl, jl, f"step {step}")
    for n in jp:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=ATOL, rtol=ATOL, err_msg=n)


def test_lanes_prefill_and_decode_match_reference():
    jcfg, jprm, tcfg, tprm = model("ssm")
    b, s, new = 3, 17, 6
    lanes = np.asarray([4, 0, 2], np.int32)
    ids = _ids(b, s, seed=5)
    jp, tp = _lanes(tcfg, 6)
    jl, jp = JS.prefill_lanes(jcfg, jprm, jnp.asarray(ids), jp,
                              jnp.asarray(lanes))
    tl, tp = TS.prefill_lanes(tcfg, tprm, torch.from_numpy(ids), tp,
                              torch.from_numpy(lanes))
    _close(tl, jl, "prefill")
    table = lanes[:, None]
    for step in range(new):
        tok = _greedy(jl, tl)
        pos = np.full((b,), s + step, np.int32)
        jl, jp = _jdecode_paged(jcfg, jprm, jp, jnp.asarray(table),
                                jnp.asarray(tok), jnp.asarray(pos),
                                cache_len=s + new)
        tl, tp = TT.decode_step_paged(tcfg, tprm, tp,
                                      torch.from_numpy(table),
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos),
                                      cache_len=s + new)
        _close(tl, jl, f"step {step}")
    for n in jp:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=ATOL, rtol=ATOL, err_msg=n)
        # lanes no row holds stay zero
        assert not tp[n][:, [1, 3, 5]].any()


def test_ring_pages_hold_the_ring_cache_bytes():
    """Ring pages pack exactly the contiguous ring cache
    (``ring_compress``), position by position."""
    _, _, tcfg, tprm = model("swa")
    b, s, new = 2, 23, 4
    nb = -(-WINDOW // PAGE)
    ids = torch.from_numpy(_ids(b, s, seed=9))
    _, tp = _ring_pages(tcfg, b * nb)
    table = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    lp, tp = TT.prefill_paged(tcfg, tprm, ids, tp, table,
                              cache_len=s + new)
    lc, cache = TT.prefill(tcfg, tprm, ids, cache_len=s + new)
    assert torch.equal(lp, lc)
    for name, a in cache["layers"].items():
        pages = tp[name][:, table.long()]
        flat = pages.reshape((a.shape[0], b, nb * PAGE) + a.shape[3:])
        assert torch.equal(flat[:, :, :WINDOW], a), name


def test_lanes_hold_the_contiguous_state_bytes():
    """``prefill_lanes`` parks exactly the contiguous cache's states."""
    _, _, tcfg, tprm = model("ssm")
    ids = torch.from_numpy(_ids(2, 13, seed=4))
    _, tp = _lanes(tcfg, 4)
    lanes = torch.tensor([3, 1], dtype=torch.int32)
    lp, tp = TS.prefill_lanes(tcfg, tprm, ids, tp, lanes)
    lc, cache = TT.prefill(tcfg, tprm, ids)
    assert torch.equal(lp, lc)
    for name, a in cache["layers"].items():
        assert tp[name].dtype == a.dtype
        assert torch.equal(tp[name][:, lanes.long()], a), name


def test_tile_cache_covers_hybrid_and_ssm_caches():
    """``generate_samples`` tiles a hybrid cache's per-layer entries on
    their batch axis 0 and a stacked cache's on axis 1, as the
    reference's ``tile_cache`` does."""
    for name in ("hybrid", "ssm"):
        jcfg, _, tcfg, _ = model(name)
        jc = JT.init_cache(jcfg, 2, 9)
        tc = TT.init_cache(tcfg, 2, 9)
        want = JS.tile_cache(jc, 3, batch=2)
        got = TS.tile_cache(tc, 3, batch=2)
        for path, a in jax.tree_util.tree_flatten_with_path(want)[0]:
            keys = [k.key for k in path]
            assert tuple(got[keys[0]][keys[1]].shape) == a.shape, keys


@pytest.mark.parametrize("name", ["swa", "ssm", "hybrid"])
def test_generate_samples_matches_reference(name):
    """The wave's shared-prefix probe over contiguous caches: the same
    sampled tokens, logprobs and lengths at temperature 0.9."""
    from repro_torch.sampling import prng
    jcfg, jprm, tcfg, tprm = model(name)
    ids = _ids(2, 21, seed=1)
    key = jax.random.PRNGKey(7)
    want = JS.generate_samples(jcfg, jprm, jnp.asarray(ids), 3,
                               max_new_tokens=5, temperature=0.9, key=key)
    got = TS.generate_samples(tcfg, tprm, ids, 3, max_new_tokens=5,
                              temperature=0.9,
                              key=prng.prng_key(7))
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), atol=1e-4)
