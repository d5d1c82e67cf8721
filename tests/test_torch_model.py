"""The port's model math against the reference on the CPU.

The fixture is the reference's own: the reduced smollm-135m of
``tests/harness/simulate.py::paged_zoo`` (f32, 2 layers, head_dim 64,
3 query heads per kv head, pages of 8). Its params convert leaf for
leaf (``from_jax_numpy``); the reference runs with ``use_pallas=True``
configs so its ops dispatch reaches the ``kernels/ref.py`` oracles the
port's plain versions port. Logits agree to 1e-5 and greedy tokens are
equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from harness.simulate import paged_zoo
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import transformer as JT
from repro.sampling import sampler as JS
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import transformer as TT
from repro_torch.models.blocking import TOKEN_BLOCK, blocked_rows
from repro_torch.serving.kv_pool import PagedKVServer

ATOL = 1e-5
PAGE = 8


@pytest.fixture(scope="module")
def zoo():
    probe, _ = paged_zoo(seed=0)
    jcfg = probe.cfg.replace(use_pallas=True)
    tcfg = torch_cfg(probe.cfg)
    tparams_ = tparams.from_jax_numpy(
        tcfg, jax.tree.map(np.asarray, probe.params), device="cpu")
    return jcfg, probe.params, tcfg, tparams_


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------
def test_from_jax_numpy_is_leaf_for_leaf(zoo):
    jcfg, jprm, tcfg, tprm = zoo
    jleaves = {"/".join(str(k.key) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_flatten_with_path(
                   jprm)[0]}
    tleaves = dict(tparams._leaves(tprm))
    assert set(jleaves) == set(tleaves)
    for path, a in jleaves.items():
        t = tleaves[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == str(a.dtype), path
        np.testing.assert_array_equal(t.numpy(), a, err_msg=path)


def test_from_jax_numpy_keeps_bf16_bits():
    from repro.configs.registry import get_config as jget
    jcfg = jget("smollm-135m", reduced=True).replace(vocab_size=19)
    prm = jparams.init_params(jcfg, jax.random.PRNGKey(1))
    tprm = tparams.from_jax_numpy(torch_cfg(jcfg),
                                  jax.tree.map(np.asarray, prm),
                                  device="cpu")
    a = np.asarray(prm["layers"]["mlp"]["w_gate"])
    t = tprm["layers"]["mlp"]["w_gate"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


def test_from_jax_numpy_rejects_a_wrong_tree(zoo):
    jcfg, jprm, tcfg, _ = zoo
    tree = jax.tree.map(np.asarray, jprm)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        tparams.from_jax_numpy(tcfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray, jprm)
    tree["embedding"] = tree["embedding"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        tparams.from_jax_numpy(tcfg, tree, device="cpu")


def test_init_params_matches_the_reference_tree_and_scales():
    cfg = get_config("smollm-135m", reduced=True)
    prm = tparams.init_params(cfg, 0, device="cpu")
    again = tparams.init_params(cfg, 0, device="cpu")
    from repro.configs.registry import get_config as jget
    jshapes = jax.eval_shape(
        lambda: jparams.init_params(jget("smollm-135m", reduced=True),
                                    jax.random.PRNGKey(0)))
    jflat = {"/".join(str(k.key) for k in p): v.shape for p, v in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    leaves = dict(tparams._leaves(prm))
    assert {p: tuple(t.shape) for p, t in leaves.items()} == jflat
    for path, t in leaves.items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, dict(tparams._leaves(again))[path]), path
    assert torch.all(prm["final_norm"]["scale"] == 1)
    wq = prm["layers"]["attn"]["wq"].float()
    assert abs(float(wq.std()) - 0.02) < 2e-3
    # the config's analytic count leaves out the final norm's scale
    assert tparams.count_params(prm) == cfg.param_count() + cfg.d_model


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         1e-5).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                    1e-5)), atol=ATOL, rtol=ATOL)
    pos = np.stack([np.arange(5), np.arange(90, 95)]).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10000.0)), atol=1e-4, rtol=ATOL)


@pytest.mark.parametrize("rows", [1, 7, 8, 13])
def test_blocked_swiglu_matches_reference(zoo, rows):
    jcfg, jprm, tcfg, tprm = zoo
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, tcfg.d_model)).astype(np.float32)
    jmlp = jax.tree.map(lambda a: a[0], jprm["layers"]["mlp"])
    tmlp = {k: v[0] for k, v in tprm["layers"]["mlp"].items()}
    np.testing.assert_allclose(
        tlayers.swiglu_mlp(tmlp, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.swiglu_mlp(jmlp, jnp.asarray(x))),
        atol=ATOL, rtol=ATOL)


def test_blocked_rows_is_row_local():
    """A row's output does not depend on the other rows in its call."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(21, 16)).astype(np.float32))
    full = blocked_rows(lambda xb: xb @ w, x)
    assert full.shape == (21, 32)
    for r in (0, 8, 20):
        alone = blocked_rows(lambda xb: xb @ w, x[r:r + 1])
        assert torch.equal(full[r], alone[0])
    assert TOKEN_BLOCK == 8


def test_resolve_layout_matches_reference():
    from repro.configs.registry import all_configs
    for name, jc in all_configs(reduced=True).items():
        assert TT.resolve_layout(torch_cfg(jc)) == JT.resolve_layout(jc), \
            name


# ----------------------------------------------------------------------
# chunked prefill + decode step
# ----------------------------------------------------------------------
def _page_state(cfg, b, s, max_new):
    """Zeroed page pools for both packages and block tables of distinct
    pages per row (one spare slot past the decode horizon)."""
    nb = -(-(s + max_new) // PAGE) + 1
    n_pages = b * nb + 2
    shape = (cfg.num_layers, n_pages, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    rng = np.random.default_rng(7)
    table = rng.permutation(b * nb).astype(np.int32).reshape(b, nb)
    jpages = {"k": jnp.zeros(shape, jnp.float32),
              "v": jnp.zeros(shape, jnp.float32)}
    tpages = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    return table, jpages, tpages


@functools.partial(jax.jit, static_argnames=("cfg", "cache_len"))
def _jdecode(cfg, params, pages, table, token, pos, *, cache_len):
    return JT.decode_step_paged(cfg, params, pages, table, token, pos,
                                cache_len=cache_len)


def _chunked_prefill_both(zoo, ids, starts_per_call, s, table, jpages,
                          tpages):
    """Feed the prompts chunk by chunk through both packages: each call
    takes a subset of rows at their own depths (mixed-depth rows share
    one call, as the step loop batches them)."""
    jcfg, jprm, tcfg, tprm = zoo
    jlg = tlg = None
    for rows, start, c in starts_per_call:
        toks = ids[rows, start:start + c]
        st = np.full(len(rows), start, np.int32)
        jl, jpages = JS.prefill_chunk_paged(
            jcfg, jprm, jnp.asarray(toks), jpages,
            jnp.asarray(table[rows]), jnp.asarray(st), prompt_len=s)
        tl, tpages = TT.prefill_chunk_paged(
            tcfg, tprm, torch.from_numpy(toks), tpages,
            torch.from_numpy(table[rows]), torch.from_numpy(st),
            prompt_len=s)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=ATOL, rtol=ATOL)
        jlg, tlg = jl, tl
    return jlg, tlg, jpages, tpages


def _written(pages, table, s, cfg):
    """Each row's first ``s`` positions, gathered from the pages."""
    a = np.asarray(pages)
    b, nb = table.shape
    g = a[:, table].reshape(cfg.num_layers, b, nb * PAGE, -1)
    return g[:, :, :s]


def test_prefill_chunk_paged_matches_reference(zoo):
    jcfg, jprm, tcfg, tprm = zoo
    b, s = 3, 21
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 19, size=(b, s)).astype(np.int32)
    table, jpages, tpages = _page_state(tcfg, b, s, 6)
    # rows 0,1 start together; row 2 trails by one chunk, so the middle
    # calls mix depths 8/0 and 16/8
    calls = [([0, 1], 0, 8), ([2], 0, 8), ([0, 1], 8, 8), ([2], 8, 8),
             ([0, 1, 2], 16, 5)]
    _, _, jpages, tpages = _chunked_prefill_both(
        zoo, ids, calls, s, table, jpages, tpages)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _written(tpages[name].numpy(), table, s, tcfg),
            _written(jpages[name], table, s, tcfg), atol=ATOL, rtol=ATOL)


def test_prefill_rejects_the_flash_block_grid(zoo):
    _, _, tcfg, tprm = zoo
    pages = {"k": torch.zeros(2, 130, 8, 1, 64),
             "v": torch.zeros(2, 130, 8, 1, 64)}
    with pytest.raises(ValueError, match="flash-block"):
        TT.prefill_chunk_paged(
            tcfg, tprm, torch.zeros(1, 8, dtype=torch.int32), pages,
            torch.zeros(1, 128, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), prompt_len=1024)


def test_decode_steps_match_reference_at_per_row_positions(zoo):
    jcfg, jprm, tcfg, tprm = zoo
    b, s, max_new = 3, 21, 6
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 19, size=(b, s)).astype(np.int32)
    table, jpages, tpages = _page_state(tcfg, b, s, max_new)
    calls = [([0, 1, 2], 0, 8), ([0, 1, 2], 8, 8), ([0, 1, 2], 16, 5)]
    jl, tl, jpages, tpages = _chunked_prefill_both(
        zoo, ids, calls, s, table, jpages, tpages)
    # rows advance unevenly: row r has decoded r tokens already, so one
    # batch decodes at positions s, s+1, s+2 (per-row pos)
    pos = np.asarray([s, s, s], np.int32)
    jtab, ttab = jnp.asarray(table), torch.from_numpy(table)
    for step in range(max_new):
        jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
        ttok = torch.argmax(tl, -1).numpy().astype(np.int32)
        np.testing.assert_array_equal(ttok, jtok)
        live = np.arange(b) <= step            # row r starts at step r
        p = np.where(live, pos, s)
        jl2, jpages = _jdecode(jcfg, jprm, jpages, jtab,
                               jnp.asarray(jtok), jnp.asarray(p),
                               cache_len=s + max_new)
        tl2, tpages = TT.decode_step_paged(
            tcfg, tprm, tpages, ttab, torch.from_numpy(ttok),
            torch.from_numpy(p), cache_len=s + max_new)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2),
                                   atol=ATOL, rtol=ATOL)
        pos = np.where(live, pos + 1, pos)
        jl = jnp.where(jnp.asarray(live)[:, None], jl2, jl)
        tl = torch.where(torch.from_numpy(live)[:, None], tl2, tl)


def test_paged_server_allocates_dense_pages_on_its_device(zoo):
    _, _, tcfg, _ = zoo
    srv = PagedKVServer(tcfg, page_size=PAGE, prefix_cache_entries=4,
                        device="cpu")
    srv.ensure_capacity_stream(4, 21, 4, 6)
    g = srv.row_geometry(21, 6)
    assert (g.n_shared, g.tail_tokens, g.nbp, g.nb, g.n_tail) == (
        2, 5, 3, 4, 2)
    need = 4 * (3 + 4 * 2) + 4 * 3 + 4
    assert srv.pool.num_pages == need
    assert srv.pages["k"].shape == (tcfg.num_layers, need, PAGE,
                                    tcfg.num_kv_heads,
                                    tcfg.resolved_head_dim)
    assert srv.pages["k"].dtype == torch.float32
    assert srv.pages["k"].device.type == "cpu"
    assert srv.stats.page_bytes == (tcfg.num_layers * PAGE
                                    * tcfg.num_kv_heads * 2
                                    * tcfg.resolved_head_dim * 4)
    # a sliding-window config gets ring pages: a row holds its
    # window-capped snapshot privately, no prompt page is shared
    ring = PagedKVServer(tcfg.replace(window=16), device="cpu")
    assert ring.layout == "ring" and ring.prefix_cache_entries == 0
    g = ring.row_geometry(21, 6)
    assert (g.n_shared, g.tail_tokens, g.nbp, g.nb, g.n_tail,
            g.cache_len) == (0, 0, 2, 2, 2, 16)


def _prefilled(zoo, b, s, max_new, seed):
    jcfg, jprm, tcfg, tprm = zoo
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 19, size=(b, s)).astype(np.int32)
    table, jpages, tpages = _page_state(tcfg, b, s, max_new)
    calls = [(list(range(b)), st, min(8, s - st)) for st in range(0, s, 8)]
    jl, tl, jpages, tpages = _chunked_prefill_both(
        zoo, ids, calls, s, table, jpages, tpages)
    return table, jl, tl, jpages, tpages


def _lane_state(b, s, seed):
    """Per-row positions, step counters, done bits and key streams of a
    mixed decode bucket (the last row a finished lane)."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(0, 3, size=b).astype(np.int32)
    pos = (s + steps).astype(np.int32)
    done = np.zeros(b, bool)
    done[-1] = True
    keys = np.asarray(JS.probe_row_keys(jax.random.PRNGKey(0), range(b), 1))
    return pos, steps, done, keys


def test_decode_step_rows_matches_reference(zoo):
    jcfg, jprm, tcfg, tprm = zoo
    b, s, max_new = 4, 21, 6
    table, jl, tl, jpages, tpages = _prefilled(zoo, b, s, max_new, 5)
    pos, steps, done, keys = _lane_state(b, s, 5)
    from repro_torch.sampling import sampler as TS
    jout = JS.decode_step_rows(
        jcfg, jprm, jl, jpages, jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(keys), jnp.asarray(steps), jnp.asarray(done),
        cache_len=s + max_new, temperature=0.9, eos_id=2, pad_id=0)
    tout = TS.decode_step_rows(
        tcfg, tprm, tl, tpages, torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(steps), torch.from_numpy(done),
        cache_len=s + max_new, temperature=0.9, eos_id=2, pad_id=0)
    for name, i in (("emit", 0), ("live", 2), ("new_done", 3)):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]),
                                      err_msg=name)
    for name, i in (("logprob", 1), ("next_logits", 4)):
        np.testing.assert_allclose(tout[i].numpy(), np.asarray(jout[i]),
                                   atol=ATOL, rtol=ATOL, err_msg=name)


@pytest.mark.parametrize("n_ticks", [1, 3])
def test_decode_megastep_rows_matches_reference(zoo, n_ticks):
    """K fused ticks: the same emits and done bits, logits and written
    pages to 1e-5 (dead lanes clamp their writes into their own tail)."""
    jcfg, jprm, tcfg, tprm = zoo
    b, s, max_new = 4, 21, 4
    table, jl, tl, jpages, tpages = _prefilled(zoo, b, s, max_new, 9)
    pos, steps, done, keys = _lane_state(b, s, 9)
    from repro_torch.sampling import sampler as TS
    je, jd, jlg, jpages = JS.decode_megastep_rows(
        jcfg, jprm, jl, jpages, jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(keys), jnp.asarray(steps), jnp.asarray(done),
        n_ticks=n_ticks, cache_len=s + max_new, temperature=0.9, eos_id=2,
        pad_id=0)
    te, td, tlg, tpages = TS.decode_megastep_rows(
        tcfg, tprm, tl, tpages, torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(steps), torch.from_numpy(done), n_ticks=n_ticks,
        cache_len=s + max_new, temperature=0.9, eos_id=2, pad_id=0)
    assert tuple(te.shape) == (n_ticks, b)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=ATOL,
                               rtol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _written(tpages[name].numpy(), table, s + max_new, tcfg),
            _written(jpages[name], table, s + max_new, tcfg),
            atol=ATOL, rtol=ATOL)
