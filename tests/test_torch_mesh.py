"""The port's serving mesh on the CPU: ``ShardedPagedKVServer``'s host
invariants (``tests/test_sharded_serving.py``'s), ``ServingMesh`` and
``launch.mesh`` (forced devices, placement, a failing cell), kernel 3's
two stages, and ladder rung 2 under tensor parallelism — the sampler's
sharded programs at model=2 give the single-device program's logits,
tokens and pages bit for bit, and the reference's within 1e-5."""
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                                    # pragma: no cover
    from _propshim import given, settings
    from _propshim import strategies as st

import _torch_port as tp
from repro_torch.launch import mesh as lmesh
from repro_torch.serving.kv_pool import (
    PageAccountingError, PagePoolError, PoolExhausted)


@pytest.fixture
def cpu_devices():
    lmesh.force_device_count(4, "cpu")
    yield
    lmesh.clear_forced_devices()


# ----------------------------------------------------------------------
# per-shard pool invariants (host state only)
# ----------------------------------------------------------------------
def _host_only_sharded_server(n_shards=4, num_pages=24, scratch_pages=2,
                              page_size=4, n_model=1):
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.mesh import ShardedPagedKVServer, _ShardView
    cfg = get_config("smollm-135m", reduced=True).replace(
        dtype="float32", tie_embeddings=True)
    srv = ShardedPagedKVServer.__new__(ShardedPagedKVServer)
    srv.cfg = cfg
    srv.smesh = types.SimpleNamespace(n_shards=n_shards, n_model=n_model)
    srv.page_size = page_size
    srv.pages = None
    srv.shards = [_ShardView(srv, i, cfg, page_size=page_size,
                             prefix_cache_entries=4, device="cpu")
                  for i in range(n_shards)]
    srv._rebuild_host(num_pages, scratch_pages, key=(1, 1, 1, 1))
    return srv


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(1, 5)),
                min_size=1, max_size=40),
       st.integers(0, 2 ** 31 - 1))
def test_shard_local_pools_track_live_footprint(ops, seed):
    rng = np.random.default_rng(seed)
    srv = _host_only_sharded_server()
    live = [[] for _ in range(4)]
    for shard, n in ops:
        pool = srv.shards[shard].pool
        if live[shard] and rng.random() < 0.4:
            pool.release(live[shard].pop())
        elif n <= pool.free_pages:
            live[shard].append(pool.alloc(n))
    for k, sv in enumerate(srv.shards):
        assert sv.pool.pages_in_use == \
            sv._scratch.size + sum(a.size for a in live[k])
        for a in live[k]:
            assert all(0 <= p < sv.pool.num_pages for p in a)
    for k in range(4):
        if live[k]:
            pages = live[k][0]
            srv.shards[k].pool.release(pages)
            before = srv.shards[k].pool.pages_in_use
            with pytest.raises(PageAccountingError):
                srv.shards[k].pool.release(pages)
            assert srv.shards[k].pool.pages_in_use == before
            break


def test_rebuild_refused_while_any_shard_holds_pages():
    srv = _host_only_sharded_server()
    held = srv.shards[2].pool.alloc(3)
    with pytest.raises(PagePoolError):
        srv._rebuild_host(64, 2, key=(2, 2, 2, 2))
    srv.shards[2].pool.release(held)
    srv._rebuild_host(64, 2, key=(2, 2, 2, 2))
    assert all(sv.pool.num_pages == 64 for sv in srv.shards)


def test_shard_pools_are_independent():
    srv = _host_only_sharded_server(num_pages=8, scratch_pages=2)
    a = srv.shards[0].pool.alloc(6)
    assert srv.shards[0].pool.free_pages == 0
    assert srv.shards[1].pool.free_pages == 6
    b = srv.shards[1].pool.alloc(6)
    srv.shards[0].pool.release(a)
    assert srv.shards[1].pool.pages_in_use == 8
    srv.shards[1].pool.release(b)


def test_a_lost_shard_refuses_allocation_prefix_hits_and_rebuilds():
    srv = _host_only_sharded_server()
    sv = srv.shards[1]
    shared = sv._alloc_retry(2)
    sv._prefix_insert(b"k", shared, None, torch.zeros(3), tokens=8)
    assert sv._prefix_lookup(b"k") is not None
    srv.mark_shard_lost(1)
    assert sv.lost and not srv.shards[0].lost
    assert sv._prefix_lookup(b"k") is None
    with pytest.raises(PoolExhausted, match="lost"):
        sv._alloc_retry(1)
    with pytest.raises(PagePoolError, match="lost"):
        srv._rebuild_host(64, 2, key=(2, 2, 2, 2))
    srv.shards[0]._alloc_retry(1)          # survivors still allocate
    agg = srv.aggregate_stats()
    assert agg.pool_pages == 4 * 24
    assert srv.per_shard_pages_in_use()[1] == sv.pool.pages_in_use
    ids = srv.pad_fork_ids(3)
    assert ids.shape == (4, 3) and (ids[:, 0] == [
        int(s._scratch[0]) for s in srv.shards]).all()


# ----------------------------------------------------------------------
# launch.mesh and ServingMesh
# ----------------------------------------------------------------------
def test_make_serving_mesh_raises_without_forced_devices():
    lmesh.clear_forced_devices()
    if torch.cuda.device_count() >= 4:
        pytest.fail("this test assumes fewer than four visible cards")
    with pytest.raises(RuntimeError, match="force_device_count"):
        lmesh.make_serving_mesh(4)
    with pytest.raises(RuntimeError, match="force_device_count"):
        lmesh.make_serving_mesh(2, model=2)
    with pytest.raises(RuntimeError, match="force_device_count"):
        lmesh.make_production_mesh()


def test_force_device_count_makes_round_robin_logical_devices():
    try:
        devs = lmesh.force_device_count(6, "cpu")
        assert devs == [torch.device("cpu")] * 6
        m = lmesh.make_serving_mesh(3, model=2)
        assert m.shape == {"data": 3, "model": 2}
        assert lmesh.mesh_chip_count(m) == 6
        assert lmesh.make_serving_mesh(model=2).shape["data"] == 3
        assert lmesh.make_smoke_mesh(2).shape == {"data": 3, "model": 2}
        assert lmesh.rules_for(m) is lmesh.SINGLE_POD_RULES
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                lmesh.force_device_count(4)
        with pytest.raises(ValueError):
            lmesh.make_serving_mesh(2, model=0)
    finally:
        lmesh.clear_forced_devices()


def test_place_params_slices_column_leaves_and_shares_the_rest(
        cpu_devices):
    from repro_torch.serving import ServingMesh
    _, (probe, ens) = tp._mesh_fleets("mesh2d")
    smesh = ServingMesh(data=2, model=2)
    cells = smesh.place_params(ens[1].cfg, ens[1].params)
    assert len(cells) == 4
    full = ens[1].params
    for c, (k, j, _) in zip(cells, smesh.cells()):
        lay, flay = c["layers"], full["layers"]
        w = flay["mlp"]["w_gate"]
        f = w.shape[-1] // 2
        assert torch.equal(lay["mlp"]["w_gate"],
                           w[..., j * f:(j + 1) * f])
        assert lay["mlp"]["w_gate"].is_contiguous()
        # replicated leaves are shared, never copied, on one device
        assert lay["mlp"]["w_down"].data_ptr() == \
            flay["mlp"]["w_down"].data_ptr()
        assert c["embedding"].data_ptr() == full["embedding"].data_ptr()
    # the two data shards of one column share their slices
    assert cells[0]["layers"]["attn"]["wq"].data_ptr() == \
        cells[2]["layers"]["attn"]["wq"].data_ptr()
    bad = ens[1].cfg.replace(num_kv_heads=3, num_heads=3)
    with pytest.raises(ValueError, match="not divisible"):
        smesh.place_params(bad, ens[1].params)
    smesh.close()


def test_a_failing_cell_raises_in_the_caller(cpu_devices):
    """One column fails before its gather; its row's other column,
    waiting at the gather, is released, and ``run`` raises the first
    failure in the caller within seconds. The mesh serves again
    afterwards."""
    from repro_torch.serving import ServingMesh
    from repro_torch.sharding import tp_all_gather
    smesh = ServingMesh(data=2, model=2)

    def body(k, j):
        if (k, j) == (1, 0):
            raise ValueError("cell (1, 0) failed")
        return tp_all_gather(torch.full((1, 1), float(j)))

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"data 1, model 0.*failed"):
        smesh.run(body, [(k, j) for k, j, _ in smesh.cells()])
    assert time.perf_counter() - t0 < 20
    out = smesh.run(lambda k, j: tp_all_gather(torch.full((1, 1),
                                                          float(j))),
                    [(k, j) for k, j, _ in smesh.cells()])
    assert all(torch.equal(o, torch.tensor([[0.0, 1.0]])) for o in out)
    smesh.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mesh-cell")]


def test_a_mesh_refuses_an_engine_on_another_device_kind(cpu_devices):
    from repro_torch.serving import ShardedStepLoopRunner
    smesh = types.SimpleNamespace(device_type="cuda")
    eng = types.SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(ValueError, match="cannot serve"):
        ShardedStepLoopRunner(eng, None, None, smesh)


# ----------------------------------------------------------------------
# kernel 3's stages (the plain versions on the CPU)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t,d,f,m", [(8, 64, 256, 2), (13, 48, 96, 3),
                                     (24, 32, 512, 4)])
def test_swiglu_stages_around_a_column_split_give_the_fused_bits(t, d, f,
                                                                 m):
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(t)
    x = torch.randn(t, d, generator=g)
    wg, wu = (torch.randn(d, f, generator=g) / d ** 0.5 for _ in "gu")
    wd = torch.randn(f, d, generator=g) / f ** 0.5
    fused = ops.fused_swiglu(x, wg, wu, wd)
    w = f // m
    h = torch.cat([ops.swiglu_gate_up(
        x, wg[:, j * w:(j + 1) * w].contiguous(),
        wu[:, j * w:(j + 1) * w].contiguous()) for j in range(m)], -1)
    assert torch.equal(h, ops.swiglu_gate_up(x, wg, wu))
    assert torch.equal(ops.swiglu_down(h, wd), fused)
    assert ops.launch_counts()["swiglu_gate_up"] == 0


# ----------------------------------------------------------------------
# rung 2 under tensor parallelism
# ----------------------------------------------------------------------
def _pages(cfg, n_pages, page, kv):
    shape = (cfg.num_layers, n_pages, page, kv, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape), "v": torch.zeros(shape)}


@pytest.mark.parametrize("member", [0, 1])
def test_model2_programs_give_the_single_device_bits(member, cpu_devices):
    """Member 0 of ``mesh2d_zoo`` (dense) and member 1 (gather MoE, its
    experts through kernel 3's two stages around the gather): a prefill
    chunk and a 3-tick megastep on a (1, 2) mesh against the port's
    single-device programs (logits, tokens and every page bit for bit)
    and against the reference's single-device programs (logits within
    1e-5, the same tokens)."""
    from repro.sampling import sampler as JS
    from repro_torch.sampling import prng
    from repro_torch.sampling import sampler as S
    from repro_torch.serving import ServingMesh
    (jprobe, jens), (_, tens) = tp._mesh_fleets("mesh2d")
    zm, jzm = tens[member], jens[member]
    cfg = zm.cfg
    b, c, page, n_pages = 3, 8, 4, 16
    nb = 4                                 # 8 prompt + 6 decode slots
    rng = np.random.default_rng(member)
    tokens = rng.integers(3, cfg.vocab_size, size=(b, c)).astype(np.int32)
    table = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    starts = np.zeros(b, np.int32)
    kv = cfg.num_kv_heads

    pages = _pages(cfg, n_pages, page, kv)
    lg, _ = S.prefill_chunk_paged(cfg, zm.params, torch.from_numpy(tokens),
                                  pages, torch.from_numpy(table),
                                  torch.from_numpy(starts), prompt_len=c)
    smesh = ServingMesh(data=1, model=2)
    cells = smesh.place_params(cfg, zm.params)
    cpages = [_pages(cfg, n_pages, page, kv // 2) for _ in range(2)]
    slg, _ = S.prefill_chunk_paged_sharded(
        cfg, cells, tokens[None], cpages, table[None], starts[None],
        prompt_len=c, mesh=smesh)
    assert torch.equal(slg[0], lg)
    for j in range(2):
        for leaf in ("k", "v"):
            half = pages[leaf][:, :, :, j * kv // 2:(j + 1) * kv // 2]
            assert torch.equal(cpages[j][leaf], half)

    keys = prng._as_keys(np.stack([prng.fold_in_np(
        prng.prng_key(0), i) for i in range(b)]), "cpu")
    pos = np.full(b, c, np.int32)
    steps = np.zeros(b, np.int32)
    done = np.zeros(b, bool)
    kw = dict(n_ticks=3, cache_len=c + 6, temperature=0.9, eos_id=-1,
              pad_id=0)
    em, dn, nl, _ = S.decode_megastep_rows(
        cfg, zm.params, lg, pages, torch.from_numpy(table),
        torch.from_numpy(pos), keys, torch.from_numpy(steps),
        torch.from_numpy(done), **kw)
    sem, sdn, snl, _ = S.decode_megastep_rows_sharded(
        cfg, cells, [slg[0]], cpages, table[None], pos[None],
        keys.numpy()[None], steps[None], done[None], mesh=smesh, **kw)
    smesh.close()
    assert torch.equal(sem[0], em) and torch.equal(sdn[0], dn)
    assert torch.equal(snl[0], nl)

    jcfg = jzm.cfg
    jpages = {k: jnp.zeros((jcfg.num_layers, n_pages, page, kv,
                            jcfg.resolved_head_dim), jnp.float32)
              for k in ("k", "v")}
    jlg, _ = JS.prefill_chunk_paged(jcfg, jzm.params, jnp.asarray(tokens),
                                    jpages, jnp.asarray(table),
                                    jnp.asarray(starts), prompt_len=c)
    np.testing.assert_allclose(slg[0].numpy(), np.asarray(jlg),
                               rtol=0, atol=1e-5)
    assert (slg[0].argmax(-1).numpy() == np.asarray(jlg).argmax(-1)).all()
