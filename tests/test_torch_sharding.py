"""The port's ``sharding/`` against the reference's: the logical-axis
rule tables and ``resolve``, the placement hints' no-op behaviour,
``tp_local_cfg`` / ``tp_check_cfg`` over every registered config,
``tp_param_specs`` on converted param trees, ``StepPlanner.place_shard``
on a hypothesis sweep, and the column rendezvous behind
``tp_all_gather``."""
import threading

import jax
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
from repro import sharding as jsh
from repro.configs import registry as jreg
from repro_torch import sharding as tsh
from repro_torch.configs import registry as treg
from repro_torch.sharding import tp as ttp

TABLES = ("SINGLE_POD_RULES", "MULTI_POD_RULES", "FULL_DP_RULES",
          "NO_KV_SHARD_RULES", "RULE_SETS")
LOGICAL = [("batch", "seq", "heads", None), ("batch", "seq", "embed"),
           ("batch", "seq_kv", "kv_heads", None), ("layers", "ff", "ff"),
           ("vocab", "embed"), ("experts", "embed", "expert_ff"),
           ("batch", "d_inner", "state"), ("frames", "kv_lora"),
           ("heads", "kv_heads", "seq_kv", "vocab")]


@pytest.mark.parametrize("name", TABLES)
def test_rule_tables_equal_the_references(name):
    assert getattr(tsh, name) == getattr(jsh, name)


def test_expert_parallel_rules_equal_the_references():
    from repro.sharding import partitioning as jp
    from repro_torch.sharding import partitioning as tpart
    assert tpart.EXPERT_PARALLEL_RULES == jp.EXPERT_PARALLEL_RULES


def _jax_mesh(axes):
    dev = np.asarray(jax.devices()[:1]).reshape((1,) * len(axes))
    return jax.sharding.Mesh(dev, axes)


def _port_mesh(axes):
    from repro_torch.launch.mesh import DeviceMesh
    grid = np.empty(1, dtype=object)
    grid[0] = torch.device("cpu")
    return DeviceMesh(grid.reshape((1,) * len(axes)), axes)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("rules", sorted(jsh.RULE_SETS))
def test_resolve_and_axis_sizes_equal_the_references(rules, multi_pod):
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert tsh.rule_set(rules, multi_pod) == jsh.rule_set(rules, multi_pod)
    with jsh.axis_rules(_jax_mesh(axes), jsh.rule_set(rules, multi_pod)):
        want = [tuple(jsh.resolve(*lg)) for lg in LOGICAL]
        want_n = [jsh.mesh_axis_size(n) for n in jsh.SINGLE_POD_RULES]
    with tsh.axis_rules(_port_mesh(axes), tsh.rule_set(rules, multi_pod)):
        got = [tsh.resolve(*lg) for lg in LOGICAL]
        got_n = [tsh.mesh_axis_size(n) for n in tsh.SINGLE_POD_RULES]
        assert tsh.named_sharding("batch", "vocab") == \
            tsh.resolve("batch", "vocab")
        x = torch.zeros(2, 3)
        assert tsh.shard(x, "batch", "embed") is x
    assert got == want
    assert got_n == want_n


def test_placement_hints_are_no_ops_outside_a_rules_context():
    x = torch.zeros(2, 3)
    assert tsh.shard(x, "batch", "embed") is x
    assert tsh.named_sharding("batch") is None
    assert tsh.mesh_axis_size("heads") == 1
    assert jsh.named_sharding("batch") is None
    assert jsh.mesh_axis_size("heads") == 1


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("arch", sorted(jreg.ARCH_IDS))
def test_tp_cfg_checks_accept_and_refuse_as_the_references(arch, m):
    for reduced in (False, True):
        jc = jreg.get_config(arch, reduced=reduced)
        tc = treg.get_config(arch, reduced=reduced)
        outcomes = []
        for mod, c in ((jsh, jc), (tsh, tc)):
            try:
                mod.tp_check_cfg(c, m)
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], (arch, reduced, m)
        try:
            jl = jsh.tp_local_cfg(jc, m)
        except ValueError as e:
            with pytest.raises(ValueError, match="not divisible"):
                tsh.tp_local_cfg(tc, m)
            assert str(e)
            continue
        tl = tsh.tp_local_cfg(tc, m)
        assert (tl.num_heads, tl.num_kv_heads, tl.resolved_head_dim,
                tl.head_dim) == (jl.num_heads, jl.num_kv_heads,
                                 jl.resolved_head_dim, jl.head_dim)
        assert (tl is tc) == (jl is jc)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("fleet", ["paged", "mesh2d", "hetero"])
def test_tp_param_specs_pick_the_references_leaves(fleet):
    from repro_torch.models.params import from_jax_numpy
    (probe, ens), _ = tp._mesh_fleets(fleet)
    for zm in [probe] + list(ens):
        jspec = jsh.tp_param_specs(zm.params)
        tparams = from_jax_numpy(tp.torch_cfg(zm.cfg),
                                 jax.tree.map(np.asarray, zm.params),
                                 device="cpu")
        want = {p: tuple(s) for p, s in _paths(jax.tree_util.tree_map(
            lambda s: tuple(s), jspec,
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))}
        got = dict(_paths(tsh.tp_param_specs(tparams)))
        assert got == want, zm.name
        assert any(s for s in got.values()) == any(
            s for s in want.values())


def test_tp_param_specs_split_the_last_axis_of_untied_lm_heads():
    from repro_torch.models.params import init_params
    cfg = treg.get_config("llama3-8b", reduced=True)
    assert not cfg.tie_embeddings
    specs = tsh.tp_param_specs(init_params(cfg, 0, device="cpu"))
    assert specs["lm_head"] == (None, "model")
    assert specs["embedding"] == ()
    assert specs["layers"]["attn"]["wq"] == (None, None, "model")
    assert specs["layers"]["attn"]["wo"] == ()


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 6), st.lists(st.tuples(
    st.integers(0, 6), st.integers(0, 80), st.integers(0, 40)),
    min_size=1, max_size=6), st.integers(1, 50),
    st.sets(st.integers(0, 5), max_size=3))
def test_place_shard_equals_the_references(cap, shards, need, blocked):
    from repro.serving.scheduler import StepPlanner as JPlanner
    from repro_torch.serving.scheduler import StepPlanner
    active = [a for a, _, _ in shards]
    free = [f for _, f, _ in shards]
    reserved = [r for _, _, r in shards]
    for blk in (None, blocked):
        assert StepPlanner(max_active_rows=cap).place_shard(
            active, free, reserved, need, blocked=blk) == \
            JPlanner(max_active_rows=cap).place_shard(
                active, free, reserved, need, blocked=blk)


# ----------------------------------------------------------------------
# the column rendezvous behind tp_all_gather
# ----------------------------------------------------------------------
def test_tp_all_gather_is_the_identity_outside_a_group():
    x = torch.arange(6.0).reshape(2, 3)
    assert tsh.tp_all_gather(x) is x
    assert not tsh.tp_active() and tsh.tp_size() == 1
    with tsh.tp_context("model", 1):
        assert tsh.tp_active() and tsh.tp_all_gather(x) is x
    with tsh.tp_context("model", 2):
        assert tsh.tp_size() == 2
        with pytest.raises(RuntimeError, match="column group"):
            tsh.tp_all_gather(x)
    assert not tsh.tp_active()


@pytest.mark.parametrize("m", [2, 3, 4])
def test_column_group_concatenates_in_column_order(m):
    group = ttp.ColumnGroup(m, timeout=30)
    out = [None] * m
    parts = [torch.full((2, 1 + j), float(j)) for j in range(m)]

    def col(j):
        with tsh.tp_context("model", m, group, j):
            # two gathers back to back: the second must not overwrite a
            # slice the first is still reading
            a = tsh.tp_all_gather(parts[j])
            b = tsh.tp_all_gather(parts[j] + 10)
        out[j] = (a, b)

    threads = [threading.Thread(target=col, args=(j,)) for j in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    want = torch.cat(parts, dim=-1)
    for a, b in out:
        assert torch.equal(a, want) and torch.equal(b, want + 10)


def test_column_group_abort_releases_every_waiting_column():
    group = ttp.ColumnGroup(3, timeout=60)
    errors = []

    def col(j):
        try:
            with tsh.tp_context("model", 3, group, j):
                tsh.tp_all_gather(torch.zeros(1, 1))
        except ttp.TpGatherAborted as e:
            errors.append(e)

    threads = [threading.Thread(target=col, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    group.abort()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(errors) == 2


def test_column_group_holds_under_many_threads_and_short_switches():
    """More columns than cores, a short thread switch interval, many
    gathers back to back: every column gets every gather's slices in
    column order (a slice overwritten before another column read it
    would break the sums)."""
    import sys
    m, rounds = 12, 150
    group = ttp.ColumnGroup(m, timeout=60)
    bad = []

    def col(j):
        with tsh.tp_context("model", m, group, j):
            for r in range(rounds):
                got = tsh.tp_all_gather(torch.full((1, 1), float(r * m + j)))
                if not torch.equal(got[0], torch.arange(
                        r * m, (r + 1) * m, dtype=torch.float32)):
                    bad.append((j, r))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=col, args=(j,))
                   for j in range(m)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
