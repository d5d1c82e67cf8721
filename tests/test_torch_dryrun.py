"""The port's dry-run accounting against the reference's: for the ten
registered archs and every ``INPUT_SHAPES`` entry, the param count,
active params, ``model_flops`` and ``should_skip``; ``abstract_params``
and ``input_specs`` (the decode cache tree included) leaf for leaf in
shape and dtype; ``param_specs`` under each rule set; and
``paged_supported`` and ``decode_text``.

The reference's values are read once for the whole file in one
subprocess (``_torch_port.forced_subprocess``): importing
``repro.launch.dryrun`` forces host devices for jax, which must not
happen in a test worker's own process. The port's side runs on the
``meta`` device and allocates nothing."""
import json

import numpy as np
import pytest
import torch

import _torch_port as tp
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import input_specs
from repro_torch.models import params as tparams
from repro_torch.models.params import _leaves
from repro_torch.models.transformer import paged_supported
from repro_torch.sampling.sampler import decode_text
from repro_torch.sharding import RULE_SETS

REFERENCE_SNIPPET = r'''
import json
import jax
from repro.launch import dryrun
from repro.configs.base import INPUT_SHAPES
from repro.configs.registry import ARCH_IDS, get_config
from repro.launch.steps import input_specs
from repro.models import params as P
from repro.models.transformer import paged_supported
from repro.sampling.sampler import decode_text
from repro.sharding import RULE_SETS


def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {path_str(p): v for p, v in flat}


def sds(tree):
    return {k: [list(v.shape), str(v.dtype)]
            for k, v in leaves(tree).items()}


out = {"archs": {}, "rule_sets": sorted(RULE_SETS)}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    rec = {"shapes": {}, "abstract_params": sds(P.abstract_params(cfg)),
           "param_specs": {}, "paged_supported": [
               paged_supported(cfg),
               paged_supported(get_config(arch, reduced=True))]}
    for name in sorted(RULE_SETS):
        specs = P.param_specs(cfg, RULE_SETS[name])
        rec["param_specs"][name] = {
            k: list(v) for k, v in leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)).items()}
    for sname, shape in INPUT_SHAPES.items():
        rec["shapes"][sname] = dict(
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
            model_flops=dryrun.model_flops(cfg, shape),
            skip=dryrun.should_skip(cfg, shape),
            inputs=sds(input_specs(cfg, shape)))
    out["archs"][arch] = rec
out["decode_text"] = decode_text([[3, 1, 2], [5, 5, 0]],
                                 lambda row: "-".join(map(str, row)))
print("DRYRUNJSON" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref():
    text = tp.forced_subprocess(REFERENCE_SNIPPET, timeout=600)
    line = next(ln for ln in text.splitlines()
                if ln.startswith("DRYRUNJSON"))
    return json.loads(line[len("DRYRUNJSON"):])


def _meta_specs(tree) -> dict:
    return {path: [list(t.shape), str(t.dtype).removeprefix("torch.")]
            for path, t in _leaves(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_flops_and_skips_equal_the_references(ref, arch):
    cfg = get_config(arch)
    for sname, shape in INPUT_SHAPES.items():
        want = ref["archs"][arch]["shapes"][sname]
        got = dryrun.account(arch, sname)
        assert dryrun.should_skip(cfg, shape) == want["skip"]
        assert dryrun.model_flops(cfg, shape) == want["model_flops"]
        if want["skip"]:
            assert got["status"] == "skipped"
            assert got["reason"] == want["skip"]
            continue
        assert got["params"] == want["params"]
        assert got["active_params"] == want["active_params"]
        assert got["model_flops"] == want["model_flops"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_the_references_leaf_for_leaf(ref, arch):
    tree = tparams.abstract_params(get_config(arch))
    assert all(t.device.type == "meta" for _, t in _leaves(tree))
    assert _meta_specs(tree) == ref["archs"][arch]["abstract_params"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_references_leaf_for_leaf(ref, arch):
    """Every kind of step, the decode cache tree (``init_cache`` on
    ``meta``) included."""
    cfg = get_config(arch)
    for sname, shape in INPUT_SHAPES.items():
        got = _meta_specs(input_specs(cfg, shape))
        assert got == ref["archs"][arch]["shapes"][sname]["inputs"], sname


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(ref, arch):
    cfg = get_config(arch)
    assert sorted(RULE_SETS) == ref["rule_sets"]
    for name, rules in RULE_SETS.items():
        got = {path: list(spec) for path, spec in
               _leaves(tparams.param_specs(cfg, rules))}
        assert got == ref["archs"][arch]["param_specs"][name], name


def test_paged_supported_and_decode_text_equal_the_references(ref):
    for arch in ARCH_IDS:
        assert [paged_supported(get_config(arch)),
                paged_supported(get_config(arch, reduced=True))] == \
            ref["archs"][arch]["paged_supported"], arch
    detok = lambda row: "-".join(map(str, row))   # noqa: E731
    toks = [[3, 1, 2], [5, 5, 0]]
    assert decode_text(toks, detok) == ref["decode_text"]
    assert decode_text(torch.tensor(toks), detok) == ref["decode_text"]


def test_account_splits_column_leaves_and_kv_heads():
    """Under a column split over 2 columns, a column holds half of each
    ``_COL_PARALLEL`` leaf and the rest whole, its kv heads' half of the
    decode cache, and AdamW's two f32 moments of what it holds; a
    config the split cannot take raises."""
    cfg = get_config("llama3-8b")
    rec = dryrun.account("llama3-8b", "decode_32k", model_shards=2)
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    col = L * (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
               + 2 * d * cfg.d_ff) + d * cfg.vocab_size
    assert rec["param_bytes"] - rec["param_bytes_split"] == col   # bf16: x2/2
    assert rec["cache_bytes_split"] * 2 == rec["cache_bytes"]
    assert rec["adamw_bytes"] == rec["adamw_bytes_split"] == 0
    train = dryrun.account(cfg, "train_4k", model_shards=2)
    assert train["adamw_bytes"] == 8 * train["param_elements"] + 4
    assert train["adamw_bytes_split"] == 4 * train["param_bytes_split"] + 4
    with pytest.raises(ValueError):
        dryrun.account("granite-34b", "decode_32k", model_shards=2)


def test_account_param_bytes_equal_materialised_params():
    """The accounted bytes are the bytes ``init_params`` allocates (a
    reduced config of each family, on the CPU)."""
    for arch in ("smollm-135m", "falcon-mamba-7b", "recurrentgemma-2b",
                 "whisper-medium", "deepseek-v2-236b"):
        cfg = get_config(arch, reduced=True)
        placed = tparams.init_params(cfg, 0, device="cpu")
        assert dryrun.account(cfg, "prefill_32k")["param_bytes"] == \
            dryrun.tree_bytes(placed), arch


def test_cli_writes_one_json_per_combo(tmp_path):
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                        "--shape", "long_500k", "--out",
                        str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["smollm-135m__long_500k__m1.json",
                     "smollm-135m__train_4k__m1.json"]
    rec = json.loads((tmp_path / files[1]).read_text())
    assert rec["status"] == "ok" and rec["params"] == get_config(
        "smollm-135m").param_count()
    assert json.loads((tmp_path / files[0]).read_text())["status"] == \
        "skipped"
    assert np.isfinite(rec["model_flops"])
