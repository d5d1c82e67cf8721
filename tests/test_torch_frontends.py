"""The audio and vision families at rung 1 of the ladder: the modules
they add, each against the reference's function on the same numpy
inputs (f32), and the configs and registry.

- ``layer_norm`` and the GELU MLP within 1e-5 (the erf GELU misses the
  tanh form the reference uses by more than that);
- ``cross_kv`` and ``cross_attention`` over 2-D and 3-D x within 1e-5;
- ``_sinusoidal_pos`` at 64 and 1500 positions within 2e-4: the angles
  reach ~1500 rad, where one ulp of the f32 angle (1.2e-4) moves sin
  and cos by as much, and XLA's and torch's f32 ``pow`` and ``sin``
  may round differently; at 64 positions within 1e-5;
- ``_dec_pos`` equal, positions past the table wrapping;
- ``_encode`` on reduced whisper within 1e-5;
- ``frontends``: shapes, seeds, dtype and scale of the synthetic
  frames and patches;
- the full configs equal the published hyperparameters
  (``tests/test_arch_smoke.py``'s values), every config equals the
  reference's field for field, and the registry lists the reference's
  ``ARCH_IDS`` in its order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from repro.configs.registry import ARCH_IDS as JARCH_IDS
from repro.configs.registry import get_config as jget
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import params as jparams
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config as tget
from repro_torch.models import attention as TA
from repro_torch.models import frontends
from repro_torch.models import layers as TL
from repro_torch.models import params as tparams
from repro_torch.models import transformer as TT

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _err(got, want):
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


def _whisper():
    jcfg = jget("whisper-medium", reduced=True).replace(dtype="float32",
                                                        use_pallas=True)
    jprm = jparams.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = torch_cfg(jcfg)
    tprm = tparams.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jprm),
                                  device="cpu")
    return jcfg, jprm, tcfg, tprm


@pytest.mark.parametrize("shape", [(3, 256), (2, 5, 96)])
def test_layer_norm_matches_reference(shape):
    x = _normal(0, shape, 3.0) + 1.5
    d = shape[-1]
    scale, bias = _normal(1, (d,)), _normal(2, (d,))
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), 1e-5)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias), 1e-5)
    assert _err(got, want) <= TOL


def _gelu_params(d=64, f=256):
    return {"w_in": _normal(3, (d, f), d ** -0.5),
            "b_in": _normal(4, (f,), 0.5),
            "w_out": _normal(5, (f, d), f ** -0.5),
            "b_out": _normal(6, (d,), 0.5)}


@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 64)])
def test_gelu_mlp_matches_reference(shape):
    p = _gelu_params()
    x = _normal(7, shape, 2.0)
    want = JL.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = TL.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    assert tuple(got.shape) == shape
    assert _err(got, want) <= TOL


def test_erf_gelu_misses_the_reference():
    """torch's default GELU (the erf form) differs from the reference's
    tanh form by more than the tolerance on the same inputs."""
    p = {k: torch.from_numpy(v) for k, v in _gelu_params().items()}
    x = _normal(7, (2, 7, 64), 2.0)
    want = JL.gelu_mlp({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                       jnp.asarray(x))
    xt = torch.from_numpy(x)
    h = torch.nn.functional.gelu(xt @ p["w_in"] + p["b_in"])
    erf = h @ p["w_out"] + p["b_out"]
    assert _err(erf, want) > 10 * TOL


def test_cross_kv_matches_reference():
    jcfg, jprm, tcfg, tprm = _whisper()
    enc = _normal(8, (2, 64, tcfg.d_model))
    jp = jax.tree.map(lambda a: a[0], jprm["dec_layers"]["cross"])
    tp = {k: v[0] for k, v in tprm["dec_layers"]["cross"].items()}
    jk, jv = JA.cross_kv(jcfg, jp, jnp.asarray(enc))
    tk, tv = TA.cross_kv(tcfg, tp, torch.from_numpy(enc))
    assert tuple(tk.shape) == (2, 64, tcfg.num_kv_heads,
                               tcfg.resolved_head_dim)
    assert _err(tk, jk) <= TOL and _err(tv, jv) <= TOL


@pytest.mark.parametrize("x_shape", [(2, 256), (2, 5, 256)],
                         ids=["2d", "3d"])
def test_cross_attention_matches_reference(x_shape):
    jcfg, jprm, tcfg, tprm = _whisper()
    hd, kv = tcfg.resolved_head_dim, tcfg.num_kv_heads
    ek, ev = _normal(9, (2, 64, kv, hd)), _normal(10, (2, 64, kv, hd))
    x = _normal(11, x_shape)
    jp = jax.tree.map(lambda a: a[1], jprm["dec_layers"]["cross"])
    tp = {k: v[1] for k, v in tprm["dec_layers"]["cross"].items()}
    want = JA.cross_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(ek),
                              jnp.asarray(ev))
    got = TA.cross_attention(tcfg, tp, torch.from_numpy(x),
                             torch.from_numpy(ek), torch.from_numpy(ev))
    assert tuple(got.shape) == x_shape
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("length,d,tol", [(64, 256, 1e-5),
                                          (1500, 1024, 2e-4)])
def test_sinusoidal_pos_matches_reference(length, d, tol):
    want = JT._sinusoidal_pos(length, d)
    got = TT._sinusoidal_pos(length, d)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (length, d)
    assert _err(got, want) <= tol


def test_dec_pos_matches_reference_past_the_table():
    jcfg, jprm, tcfg, tprm = _whisper()
    n = tcfg.max_position
    pos = np.array([0, 1, n - 1, n, n + 5, 3 * n + 2], np.int32)
    want = JT._dec_pos(jcfg, jprm, jnp.asarray(pos))
    got = TT._dec_pos(tcfg, tprm, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[3].numpy(), got[0].numpy())


def test_encode_matches_reference():
    jcfg, jprm, tcfg, tprm = _whisper()
    frames = _normal(12, (2, 64, tcfg.d_model), 0.02)
    want = JT._encode(jcfg, jprm, jnp.asarray(frames))
    with torch.no_grad():
        got = TT._encode(tcfg, tprm, torch.from_numpy(frames))
    assert tuple(got.shape) == (2, 64, tcfg.d_model)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_synthetic_frontends(arch):
    cfg = tget(arch, reduced=True)
    make = (frontends.synthetic_frames if arch == "whisper-medium"
            else frontends.synthetic_patches)
    shape = (frontends.audio_frame_shape(cfg, 3)
             if arch == "whisper-medium"
             else frontends.vision_patch_shape(cfg, 3))
    want = {"whisper-medium": (3, 64, 256),
            "llava-next-mistral-7b": (3, 16, 256)}[arch]
    assert shape == want
    a = make(cfg, 3, 5, device="cpu")
    assert tuple(a.shape) == want and a.dtype == torch.bfloat16
    assert torch.equal(a, make(cfg, 3, 5, device="cpu"))
    assert not torch.equal(a, make(cfg, 3, 6, device="cpu"))
    assert abs(float(a.float().std()) - 0.02) < 2e-3


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_full_config_matches_published(arch):
    """``tests/test_arch_smoke.py::test_full_config_matches_assignment``'s
    values, and the port's config equal to the reference's field for
    field, reduced too."""
    L, d, h, kv, ff, v = {
        "whisper-medium": (24, 1024, 16, 16, 4096, 51865),
        "llava-next-mistral-7b": (32, 4096, 32, 8, 14336, 32000)}[arch]
    cfg = tget(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (L, d, h, kv, ff, v)
    if arch == "whisper-medium":
        assert (cfg.encoder.num_layers, cfg.encoder.num_frames,
                cfg.max_position, cfg.use_rope, cfg.frontend) == (
                    24, 1500, 448, False, "audio")
    else:
        assert (cfg.num_patches, cfg.window, cfg.frontend) == (
            1152, 4096, "vision")
    for reduced in (False, True):
        assert tget(arch, reduced) == torch_cfg(jget(arch, reduced))


def test_registry_lists_the_reference_architectures():
    assert ARCH_IDS == JARCH_IDS
    assert len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_model_defs_match_reference(arch):
    """Paths, shapes and dtypes of the port's bf16 param tree equal the
    reference's, from ``init_params``: whisper's two stacks, layer-norm
    biases, cross-attention, GELU MLP and ``dec_pos``."""
    jcfg = jget(arch, reduced=True)
    want = {"/".join(str(k.key) for k in path): (tuple(a.shape),
                                                 str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(
                jparams.abstract_params(jcfg))[0]}
    prm = tparams.init_params(torch_cfg(jcfg), 0, device="cpu")
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in tparams._leaves(prm)}
    assert got == want
    if arch == "whisper-medium":
        for k in ("enc_layers/mlp/w_in", "enc_final_norm/bias",
                  "dec_layers/cross/wq", "dec_layers/cross_norm/bias",
                  "dec_pos", "final_norm/bias"):
            assert k in got, k
        assert torch.all(prm["dec_layers"]["mlp"]["b_in"] == 0)
