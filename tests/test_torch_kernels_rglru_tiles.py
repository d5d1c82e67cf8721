"""The tiling of the port's RG-LRU kernels (``csrc/rglru_scan.cu``,
forward and backward), on the CPU.

The kernels walk each block of ``rglru_plan(W).channels`` channels of a
batch row along S in tiles of ``steps`` steps. A tile is staged as the
TMA boxes bring it: zeros past S and past W. Because a step of zeros
sets h (and the backward's carried gradient) to 0, a walk takes only
the tile's steps inside S: h after step S - 1 is h_final, and the
backward walks the tiles in reverse, starting at step S - 1 with
h_final's gradient as its carry, and reads h_{t-1} from a box of
``steps + 1`` rows that starts at t0 - 1 (the neighbouring tile's last
state; zeros at t0 = 0). The CUDA kernels run only on a card
(``chip_smoke.py`` holds them against their plain versions there, bit
for bit, and ``rglru_plan`` against the compiled constants); here a
torch emulation of that order of work, kept in this file, is held
against the plain versions bit for bit (hs, h_final, da, du), against
the reference's Pallas kernel in interpret mode and its oracle
(``repro.kernels.ref.rglru_scan_ref``) at ``tests/test_kernels.py``'s
tolerance, and its gradients against ``jax.grad`` of the oracle at
atol 1e-5 / rtol 1e-4 in f32, with and without h_final's gradient, over
S at the tile edges (1, T - 1, T, T + 1, 2T + 3) and W off the channel
grid (1, 3, dc - 1, dc + 1, 2dc + 5). A walk over the padded tile's
zero steps (taking h_final, or letting h_final's gradient in, at the
tile's end) is shown to fail wherever S is off the tile grid.

The emulation works in f32 as the kernels do (bf16 inputs widened
exactly), every operation rounded on its own, so it is comparable with
the plain versions bit for bit whatever the CPU's vector width."""
import contextlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro_torch.kernels import build
from repro_torch.kernels import rglru_scan as rg

TOL = 1e-5                                  # tests/test_kernels.py
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)

PLAN = rg.rglru_plan(1)
T, DC = PLAN.steps, PLAN.channels
S_EDGES = (1, T - 1, T, T + 1, 2 * T + 3)
W_OFF_GRID = (1, 3, DC - 1, DC + 1, 2 * DC + 5)


def _inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, size=(b, s, w)).astype(np.float32)
    u = (rng.normal(size=(b, s, w)) * 0.1).astype(np.float32)
    dhs = rng.normal(size=(b, s, w)).astype(np.float32)
    dhf = rng.normal(size=(b, w)).astype(np.float32)
    return a, u, dhs, dhf


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _same_bits(got, want) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.contiguous().view(torch.uint8),
                            want.contiguous().view(torch.uint8)))


# ----------------------------------------------------------------------
# the emulation
# ----------------------------------------------------------------------
def _box(x, t0, rows, w0, dc):
    """A staged box of ``x`` (B, S, W): ``rows`` steps from t0 (which may
    be -1) and dc channels from w0, zeros outside the tensor, as TMA
    fills it (and as the element copies do)."""
    bsz, s, w = x.shape
    out = torch.zeros((bsz, rows, dc), dtype=x.dtype)
    lo, hi = max(t0, 0), min(t0 + rows, s)
    if lo < hi:
        out[:, lo - t0:hi - t0, :min(dc, w - w0)] = x[:, lo:hi, w0:w0 + dc]
    return out


def _store(out, tile, t0, w0):
    """A tile's outputs into ``out`` (B, S, W), clipped at S and W."""
    _, s, w = out.shape
    rows, cols = min(T, s - t0), min(tile.shape[2], w - w0)
    out[:, t0:t0 + rows, w0:w0 + cols] = tile[:, :rows, :cols]


def emulate_fwd(a, u, padded_walk=False):
    """The forward kernel's order of work: (hs, h_final), f32. With
    ``padded_walk`` the walk also takes the zero steps of the last tile
    past S and h_final is the state at the tile's end: the trap."""
    bsz, s, w = a.shape
    p = rg.rglru_plan(w)
    af, uf = a.float(), u.float()
    hs = torch.full((bsz, s, w), float("nan"))
    h_final = torch.full((bsz, w), float("nan"))
    for blk in range(p.blocks):
        w0 = blk * p.channels
        h = torch.zeros((bsz, p.channels))
        for t0 in range(0, s, p.steps):
            at = _box(af, t0, p.steps, w0, p.channels)
            ut = _box(uf, t0, p.steps, w0, p.channels)
            tile = torch.zeros((bsz, p.steps, p.channels))
            for tt in range(p.steps if padded_walk else min(p.steps,
                                                            s - t0)):
                h = at[:, tt] * h + ut[:, tt]
                tile[:, tt] = h
            _store(hs, tile, t0, w0)
        h_final[:, w0:w0 + p.channels] = h[:, :min(p.channels, w - w0)]
    return hs, h_final


def emulate_bwd(a, u, hs, dhs, dh_final=None, padded_walk=False,
                prev_box=True):
    """The backward kernel's order of work: the tiles in reverse, each
    with its a and dhs boxes and an hs box of ``steps + 1`` rows from
    t0 - 1, the carry starting at step S - 1 from h_final's gradient.
    Returns (da, du) in a's and u's dtypes. ``padded_walk``: the walk
    starts at the padded last tile's end (the trap); ``prev_box``
    false: h_{t-1} of a tile's first step taken as 0 instead of the
    neighbouring tile's last state."""
    bsz, s, w = a.shape
    p = rg.rglru_plan(w)
    af, dhsf = a.float(), dhs.float()
    da = torch.full((bsz, s, w), float("nan"))
    du = torch.full((bsz, s, w), float("nan"))
    for blk in range(p.blocks):
        w0 = blk * p.channels
        carry = torch.zeros((bsz, p.channels))
        if dh_final is not None:
            carry[:, :min(p.channels, w - w0)] = \
                dh_final.float()[:, w0:w0 + p.channels]
        for t0 in reversed(range(0, s, p.steps)):
            at = _box(af, t0, p.steps, w0, p.channels)
            gt = _box(dhsf, t0, p.steps, w0, p.channels)
            hp = _box(hs, t0 - 1, p.steps + 1, w0, p.channels)
            if not prev_box:
                hp[:, 0] = 0.0
            da_t = torch.zeros((bsz, p.steps, p.channels))
            du_t = torch.zeros((bsz, p.steps, p.channels))
            for tt in reversed(range(p.steps if padded_walk
                                     else min(p.steps, s - t0))):
                g = gt[:, tt] + carry
                du_t[:, tt] = g
                da_t[:, tt] = 0.0 if t0 + tt == 0 else g * hp[:, tt]
                carry = at[:, tt] * g
            _store(da, da_t, t0, w0)
            _store(du, du_t, t0, w0)
    return da.to(a.dtype), du.to(u.dtype)


# ----------------------------------------------------------------------
# the forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("w", W_OFF_GRID)
@pytest.mark.parametrize("s", S_EDGES)
def test_emulated_forward_bitwise_and_matches_pallas(s, w):
    a, u, _, _ = _inputs(2, s, w, 31 * s + w)
    hs, hf = emulate_fwd(_t(a), _t(u))
    hsp, hfp = rg.rglru_scan_plain(_t(a), _t(u))
    assert _same_bits(hs, hsp) and _same_bits(hf, hfp)
    for hsw, hfw in (jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(u)),
                     pallas_rglru(jnp.asarray(a), jnp.asarray(u), block_w=w,
                                  chunk=s, interpret=True)):
        np.testing.assert_allclose(hs.numpy(), np.asarray(hsw), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(hfw), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("s", S_EDGES)
def test_emulated_forward_bf16_bitwise_and_matches_pallas(s):
    """bf16 a and u, widened exactly as the kernels widen a tile."""
    w = 2 * DC + 5
    a, u, _, _ = _inputs(2, s, w, s)
    ta, tu = _t(a, torch.bfloat16), _t(u, torch.bfloat16)
    hs, hf = emulate_fwd(ta, tu)
    hsp, hfp = rg.rglru_scan_plain(ta, tu)
    assert _same_bits(hs, hsp) and _same_bits(hf, hfp)
    ja, ju = jnp.asarray(a, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16)
    hsw, hfw = pallas_rglru(ja, ju, block_w=w, chunk=s, interpret=True)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hsw), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hfw), atol=TOL,
                               rtol=TOL)


# ----------------------------------------------------------------------
# the backward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("given", [True, False], ids=["dh_final", "none"])
@pytest.mark.parametrize("w", W_OFF_GRID)
@pytest.mark.parametrize("s", S_EDGES)
def test_emulated_backward_bitwise(s, w, given):
    a, u, dhs, dhf = map(_t, _inputs(2, s, w, 7 * s + w))
    hs, _ = rg.rglru_scan_plain(a, u)
    dh = dhf if given else None
    got = emulate_bwd(a, u, hs, dhs, dh)
    want = rg.rglru_scan_bwd_plain(a, u, hs, dhs, dh)
    for name, g, wt in zip(("da", "du"), got, want):
        assert _same_bits(g, wt), name


@pytest.mark.parametrize("given", [True, False], ids=["dh_final", "none"])
@pytest.mark.parametrize("s", [T + 1, 2 * T + 3])
def test_emulated_backward_bf16_bitwise(s, given):
    """bf16 a and u: da and du rounded once, to bf16, from f32."""
    w = 2 * DC + 5
    a, u, dhs, dhf = _inputs(2, s, w, s)
    ta, tu = _t(a, torch.bfloat16), _t(u, torch.bfloat16)
    hs, _ = rg.rglru_scan_plain(ta, tu)
    dh = _t(dhf) if given else None
    got = emulate_bwd(ta, tu, hs, _t(dhs), dh)
    want = rg.rglru_scan_bwd_plain(ta, tu, hs, _t(dhs), dh)
    assert [g.dtype for g in got] == [torch.bfloat16] * 2
    for name, g, wt in zip(("da", "du"), got, want):
        assert _same_bits(g, wt), name


@pytest.mark.parametrize("given", [True, False], ids=["dh_final", "none"])
@pytest.mark.parametrize("w", W_OFF_GRID)
@pytest.mark.parametrize("s", S_EDGES)
def test_emulated_backward_matches_jax_grad(s, w, given):
    a, u, whs, whf = _inputs(2, s, w, 5 * s + w)

    def jloss(ja, ju):
        hs, hf = jref.rglru_scan_ref(ja, ju)
        loss = jnp.sum(hs * whs)
        return loss + jnp.sum(hf * whf) if given else loss

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(u))
    ta, tu = _t(a), _t(u)
    hs, _ = emulate_fwd(ta, tu)
    got = emulate_bwd(ta, tu, hs, _t(whs), _t(whf) if given else None)
    for name, g, wt in zip(("a", "u"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), **GRAD_TOL,
                                   err_msg=name)


# ----------------------------------------------------------------------
# the trap: zero steps past S are not steps that change nothing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("s", S_EDGES)
def test_walking_the_padded_tile_fails_off_the_tile_grid(s):
    """Taking h_final at the padded tile's end, or letting h_final's
    gradient in there, is wrong wherever the last tile is padded (a = 0
    past S zeroes h and the carried gradient), and harmless where S is a
    multiple of T. The emulation as the kernels run it is right at every
    S (the tests above)."""
    w = DC + 1
    a, u, dhs, dhf = map(_t, _inputs(1, s, w, s))
    hsp, hfp = rg.rglru_scan_plain(a, u)
    hs, hf = emulate_fwd(a, u, padded_walk=True)
    want = rg.rglru_scan_bwd_plain(a, u, hsp, dhs, dhf)
    got = emulate_bwd(a, u, hsp, dhs, dhf, padded_walk=True)
    ok = (_same_bits(hf, hfp) and _same_bits(got[0], want[0])
          and _same_bits(got[1], want[1]))
    assert ok == (s % T == 0)
    # the states inside S never depend on the steps after them
    assert _same_bits(hs, hsp)
    if s % T:
        assert torch.equal(hf, torch.zeros_like(hf))


@pytest.mark.parametrize("s", [T + 1, 2 * T + 3])
def test_the_backward_needs_the_neighbouring_tiles_state(s):
    """da at a tile's first step takes h_{t-1} from the tile before: with
    0 in its place every tile but the first goes wrong there."""
    w = DC - 1
    a, u, dhs, dhf = map(_t, _inputs(1, s, w, s))
    hs, _ = rg.rglru_scan_plain(a, u)
    want = rg.rglru_scan_bwd_plain(a, u, hs, dhs, dhf)
    da, du = emulate_bwd(a, u, hs, dhs, dhf, prev_box=False)
    assert _same_bits(du, want[1])
    bad = (da != want[0]).any(-1)[0]
    assert bad.nonzero().flatten().tolist() == list(range(T, s, T))


# ----------------------------------------------------------------------
# the plan and the wrappers
# ----------------------------------------------------------------------
def test_rglru_plan_depends_on_w_alone():
    assert list(inspect.signature(rg.rglru_plan).parameters) == ["w"]
    for w in (1, 15, 16, 17, 37, 2560, 2568):
        p = rg.rglru_plan(w)
        assert (p.channels, p.steps) == (DC, T)
        assert p.blocks == -(-w // p.channels)
    # rows of whole 16-byte units in f32 and bf16, as TMA takes them
    assert DC * 4 % 16 == 0 and DC * 2 % 16 == 0
    assert rg.rglru_plan(2560).blocks == 2560 // DC


class _FakeLib:
    """Stands for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, fn):
        def call(*args):
            self.calls[fn] = args
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "check_cuda",
                        lambda name, **t: torch.device("cpu"))
    monkeypatch.setattr(build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return lib


def test_the_wrappers_pass_shapes_and_types(fake_lib):
    """The library is a stand-in: nothing launches."""
    bsz, s, w = 2, 70, 37
    a = torch.rand(bsz, s, w).to(torch.bfloat16)
    u = torch.randn(bsz, s, w)
    hs, hf = rg._launch_fwd(a, u)
    assert hs.shape == (bsz, s, w) and hf.shape == (bsz, w)
    assert hs.dtype == hf.dtype == torch.float32
    assert fake_lib.calls["acar_rglru_scan_fwd"][4:9] == (bsz, s, w, 1, 0)
    da, du = rg.rglru_scan_bwd(a, u, hs, torch.zeros(bsz, s, w),
                               torch.zeros(bsz, w))
    assert (da.dtype, du.dtype) == (torch.bfloat16, torch.float32)
    assert fake_lib.calls["acar_rglru_scan_bwd"][6:11] == (bsz, s, w, 1, 0)
    rg.rglru_scan_bwd(a, u, hs, torch.zeros(bsz, s, w))
    assert fake_lib.calls["acar_rglru_scan_bwd"][3] is None


def test_the_wrappers_refuse_ill_shaped_tensors(fake_lib):
    a, u = torch.rand(2, 9, 5), torch.randn(2, 9, 5)
    hs, dhs = torch.zeros(2, 9, 5), torch.zeros(2, 9, 5)
    with pytest.raises(ValueError, match="shapes"):
        rg._launch_fwd(a, u[:, :8].contiguous())
    with pytest.raises(ValueError, match="shapes"):
        rg._launch_fwd(a[0], u[0])
    for bad in ({"hs": hs[:, :8].contiguous()},
                {"hs": hs.to(torch.bfloat16)},
                {"dhs": dhs[:, :, :4].contiguous()},
                {"dh_final": torch.zeros(2, 4)}):
        args = {"hs": hs, "dhs": dhs, "dh_final": None, **bad}
        with pytest.raises(ValueError, match="rglru_scan_bwd"):
            rg.rglru_scan_bwd(a, u, **args)
    assert "acar_rglru_scan_bwd" not in fake_lib.calls
