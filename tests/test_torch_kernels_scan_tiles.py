"""The tiling of the port's selective-scan kernels
(``csrc/selective_scan.cu``, forward and backward), on the CPU.

The kernels walk each channel block of ``scan_plan(D, N).channels``
channels along S in tiles of ``steps`` steps, write the state before
every ``chunk``-th step as a checkpoint, and sum y_t over n in a fixed
order: a thread's ``per_thread`` products in order, then a butterfly
over the channel's ``lanes`` lanes. The backward walks the tiles in
reverse, recomputes each window's states from its checkpoint, carries
g_t = dy_t C_t + exp(dt_{t+1} A) g_{t+1} back through it, and sums dB
and dC over each block's channels into per-block partials that are then
added in block order. The CUDA kernels run only on a card
(``chip_smoke.py`` holds them against their plain versions there, their
states bit for bit, and checks ``scan_plan`` against the compiled
constants); here a torch emulation of that order of work, kept in this
file, is held against the plain version's states bit for bit, against
the reference's Pallas kernel in interpret mode and its oracle
(``repro.kernels.ref.selective_scan_ref``) at ``tests/test_kernels.py``'s
tolerances (y at 5x, as ``tests/test_torch_kernels_scan.py`` holds the
plain version), and its gradients against ``jax.grad`` of the oracle at
atol 1e-5 / rtol 1e-4 in f32, over S at the edges of the tiles and the
checkpoints (1, K - 1, K, K + 1, T - 1, T, T + 1, 2T + 3), D off the
block grid and N in {1, 2, 8, 16, 32}.

The emulation models the tiles, checkpoints and sums, not the kernel's
shuffles or its fused multiply-adds: its dB / dC sum a block's channels
in channel order, where the kernel sums a warp's channels by a halving
exchange and then the warps in order. Like the kernel it takes
dx = dt sum_n g B and ddt = x sum_n g B + sum_n g h_{t-1} exp(dt A) A. Each exponential is taken as the plain version takes it (over
all channels of a step), so the emulated states are comparable bit for
bit whatever the CPU's vector width."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro_torch.kernels import build
from repro_torch.kernels import selective_scan as ss

TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, d)) * 0.5).astype(np.float32)
    dt = (np.logaddexp(rng.normal(size=(b, s, d)), 0.0) * 0.1).astype(
        np.float32)
    a_log = (rng.normal(size=(d, n)) * 0.3).astype(np.float32)
    b_in = rng.normal(size=(b, s, n)).astype(np.float32)
    c_in = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a_log, b_in, c_in


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(_TDT[dtype]) if dtype else t


def _j(a, dtype=None):
    return jnp.asarray(a, _JDT[dtype]) if dtype else jnp.asarray(a)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# ----------------------------------------------------------------------
# the emulation
# ----------------------------------------------------------------------
def _decays(dtf, a):
    """exp(dt_t A) for every step, each step over all channels at once,
    as ``selective_scan_plain`` takes it: (B, S, D, N)."""
    return torch.stack([torch.exp(dtf[:, t, :, None] * a)
                        for t in range(dtf.shape[1])], 1)


def _lane_order_sum(p, plan):
    """Sum over the last axis (N) in the kernel's order: each lane's
    ``per_thread`` values in order, then the butterfly over lanes as lane
    0 ends it (lane i adds lane i + half at each level)."""
    g = p.reshape(*p.shape[:-1], plan.lanes, plan.per_thread)
    s = g[..., 0]
    for j in range(1, plan.per_thread):
        s = s + g[..., j]
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = s[..., :half] + s[..., half:]
    return s[..., 0]


def emulate_fwd(x, dt, a_log, b_in, c_in):
    """The forward kernel's order of work: (y in x's dtype, h_final,
    checkpoints (B, ceil(S / chunk), D, N))."""
    bsz, s, d = x.shape
    n = a_log.shape[1]
    plan = ss.scan_plan(d, n)
    a = -torch.exp(a_log.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b_in.float(), c_in.float()
    decay = _decays(dtf, a)
    y = torch.empty((bsz, s, d))
    h_final = torch.empty((bsz, d, n))
    ckpt = torch.full(ss.scratch_shapes(bsz, s, d, n)["ckpt"], float("nan"))
    for blk in range(plan.blocks):
        lo, hi = blk * plan.channels, min(d, (blk + 1) * plan.channels)
        h = torch.zeros((bsz, hi - lo, n))
        for t0 in range(0, s, plan.steps):
            for t in range(t0, min(s, t0 + plan.steps)):
                if t % plan.chunk == 0:
                    ckpt[:, t // plan.chunk, lo:hi] = h
                u = (dtf[:, t, lo:hi] * xf[:, t, lo:hi])[..., None] \
                    * bf[:, t, None, :]
                h = decay[:, t, lo:hi] * h + u
                y[:, t, lo:hi] = _lane_order_sum(h * cf[:, t, None, :], plan)
        h_final[:, lo:hi] = h
    return y.to(x.dtype), h_final, ckpt


def emulate_bwd(x, dt, a_log, b_in, c_in, ckpt, dy, dh_final=None):
    """The backward kernel's order of work: windows of ``chunk`` steps
    in reverse, each recomputed from its checkpoint; dB / dC partials
    per channel block, then added in block order. Returns the gradients
    (dx, ddt, da_log, db, dc) in f32 and every recomputed state
    (B, S, D, N)."""
    bsz, s, d = x.shape
    n = a_log.shape[1]
    plan = ss.scan_plan(d, n)
    a = -torch.exp(a_log.float())
    xf, dtf, dyf = x.float(), dt.float(), dy.float()
    bf, cf = b_in.float(), c_in.float()
    decay = _decays(dtf, a)
    dx, ddt = torch.empty((bsz, s, d)), torch.empty((bsz, s, d))
    shapes = ss.scratch_shapes(bsz, s, d, n)
    db_part = torch.full(shapes["db_part"], float("nan"))
    dc_part = torch.full(shapes["dc_part"], float("nan"))
    da_part = torch.empty(shapes["da_part"])
    states = torch.empty((bsz, s, d, n))
    for blk in range(plan.blocks):
        lo, hi = blk * plan.channels, min(d, (blk + 1) * plan.channels)
        carry = (torch.zeros((bsz, hi - lo, n)) if dh_final is None
                 else dh_final[:, lo:hi].float())
        da = torch.zeros((bsz, hi - lo, n))
        for c in reversed(range(-(-s // plan.chunk))):
            t0, t1 = c * plan.chunk, min(s, (c + 1) * plan.chunk)
            hs = [ckpt[:, c, lo:hi]]        # hs[i]: before step t0 + i
            for t in range(t0, t1):
                u = (dtf[:, t, lo:hi] * xf[:, t, lo:hi])[..., None] \
                    * bf[:, t, None, :]
                hs.append(decay[:, t, lo:hi] * hs[-1] + u)
            states[:, t0:t1, lo:hi] = torch.stack(hs[1:], 1)
            for t in reversed(range(t0, t1)):
                dec = decay[:, t, lo:hi]
                h_prev, h_t = hs[t - t0], hs[t - t0 + 1]
                dtv, xv = dtf[:, t, lo:hi, None], xf[:, t, lo:hi, None]
                g = dyf[:, t, lo:hi, None] * cf[:, t, None, :] + carry
                q = g * h_prev * dec
                sgb = _lane_order_sum(g * bf[:, t, None], plan)
                dx[:, t, lo:hi] = dtv[..., 0] * sgb
                ddt[:, t, lo:hi] = xv[..., 0] * sgb + _lane_order_sum(
                    q * a[lo:hi], plan)
                da = da + q * dtv
                carry = dec * g
                vb, vc = g * dtv * xv, dyf[:, t, lo:hi, None] * h_t
                sb, sc = vb[:, 0], vc[:, 0]
                for ch in range(1, hi - lo):     # the block's channels
                    sb, sc = sb + vb[:, ch], sc + vc[:, ch]
                db_part[:, t, blk], dc_part[:, t, blk] = sb, sc
        da_part[:, lo:hi] = da
    db, dc = db_part[:, :, 0], dc_part[:, :, 0]
    for blk in range(1, plan.blocks):
        db, dc = db + db_part[:, :, blk], dc + dc_part[:, :, blk]
    da_sum = da_part[0]
    for b in range(1, bsz):
        da_sum = da_sum + da_part[b]
    return (dx, ddt, a * da_sum, db, dc), states


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------
K, T = ss.scan_plan(64, 16).chunk, ss.scan_plan(64, 16).steps
S_EDGES = sorted({1, K - 1, K, K + 1, T - 1, T, T + 1, 2 * T + 3})
N_SWEEP = (1, 2, 8, 16, 32)


def _d_off_grid(n):
    """Two channel blocks, the second ragged."""
    return ss.scan_plan(1, n).channels + 5


def _plain_states(args):
    hs, _ = ss._states(*args, with_y=False)
    return torch.stack(hs, 1)             # (B, S, D, N)


@pytest.mark.parametrize("n", N_SWEEP)
@pytest.mark.parametrize("s", S_EDGES)
def test_emulated_forward_states_bitwise_and_y_matches_pallas(s, n):
    d = _d_off_grid(n)
    arrs = _inputs(2, s, d, n, 31 * s + n)
    args = [_t(a) for a in arrs]
    y, h_final, ckpt = emulate_fwd(*args)
    states = _plain_states(args)
    assert torch.equal(h_final, states[:, -1])
    for c in range(ckpt.shape[1]):
        want = states[:, c * K - 1] if c else torch.zeros_like(h_final)
        assert torch.equal(ckpt[:, c], want), f"checkpoint {c}"
    tol = TOL["float32"] * 5
    for yw, hw in (jref.selective_scan_ref(*map(_j, arrs)),
                   pallas_scan(*map(_j, arrs), block_d=d, chunk=s,
                               interpret=True)):
        np.testing.assert_allclose(y.numpy(), _f32(yw), atol=tol, rtol=tol)
        np.testing.assert_allclose(h_final.numpy(), _f32(hw), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("s", [T + 1, 2 * T + 3])
def test_emulated_forward_bf16_matches_pallas(s):
    """A bf16 model's inputs (x, B, C bf16; dt, a_log f32)."""
    n, d = 16, _d_off_grid(16)
    arrs = _inputs(2, s, d, n, s)
    dts = ("bfloat16", None, None, "bfloat16", "bfloat16")
    y, h_final, _ = emulate_fwd(*(_t(a, dt) for a, dt in zip(arrs, dts)))
    assert y.dtype == torch.bfloat16
    tol = TOL["bfloat16"] * 5
    jargs = [_j(a, dt) for a, dt in zip(arrs, dts)]
    for yw, hw in (jref.selective_scan_ref(*jargs),
                   pallas_scan(*jargs, block_d=d, chunk=s, interpret=True)):
        np.testing.assert_allclose(_f32(y), _f32(yw), atol=tol, rtol=tol)
        np.testing.assert_allclose(h_final.numpy(), _f32(hw), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("n", N_SWEEP)
@pytest.mark.parametrize("s", S_EDGES)
def test_emulated_backward_matches_jax_grad(s, n):
    d = _d_off_grid(n)
    arrs = _inputs(2, s, d, n, 7 * s + n)
    rng = np.random.default_rng(s + n)
    wy = rng.normal(size=(2, s, d)).astype(np.float32)
    wh = rng.normal(size=(2, d, n)).astype(np.float32)

    def jloss(*a):
        y, h = jref.selective_scan_ref(*a)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(_j, arrs))
    args = [_t(a) for a in arrs]
    _, _, ckpt = emulate_fwd(*args)
    got, states = emulate_bwd(*args, ckpt, _t(wy), _t(wh))
    # the windows' recomputed states are the forward's, bit for bit
    assert torch.equal(states, _plain_states(args))
    for name, g, w in zip(("x", "dt", "a_log", "b_in", "c_in"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_emulated_backward_matches_the_plain_backward_without_dh_final():
    """The model discards h_final: no gradient enters at t = S - 1."""
    s, n = 2 * T + 3, 16
    d = _d_off_grid(n)
    args = [_t(a) for a in _inputs(3, s, d, n, 5)]
    dy = torch.randn(3, s, d, generator=torch.Generator().manual_seed(0))
    _, _, ckpt = emulate_fwd(*args)
    got, _ = emulate_bwd(*args, ckpt, dy)
    want = ss.selective_scan_bwd_plain(*args, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


# ----------------------------------------------------------------------
# the plan and the scratch it sizes
# ----------------------------------------------------------------------
def test_scan_plan_depends_on_d_and_n_alone():
    assert list(inspect.signature(ss.scan_plan).parameters) == ["d", "n"]
    for n in (1, 2, 4, 8, 16, 32):
        for d in (1, 63, 64, 65, 200, 8192):
            p = ss.scan_plan(d, n)
            assert p == ss.scan_plan(d, n)
            assert p.per_thread * p.lanes == n and p.lanes <= 8
            # a CTA is whole warps
            assert p.channels * p.lanes % 32 == 0
            assert p.blocks == -(-d // p.channels)
            assert p.steps == p.chunk == 16
    # everything but the block count is a function of N alone
    a, b = ss.scan_plan(8192, 16), ss.scan_plan(100, 16)
    assert dataclasses.replace(a, blocks=0) == dataclasses.replace(
        b, blocks=0)
    for bad in (0, 3, 12, 64):
        with pytest.raises(ValueError, match="power of two"):
            ss.scan_plan(64, bad)


@pytest.mark.parametrize("bsz,s,d,n", [(4, 1024, 8192, 16), (1, 1, 5, 1),
                                       (2, 35, 69, 8), (3, 17, 37, 32)])
def test_scratch_shapes_follow_the_plan(bsz, s, d, n):
    p = ss.scan_plan(d, n)
    want = {"ckpt": (bsz, -(-s // p.chunk), d, n), "da_part": (bsz, d, n),
            "db_part": (bsz, s, p.blocks, n),
            "dc_part": (bsz, s, p.blocks, n)}
    assert ss.scratch_shapes(bsz, s, d, n) == want
    got = ss.scratch(tuple(want), bsz, s, d, n, "cpu")
    assert [tuple(t.shape) for t in got] == list(want.values())
    assert all(t.dtype == torch.float32 for t in got)


class _FakeLib:
    """Stands for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, fn):
        def call(*args):
            self.calls[fn] = args
            return 0
        return call


def test_the_wrappers_allocate_the_plans_scratch(monkeypatch):
    """``_launch_fwd`` and ``selective_scan_bwd`` hand the kernels the
    scratch ``scan_plan`` sizes, and the backward refuses checkpoints of
    another shape. The library is a stand-in: nothing launches."""
    import contextlib
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "check_cuda",
                        lambda name, **t: torch.device("cpu"))
    monkeypatch.setattr(build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    seen = []
    real = ss.scratch

    def spy(names, *shape):
        out = real(names, *shape)
        seen.extend(zip(names, (tuple(t.shape) for t in out)))
        return out

    monkeypatch.setattr(ss, "scratch", spy)
    bsz, s, d, n = 2, 35, 69, 8
    args = [_t(a) for a in _inputs(bsz, s, d, n, 0)]
    y, h, ckpt = ss._launch_fwd(*args)
    assert lib.calls["acar_selective_scan_fwd"][8:12] == (bsz, s, d, n)
    ss.selective_scan_bwd(*args, ckpt, torch.zeros(bsz, s, d))
    assert lib.calls["acar_selective_scan_bwd"][16:20] == (bsz, s, d, n)
    assert dict(seen) == ss.scratch_shapes(bsz, s, d, n)
    with pytest.raises(ValueError, match="checkpoints"):
        ss.selective_scan_bwd(*args, ckpt[:, :-1].contiguous(),
                              torch.zeros(bsz, s, d))
