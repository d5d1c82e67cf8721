"""The port's training-path kernels on the CPU: the selective scan and
the RG-LRU scan, forward and backward, and the fused SwiGLU's gradient.

Each plain forward is held against the reference's oracle
(``repro.kernels.ref``) and against the reference's Pallas kernel run
in interpret mode, on the same numpy inputs, with the sweeps and
tolerances of ``tests/test_kernels.py`` (S capped at 256): selective
scan y at 5 x (2e-5 f32, 2e-2 bf16), h at atol 1e-4 / rtol 1e-3; RG-LRU
at 1e-5. Each backward (the autograd Function on CPU tensors, which
runs the plain reverse recurrence) is held against ``jax.grad`` of the
reference oracle, f32, atol 1e-5 and rtol 1e-4 for every input's
gradient. The Hopper kernels run only on a card (``chip_smoke.py``
holds them against these plain versions there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(_TDT[dtype]) if dtype else t


def _j(a, dtype=None):
    return jnp.asarray(a, _JDT[dtype]) if dtype else jnp.asarray(a)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _scan_inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, d)) * 0.5).astype(np.float32)
    dt = (_softplus(rng.normal(size=(b, s, d))) * 0.1).astype(np.float32)
    a_log = (rng.normal(size=(d, n)) * 0.3).astype(np.float32)
    b_in = rng.normal(size=(b, s, n)).astype(np.float32)
    c_in = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a_log, b_in, c_in


# tests/test_kernels.py's sweep, the (2, 512, ...) case at S = 256
SCAN_CASES = [
    (1, 128, 64, 8, 64, 64),
    (2, 256, 128, 16, 64, 128),
    (2, 256, 256, 16, 256, 128),
    (1, 96, 48, 4, 48, 96),       # non-divisible fallbacks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,n,bd,ck", SCAN_CASES)
def test_selective_scan_plain_matches_oracle_and_pallas(b, s, d, n, bd, ck,
                                                        dtype):
    x, dt, a_log, b_in, c_in = _scan_inputs(b, s, d, n, s + d)
    # a_log stays f32, as in the reference's sweep and in a bf16 model
    targs = (_t(x, dtype), _t(dt, dtype), _t(a_log), _t(b_in, dtype),
             _t(c_in, dtype))
    jargs = (_j(x, dtype), _j(dt, dtype), _j(a_log), _j(b_in, dtype),
             _j(c_in, dtype))
    y, h = tref.selective_scan_ref(*targs)
    assert y.dtype == _TDT[dtype] and h.dtype == torch.float32
    tol = TOL[dtype] * 5
    for yw, hw in (jref.selective_scan_ref(*jargs),
                   pallas_scan(*jargs, block_d=bd, chunk=ck,
                               interpret=True)):
        _close(y, yw, tol, tol)
        _close(h, hw, 1e-4, 1e-3)


RGLRU_CASES = [
    (1, 128, 128, 128, 128),
    (2, 256, 256, 128, 128),
    (2, 256, 96, 96, 128),
]


@pytest.mark.parametrize("b,s,w,bw,ck", RGLRU_CASES)
def test_rglru_scan_plain_matches_oracle_and_pallas(b, s, w, bw, ck):
    rng = np.random.default_rng(s + w)
    a = rng.uniform(0.7, 0.999, size=(b, s, w)).astype(np.float32)
    u = (rng.normal(size=(b, s, w)) * 0.1).astype(np.float32)
    hs, hf = tref.rglru_scan_ref(_t(a), _t(u))
    for hsw, hfw in (jref.rglru_scan_ref(_j(a), _j(u)),
                     pallas_rglru(_j(a), _j(u), block_w=bw, chunk=ck,
                                  interpret=True)):
        _close(hs, hsw, 1e-5, 1e-5)
        _close(hf, hfw, 1e-5, 1e-5)


# ----------------------------------------------------------------------
# backward: the autograd Functions against jax.grad of the oracles
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,s,d,n", [(2, 64, 32, 8), (1, 41, 24, 16),
                                     (3, 17, 40, 4)])
def test_selective_scan_grad_matches_jax_grad(b, s, d, n):
    args = _scan_inputs(b, s, d, n, 7 * s + n)
    rng = np.random.default_rng(s)
    wy = rng.normal(size=(b, s, d)).astype(np.float32)
    wh = rng.normal(size=(b, d, n)).astype(np.float32)

    def jloss(*a):
        y, h = jref.selective_scan_ref(*a)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(_j, args))
    targs = [_t(a).requires_grad_(True) for a in args]
    y, h = ops.selective_scan(*targs)
    loss = (y * _t(wy)).sum() + (h * _t(wh)).sum()
    got = torch.autograd.grad(loss, targs)
    for name, g, w in zip(("x", "dt", "a_log", "b_in", "c_in"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,s,w", [(2, 64, 48), (1, 130, 20)])
def test_rglru_scan_grad_matches_jax_grad(b, s, w):
    rng = np.random.default_rng(s + w)
    a = rng.uniform(0.7, 0.999, size=(b, s, w)).astype(np.float32)
    u = (rng.normal(size=(b, s, w)) * 0.1).astype(np.float32)
    whs = rng.normal(size=(b, s, w)).astype(np.float32)
    whf = rng.normal(size=(b, w)).astype(np.float32)

    def jloss(a, u):
        hs, hf = jref.rglru_scan_ref(a, u)
        return jnp.sum(hs * whs) + jnp.sum(hf * whf)

    want = jax.grad(jloss, argnums=(0, 1))(_j(a), _j(u))
    ta, tu = _t(a).requires_grad_(True), _t(u).requires_grad_(True)
    hs, hf = ops.rglru_scan(ta, tu)
    got = torch.autograd.grad((hs * _t(whs)).sum() + (hf * _t(whf)).sum(),
                              (ta, tu))
    for name, g, w in zip(("a", "u"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_scan_grads_with_one_output_unused():
    """The model discards h_final (and the RG-LRU's): the Functions take
    no gradient for it, and a loss on h_final alone gives y no part."""
    args = [_t(a).requires_grad_(True)
            for a in _scan_inputs(1, 9, 8, 4, 3)]
    y, h = ops.selective_scan(*args)
    g_y = torch.autograd.grad(y.sum(), args)
    y2, h2 = ops.selective_scan(*args)
    g_both = torch.autograd.grad(y2.sum() + 0.0 * h2.sum(), args)
    for a, b2 in zip(g_y, g_both):
        torch.testing.assert_close(a, b2, rtol=0, atol=0)
    a = torch.rand(1, 6, 5, requires_grad=True)
    u = torch.randn(1, 6, 5, requires_grad=True)
    _, hf = ops.rglru_scan(a, u)
    ga, gu = torch.autograd.grad(hf.sum(), (a, u))
    # only h_final's path: du_t = prod_{k>t} a_k, and du_{S-1} = 1
    assert torch.equal(gu[:, -1], torch.ones(1, 5))


SWIGLU_GRAD_CASES = [(8, 64, 256), (24, 192, 512), (100, 64, 250)]


@pytest.mark.parametrize("t,d,f", SWIGLU_GRAD_CASES)
def test_fused_swiglu_grad_matches_jax_grad(t, d, f):
    rng = np.random.default_rng(t + f)
    x = (rng.normal(size=(t, d)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.05).astype(np.float32)
          for s in ((d, f), (d, f), (f, d))]
    wy = rng.normal(size=(t, d)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jref.fused_swiglu_ref(*a) * wy)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(_j(x), *map(_j, ws))
    targs = [_t(a).requires_grad_(True) for a in [x] + ws]
    out = ops.fused_swiglu(*targs)
    got = torch.autograd.grad((out * _t(wy)).sum(), targs)
    for name, g, w in zip(("x", "w_gate", "w_up", "w_down"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_fused_swiglu_forward_unchanged_by_the_function():
    """Serving calls the differentiable wrapper under no_grad: its output
    is the plain version's, bit for bit, in f32 and bf16."""
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((16, 32), (32, 48), (32, 48), (48, 32))]
    for dtype in ("float32", "bfloat16"):
        ts = [_t(a, dtype) for a in arrs]
        with torch.no_grad():
            got = ops.fused_swiglu(*ts)
        assert torch.equal(got, tref.fused_swiglu_ref(*ts))
        assert got.grad_fn is None


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------
def test_cpu_scans_launch_nothing():
    ops.reset_launch_counts()
    args = [_t(a).requires_grad_(True)
            for a in _scan_inputs(1, 5, 8, 4, 0)]
    y, _ = ops.selective_scan(*args)
    y.sum().backward()
    a = torch.rand(1, 5, 4, requires_grad=True)
    hs, _ = ops.rglru_scan(a, torch.randn(1, 5, 4))
    hs.sum().backward()
    assert all(v == 0 for v in ops.launch_counts().values())
    assert {"selective_scan", "selective_scan_bwd", "rglru_scan",
            "rglru_scan_bwd"} <= set(ops.launch_counts())


def test_scan_wrappers_raise_off_the_cpu_instead_of_falling_back():
    m = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.selective_scan(torch.empty(1, 4, 8, **m),
                           torch.empty(1, 4, 8, **m),
                           torch.empty(8, 4, **m), torch.empty(1, 4, 4, **m),
                           torch.empty(1, 4, 4, **m))
    with pytest.raises(ValueError, match="no kernel"):
        ops.rglru_scan(torch.empty(1, 4, 8, **m), torch.empty(1, 4, 8, **m))
