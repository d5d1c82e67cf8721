"""The f32 SwiGLU stage kernels' split of K, on the CPU.

On the card an f32 ``fused_swiglu`` call runs two stage kernels
(``csrc/fused_swiglu.cu``: gate_up, then down) that split each product
over K across a thread-block cluster: rank r sums k over
``swiglu_f32_plan(k, n).ranges[r]`` in order, and the ranks' partials are
added in rank order, g and u each combined before silu(g) * u. Here the
plan is held to its contract (the ranges tile [0, k) in order and depend
on k alone), and a torch emulation of the split (each rank's partial a
plain f32 product over its range, added in rank order, silu after the
combine) is held against the reference's oracle and its Pallas kernel in
interpret mode at the reference's f32 SwiGLU tolerance. It emulates the
split, not the kernel's inner loop (one fmaf chain per element, 16 k a
ring stage), whose sums differ from a matmul's by f32 rounding; the card
holds the kernels themselves against their plain versions
(``chip_smoke.py`` phase 3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_swiglu import fused_swiglu as pallas_swiglu
from repro.kernels.ref import fused_swiglu_ref
from repro_torch.kernels import ops
from repro_torch.kernels.fused_swiglu import (
    F32_K_STEP, F32_MAX_SPLIT, F32_MIN_CHUNK, swiglu_f32_plan)

# tests/test_kernels.py::test_fused_swiglu_sweep: atol tol, rtol 10 tol
F32_TOL = (2e-5, 2e-4)
# tests/test_torch_kernels.py's sweep, and widths whose products split
# over 2 to 8 ranks with a ragged last range
SWIGLU_CASES = [(8, 64, 256), (24, 192, 512), (100, 64, 250),
                (256, 96, 192), (13, 1000, 2050), (7, 4093, 1024)]
PLAN_KS = (1, 15, 16, 17, 64, 127, 128, 255, 256, 257, 576, 1000, 1023,
           1024, 1536, 2560, 4093, 4096, 5120, 7680, 14336, 16384)


def _inputs(t, d, f):
    rng = np.random.default_rng(t + f)
    x = (rng.normal(size=(t, d)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.05).astype(np.float32)
          for s in ((d, f), (d, f), (f, d))]
    return [x] + ws


def split_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (T, k) @ w (k, n) as the kernels split it: each rank's partial
    over its range of k, the partials added in rank order 0..n-1."""
    k, n = w.shape
    out = None
    for lo, hi in swiglu_f32_plan(k, n).ranges:
        part = (a[:, lo:hi] @ w[lo:hi] if hi > lo
                else torch.zeros(a.shape[0], n, dtype=a.dtype))
        out = part if out is None else out + part
    return out


def split_swiglu(x, wg, wu, wd) -> torch.Tensor:
    """The two stages: g and u each combined over their ranks, then
    silu(g) * u in f32 once, then h Wd over the down stage's ranks."""
    h = torch.nn.functional.silu(split_product(x, wg)) * split_product(
        x, wu)
    return split_product(h, wd)


@pytest.mark.parametrize("k", PLAN_KS)
def test_plan_ranges_tile_k_in_order(k):
    p = swiglu_f32_plan(k, 4096)
    assert 1 <= p.split <= F32_MAX_SPLIT and p.split & (p.split - 1) == 0
    assert len(p.ranges) == p.split and p.chunk % F32_K_STEP == 0
    assert p.ranges[0][0] == 0 and p.ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(p.ranges, p.ranges[1:]):
        assert lo <= hi == lo2
    assert all(hi - lo <= p.chunk for lo, hi in p.ranges)
    # past one rank, each rank but a clipped last one has its minimum
    if p.split > 1:
        assert p.ranges[0][1] >= F32_MIN_CHUNK
    if p.split < F32_MAX_SPLIT:
        assert k < 2 * p.split * F32_MIN_CHUNK


@pytest.mark.parametrize("k", PLAN_KS)
def test_plan_depends_on_k_alone(k):
    """Equal ranges at n, n / 2 and n / 4 (a column slice of the
    weights) and for any T; only the column tiles follow n."""
    n = 4096
    plans = [swiglu_f32_plan(k, n // m) for m in (1, 2, 4)]
    assert len({(p.split, p.chunk, p.ranges) for p in plans}) == 1
    assert [p.gate_up_col_tiles for p in plans] == [
        -(-n // (m * p.gate_up_cols)) for m, p in zip((1, 2, 4), plans)]
    p = plans[0]
    for t in (1, 8, 63, 64, 65, 4096):
        assert p.ctas(t, "gate_up") == (
            p.split * p.gate_up_col_tiles * -(-t // p.rows))
        assert p.ctas(t, "down") == (
            p.split * p.down_col_tiles * -(-t // p.rows))


@pytest.mark.parametrize("t,d,f", SWIGLU_CASES)
def test_split_emulation_matches_the_oracle_and_pallas(t, d, f):
    arrs = _inputs(t, d, f)
    got = split_swiglu(*[torch.from_numpy(a) for a in arrs]).numpy()
    want = np.asarray(fused_swiglu_ref(*[jnp.asarray(a) for a in arrs]))
    np.testing.assert_allclose(got, want, atol=F32_TOL[0], rtol=F32_TOL[1])
    pallas = np.asarray(pallas_swiglu(*[jnp.asarray(a) for a in arrs],
                                      interpret=True))
    np.testing.assert_allclose(got, pallas, atol=F32_TOL[0],
                               rtol=F32_TOL[1])


def _meta(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


@pytest.mark.parametrize("d,f", [(1, 1), (33, 37), (4093, 1023),
                                 (6144, 16384)])
def test_f32_stage_wrappers_take_any_width(d, f):
    """The f32 stage kernels take any d_model and d_ff: each wrapper
    passes its shape checks and raises only because ``meta`` has no
    kernel."""
    x, wg, wu, wd = _meta((8, d), (d, f), (d, f), (f, d))
    for call in (lambda: ops.fused_swiglu(x, wg, wu, wd),
                 lambda: ops.swiglu_gate_up(x, wg, wu),
                 lambda: ops.swiglu_down(_meta((8, f))[0], wd)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


@pytest.mark.parametrize("dk,dv", [(1, 1), (33, 20), (64, 64), (130, 256),
                                   (256, 256)])
def test_f32_prefill_takes_any_width_up_to_256(dk, dv):
    m = dict(dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.chunked_prefill_attention(
            torch.empty(2, 4, 4, dk, **m), torch.empty(4, 8, 2, dk, **m),
            torch.empty(4, 8, 2, dv, **m),
            torch.empty(2, 2, dtype=torch.int32, device="meta"),
            torch.empty(2, 4, dtype=torch.int32, device="meta"),
            prompt_len=9)
