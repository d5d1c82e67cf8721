"""The fused SwiGLU's two bf16 stages on the CPU, and the shapes the
tensor-core kernels take.

On the card a bf16 ``fused_swiglu`` call is two kernels: gate_up (h =
silu(x Wg) * (x Wu), the products and the multiply in f32, h rounded
once to x's dtype) and down (h Wd summed in f32, rounded once). Their
plain versions, ``swiglu_gate_up_plain`` and ``swiglu_down_plain``,
round where the kernels round; ``chip_smoke.py`` holds the kernels
against them on the card. Here their composition is held against the
reference's Pallas kernel run in interpret mode, which rounds h at the
same point (``h.astype(x.dtype)`` before the down product), on the same
numpy inputs: f32 at atol 2e-5 / rtol 2e-4 and bf16 at atol 2e-2 /
rtol 2e-1, the tolerances of ``tests/test_kernels.py``'s SwiGLU sweep.
``fused_swiglu_plain`` (the port of the reference oracle) rounds silu(g)
first, as the oracle does, so only this file holds the kernels' own
rounding point against the Pallas kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_swiglu import fused_swiglu as pallas_swiglu
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_swiglu import (
    swiglu_down_plain, swiglu_gate_up_plain)

# tests/test_kernels.py::test_fused_swiglu_sweep: atol tol, rtol 10 tol
SWIGLU_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-1)}
# tests/test_torch_kernels.py's sweep, and ragged token counts off the
# 8-row block and the 128-row tile
SWIGLU_CASES = [(8, 64, 256), (24, 192, 512), (100, 64, 250),
                (256, 96, 192), (1, 64, 256), (7, 64, 256), (13, 192, 512)]
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(t, d, f):
    rng = np.random.default_rng(t + f)
    x = (rng.normal(size=(t, d)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.05).astype(np.float32)
          for s in ((d, f), (d, f), (f, d))]
    return [x] + ws


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,f", SWIGLU_CASES)
def test_stages_compose_to_the_pallas_kernel(t, d, f, dtype):
    arrs = _inputs(t, d, f)
    x, wg, wu, wd = [torch.from_numpy(a).to(_TDT[dtype]) for a in arrs]
    h = swiglu_gate_up_plain(x, wg, wu)
    got = swiglu_down_plain(h, wd)
    assert h.dtype == x.dtype and tuple(h.shape) == (t, f)
    assert got.dtype == x.dtype and tuple(got.shape) == (t, d)
    want = pallas_swiglu(*[jnp.asarray(a, _JDT[dtype]) for a in arrs],
                         interpret=True)
    atol, rtol = SWIGLU_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("t,d,f", SWIGLU_CASES)
def test_stages_match_the_oracle_port_in_f32(t, d, f):
    """In f32 the kernels' rounding point and the oracle's coincide (no
    rounding but f32's): the stages equal ``fused_swiglu_plain``."""
    x, wg, wu, wd = [torch.from_numpy(a) for a in _inputs(t, d, f)]
    got = swiglu_down_plain(swiglu_gate_up_plain(x, wg, wu), wd)
    np.testing.assert_allclose(
        got.numpy(), tref.fused_swiglu_ref(x, wg, wu, wd).numpy(),
        atol=SWIGLU_TOL["float32"][0], rtol=SWIGLU_TOL["float32"][1])


def _meta(*shapes, dtype):
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


@pytest.mark.parametrize("d,f", [(12, 32), (16, 36), (20, 44)])
def test_bf16_wrapper_raises_for_widths_tma_cannot_stride(d, f):
    """bf16 d_model and d_ff must be multiples of 8 (TMA's 16-byte
    rows): the wrapper raises before it looks at the device."""
    args = _meta((8, d), (d, f), (d, f), (f, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.fused_swiglu(*args)


@pytest.mark.parametrize("dtype,d,f", [(torch.bfloat16, 16, 32),
                                       (torch.float32, 12, 36)])
def test_wrapper_shapes_it_takes_reach_the_device_check(dtype, d, f):
    """A bf16 call with widths the kernels take, and an f32 call (the
    CUDA-core stage kernels take any width), pass the shape checks and
    raise only because ``meta`` has no kernel."""
    args = _meta((8, d), (d, f), (d, f), (f, d), dtype=dtype)
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_swiglu(*args)


def test_bf16_prefill_raises_for_head_dims_without_a_kernel():
    """The bf16 chunked-prefill kernel takes head widths that are
    multiples of 8 up to 256 (the reference sweep's 32 and 96 too); a
    width off that grid or past 256 raises rather than falling back, and
    every taken one passes the check and reaches the device test."""
    m = dict(device="meta")
    for d, match in ((32, "no kernel"), (96, "no kernel"),
                     (128, "no kernel"), (64, "no kernel"),
                     (256, "no kernel"), (12, "multiples of 8"),
                     (264, "up to 256")):
        with pytest.raises(ValueError, match=match):
            ops.chunked_prefill_attention(
                torch.empty(2, 4, 3, d, dtype=torch.bfloat16, **m),
                torch.empty(4, 8, 1, d, dtype=torch.bfloat16, **m),
                torch.empty(4, 8, 1, d, dtype=torch.bfloat16, **m),
                torch.empty(2, 2, dtype=torch.int32, **m),
                torch.empty(2, 4, dtype=torch.int32, **m), prompt_len=9)
