"""Fused SwiGLU MLP: the Hopper kernel and its plain version.

``fused_swiglu`` is the wrapper the model calls (the prefill MLP,
``models.transformer.mlp_apply``, through ``kernels.ops``). On a CUDA
tensor it launches the hand-written kernel in ``csrc/fused_swiglu.cu``
(it replaces the Pallas kernel ``repro/kernels/fused_swiglu.py``) or
raises; on a CPU tensor it runs ``fused_swiglu_plain``, the PyTorch port
of the reference oracle ``kernels/ref.py::fused_swiglu_ref``.
``fused_swiglu.launches`` counts kernel launches.

The plain version rounds silu(x Wg) to x's dtype before multiplying by
x Wu, as the oracle does; the kernel multiplies in f32, as the Pallas
kernel does. The two agree to float32 rounding in f32 and differ by
bf16 rounding in bf16.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def fused_swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor,
                       w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x @ w_gate) * (x @ w_up) @ w_down.

    x: (T, D); w_gate/w_up: (D, F); w_down: (F, D).
    """
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)


def fused_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor) -> torch.Tensor:
    """x: (T, D); w_gate/w_up: (D, F); w_down: (F, D) -> (T, D)."""
    if x.device.type == "cpu":
        return fused_swiglu_plain(x, w_gate, w_up, w_down)
    name = "fused_swiglu"
    dev = build.check_cuda(name, x=x, w_gate=w_gate, w_up=w_up,
                           w_down=w_down)
    code = build.dtype_code(x.dtype, name)
    if any(w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError(f"{name}: x and the weights must share a dtype")
    t, d = x.shape
    f = w_gate.shape[1]
    if (w_gate.shape != (d, f) or w_up.shape != (d, f)
            or w_down.shape != (f, d)):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, w_gate "
            f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, w_down "
            f"{tuple(w_down.shape)}")
    if d > 1024:
        raise ValueError(f"{name}: the kernel takes d_model <= 1024")
    out = torch.empty_like(x)
    if t == 0:
        return out
    with torch.cuda.device(dev):
        err = build.load().acar_fused_swiglu(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), out.data_ptr(), t, d, f, code,
            build.stream_handle(dev))
    build.check(err, name)
    fused_swiglu.launches += 1
    return out


fused_swiglu.launches = 0
