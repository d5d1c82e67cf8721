"""Fused SwiGLU MLP: the Hopper kernels and their plain versions.

``fused_swiglu`` is the wrapper the model calls (the prefill MLP,
``models.transformer.mlp_apply``, through ``kernels.ops``). On a CUDA
tensor it launches the hand-written kernels in ``csrc/fused_swiglu.cu``
(they replace the Pallas kernel ``repro/kernels/fused_swiglu.py``) or
raises; on a CPU tensor it runs ``fused_swiglu_plain``, the PyTorch port
of the reference oracle ``kernels/ref.py::fused_swiglu_ref``.
``fused_swiglu.launches`` counts wrapper calls that reached the card. A
bf16 call is two CUDA launches, one tensor-core GEMM kernel per stage:
``swiglu_gate_up`` (h = silu(x Wg) * (x Wu) in f32, rounded to bf16
into a (T, F) scratch) and ``swiglu_down`` (h Wd). Each stage has its
plain version beside it (``swiglu_gate_up_plain``,
``swiglu_down_plain``), which rounds where the kernel and the Pallas
kernel round. An f32 call is one launch of the CUDA-core kernel.

``fused_swiglu_plain`` rounds silu(x Wg) to x's dtype before multiplying
by x Wu, as the oracle does; the kernels multiply in f32, as the Pallas
kernel does. The two agree to float32 rounding in f32 and differ by
bf16 rounding in bf16.

The wrapper is differentiable (``_FusedSwiGLU``): its backward
recomputes g = x Wg and u = x Wu and forms the gradients of the
function the kernel computes (silu and the multiply in f32, h rounded to
x's dtype) with four plain matrix products, as the reference's training
leaves that gradient to XLA outside any kernel. The same backward runs
after the kernel on the card and after the plain version on the CPU.
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


def swiglu_gate_up_plain(x: torch.Tensor, w_gate: torch.Tensor,
                         w_up: torch.Tensor) -> torch.Tensor:
    """Stage 1 of the kernels: h = silu(x Wg) * (x Wu), both products
    and the multiply in f32, h rounded once to x's dtype. (T, F)."""
    g = torch.matmul(x.float(), w_gate.float())
    u = torch.matmul(x.float(), w_up.float())
    return (torch.nn.functional.silu(g) * u).to(x.dtype)


def swiglu_down_plain(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Stage 2 of the kernels: h Wd summed in f32, rounded once to h's
    dtype. (T, D)."""
    return torch.matmul(h.float(), w_down.float()).to(h.dtype)


def fused_swiglu_bwd(x: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor,
                     dy: torch.Tensor):
    """Gradients (dx, dw_gate, dw_up, dw_down) of
    out = h Wd, h = (silu(g) * u rounded to x's dtype), g = x Wg,
    u = x Wu, with silu and the multiply in f32. The rounding of h passes
    the gradient through unchanged."""
    g = torch.matmul(x, w_gate).float()
    u = torch.matmul(x, w_up).float()
    sig = torch.sigmoid(g)
    s = g * sig
    h = (s * u).to(x.dtype)
    dy = dy.to(x.dtype)
    dw_down = torch.matmul(h.t(), dy)
    dh = torch.matmul(dy, w_down.t()).float()
    du = (dh * s).to(x.dtype)
    dg = (dh * u * (sig * (1.0 + g * (1.0 - sig)))).to(x.dtype)
    dx = torch.matmul(dg, w_gate.t()) + torch.matmul(du, w_up.t())
    return dx, torch.matmul(x.t(), dg), torch.matmul(x.t(), du), dw_down


class _FusedSwiGLU(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward; the
    recomputing backward of ``fused_swiglu_bwd``."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        if x.device.type == "cpu":
            return fused_swiglu_plain(x, w_gate, w_up, w_down)
        return _launch(x, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        return fused_swiglu_bwd(*ctx.saved_tensors, dy)


def fused_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor) -> torch.Tensor:
    """x: (T, D); w_gate/w_up: (D, F); w_down: (F, D) -> (T, D),
    differentiable in every input."""
    return _FusedSwiGLU.apply(x, w_gate, w_up, w_down)


def _check_shapes(name: str, x: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor) -> None:
    """The shapes and dtypes the kernels take, checked before the
    device."""
    build.dtype_code(x.dtype, name)
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
    if x.dtype == torch.bfloat16:
        if d % 8 or f % 8:
            raise ValueError(
                f"{name}: the bf16 kernels take d_model and d_ff that are "
                f"multiples of 8 (TMA's 16-byte rows), got {d} and {f}")
    elif d > 4096:
        raise ValueError(f"{name}: the f32 kernel takes d_model <= 4096")


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: TMA needs 16-byte-aligned tensors")


def _launch_gate_up(x: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor) -> torch.Tensor:
    """Stage 1 on the card (bf16): h (T, F). Counts no launch."""
    name = "swiglu_gate_up"
    dev = build.check_cuda(name, x=x, w_gate=w_gate, w_up=w_up)
    t, d = x.shape
    f = w_gate.shape[1]
    h = torch.empty((t, f), dtype=x.dtype, device=dev)
    _check_aligned(name, x, w_gate, w_up, h)
    with torch.cuda.device(dev):
        err = build.load().acar_swiglu_gate_up(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), h.data_ptr(),
            t, d, f, build.stream_handle(dev))
    build.check(err, name)
    return h


def _launch_down(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Stage 2 on the card (bf16): h Wd (T, D). Counts no launch."""
    name = "swiglu_down"
    dev = build.check_cuda(name, h=h, w_down=w_down)
    t, f = h.shape
    d = w_down.shape[1]
    out = torch.empty((t, d), dtype=h.dtype, device=dev)
    _check_aligned(name, h, w_down, out)
    with torch.cuda.device(dev):
        err = build.load().acar_swiglu_down(
            h.data_ptr(), w_down.data_ptr(), out.data_ptr(), t, d, f,
            build.stream_handle(dev))
    build.check(err, name)
    return out


def _launch(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    name = "fused_swiglu"
    _check_shapes(name, x, w_gate, w_up, w_down)
    dev = build.check_cuda(name, x=x, w_gate=w_gate, w_up=w_up,
                           w_down=w_down)
    t, d = x.shape
    f = w_gate.shape[1]
    if t == 0:
        return torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        out = _launch_down(_launch_gate_up(x, w_gate, w_up), w_down)
    else:
        out = torch.empty_like(x)
        with torch.cuda.device(dev):
            err = build.load().acar_fused_swiglu(
                x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                w_down.data_ptr(), out.data_ptr(), t, d, f,
                build.stream_handle(dev))
        build.check(err, name)
    build.count_launch(fused_swiglu)
    return out


fused_swiglu.launches = 0
