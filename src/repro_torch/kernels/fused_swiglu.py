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
kernel round. An f32 call is two launches too, one
``swiglu_f32_gemm_kernel`` a stage: a register-tiled CUDA-core GEMM
that takes any d_model and d_ff and splits K over a thread-block cluster
by K alone (``swiglu_f32_plan``, checked on the card against the
library's ``acar_swiglu_f32_plan``), the ranks' partials added in rank
order. ``swiglu_gate_up.f32_launches`` and the like count the f32 calls
apart.

Tensor parallelism (the serving mesh, ``sharding/tp.py``) splits Wg and
Wu by columns and gathers h between the stages, so it calls the two
stages as wrappers of their own: ``swiglu_gate_up`` (x, a column slice
of Wg and Wu -> that slice of h) and ``swiglu_down`` (the gathered h, the
whole Wd), each with its own ``launches`` count. In bf16 they launch the
fused wrapper's two GEMM kernels, in f32 its two CUDA-core stage
kernels, so gate_up then down gives the fused call's bits; in f32 an
element's sum runs in an order fixed by K alone, so a column slice of
Wg and Wu gives the same columns of h. On a CPU
tensor they run the stages' plain versions.

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

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build

# csrc/fused_swiglu.cu, the f32 stages: a tile's token rows, its columns
# of h (gate_up: Wg's and Wu's columns side by side) and of out (down),
# the K a ring stage, and the split of K: up to F32_MAX_SPLIT CTAs a
# cluster, each rank at least F32_MIN_CHUNK of K
F32_ROWS = 64
F32_GATE_UP_COLS = 64
F32_DOWN_COLS = 128
F32_K_STEP = 16
F32_MAX_SPLIT = 8
F32_MIN_CHUNK = F32_K_STEP


@dataclass(frozen=True)
class SwigluF32Plan:
    """The f32 stage kernels' split of a product over K (x (T, k) Wg /
    Wu (k, n), or h (T, k) Wd (k, n)), as ``csrc/fused_swiglu.cu``
    computes it (``acar_swiglu_f32_plan`` reports each field)."""
    split: int                           # CTAs a cluster: one tile's ranks
    chunk: int                           # K a rank (the last ones clipped)
    ranges: Tuple[Tuple[int, int], ...]  # rank r's [lo, hi) of K
    rows: int                            # token rows a tile
    gate_up_cols: int                    # columns of h a gate_up tile
    down_cols: int                       # columns of out a down tile
    k_step: int                          # K a ring stage
    gate_up_col_tiles: int               # gate_up tiles along n
    down_col_tiles: int                  # down tiles along n

    def ctas(self, t: int, stage: str) -> int:
        """The grid's CTAs over t token rows for ``stage`` ("gate_up" or
        "down"): ``split`` a tile."""
        tiles = (self.gate_up_col_tiles if stage == "gate_up"
                 else self.down_col_tiles)
        return self.split * tiles * -(-t // self.rows)


def swiglu_f32_plan(k: int, n: int) -> SwigluF32Plan:
    """The K ranges, tiles and grid of the f32 stage kernels for a
    product over k into n columns: the split doubles from 1 while every
    rank keeps at least ``F32_MIN_CHUNK`` of k, up to ``F32_MAX_SPLIT``;
    rank r sums k over ``ranges[r]``, chunk = ceil(k / split) rounded up
    to ``F32_K_STEP``. The ranges are a function of k alone (never of T
    or n), so rows called alone and column slices of the weights take
    the same ones."""
    k, n = int(k), int(n)
    split = 1
    while split < F32_MAX_SPLIT and k >= 2 * split * F32_MIN_CHUNK:
        split *= 2
    chunk = -(-(-(-k // split)) // F32_K_STEP) * F32_K_STEP
    ranges = tuple((min(r * chunk, k), min((r + 1) * chunk, k))
                   for r in range(split))
    return SwigluF32Plan(
        split=split, chunk=chunk, ranges=ranges, rows=F32_ROWS,
        gate_up_cols=F32_GATE_UP_COLS, down_cols=F32_DOWN_COLS,
        k_step=F32_K_STEP, gate_up_col_tiles=-(-n // F32_GATE_UP_COLS),
        down_col_tiles=-(-n // F32_DOWN_COLS))

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


def _check_dims(name: str, dtype: torch.dtype, d: int, f: int) -> None:
    """The widths the kernels take: bf16 needs multiples of 8, f32 takes
    any."""
    if dtype == torch.bfloat16 and (d % 8 or f % 8):
        raise ValueError(
            f"{name}: the bf16 kernels take d_model and d_ff that are "
            f"multiples of 8 (TMA's 16-byte rows), got {d} and {f}")


def _check_shapes(name: str, x: torch.Tensor, *ws: torch.Tensor) -> None:
    """The shapes and dtypes the kernels take, checked before the
    device: ``ws`` is (w_gate, w_up, w_down), or (w_gate, w_up) for
    stage 1."""
    build.dtype_code(x.dtype, name)
    if any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"{name}: x and the weights must share a dtype")
    t, d = x.shape
    f = ws[0].shape[1]
    want = ((d, f), (d, f), (f, d))[:len(ws)]
    if tuple(tuple(w.shape) for w in ws) != want:
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, weights "
            f"{[tuple(w.shape) for w in ws]}")
    _check_dims(name, x.dtype, d, f)


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


def _launch_gate_up_f32(x: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor) -> torch.Tensor:
    """Stage 1 on the card (f32): h (T, F). Counts no launch."""
    name = "swiglu_gate_up"
    dev = build.check_cuda(name, x=x, w_gate=w_gate, w_up=w_up)
    t, d = x.shape
    f = w_gate.shape[1]
    h = torch.empty((t, f), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = build.load().acar_swiglu_gate_up_f32(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), h.data_ptr(),
            t, d, f, build.stream_handle(dev))
    build.check(err, name)
    return h


def _launch_down_f32(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Stage 2 on the card (f32): h Wd (T, D). Counts no launch."""
    name = "swiglu_down"
    dev = build.check_cuda(name, h=h, w_down=w_down)
    t, f = h.shape
    d = w_down.shape[1]
    out = torch.empty((t, d), dtype=h.dtype, device=dev)
    with torch.cuda.device(dev):
        err = build.load().acar_swiglu_down_f32(
            h.data_ptr(), w_down.data_ptr(), out.data_ptr(), t, d, f,
            build.stream_handle(dev))
    build.check(err, name)
    return out


def swiglu_gate_up(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor) -> torch.Tensor:
    """Stage 1 of the SwiGLU on its own: x (T, D), w_gate/w_up (D, F)
    -> h = silu(x Wg) * (x Wu) (T, F), rounded to x's dtype. The
    kernel on a CUDA tensor (counted in ``swiglu_gate_up.launches``),
    ``swiglu_gate_up_plain`` on a CPU tensor."""
    if x.device.type == "cpu":
        return swiglu_gate_up_plain(x, w_gate, w_up)
    f = w_gate.shape[1]
    _check_shapes("swiglu_gate_up", x, w_gate, w_up)
    if x.shape[0] == 0:
        return torch.empty((0, f), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        h = _launch_gate_up(x, w_gate, w_up)
    else:
        h = _launch_gate_up_f32(x, w_gate, w_up)
    build.count_launch(swiglu_gate_up, x.dtype)
    return h


def swiglu_down(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Stage 2 of the SwiGLU on its own: h (T, F), w_down (F, D) ->
    h Wd (T, D), summed in f32 and rounded to h's dtype. The kernel on
    a CUDA tensor (counted in ``swiglu_down.launches``),
    ``swiglu_down_plain`` on a CPU tensor."""
    if h.device.type == "cpu":
        return swiglu_down_plain(h, w_down)
    name = "swiglu_down"
    f, d = w_down.shape
    if h.dtype != w_down.dtype or h.shape[1] != f:
        raise ValueError(f"{name}: h {tuple(h.shape)} {h.dtype}, w_down "
                         f"{tuple(w_down.shape)} {w_down.dtype}")
    build.dtype_code(h.dtype, name)
    _check_dims(name, h.dtype, d, f)
    if h.shape[0] == 0:
        return torch.empty((0, d), dtype=h.dtype, device=h.device)
    if h.dtype == torch.bfloat16:
        out = _launch_down(h, w_down)
    else:
        out = _launch_down_f32(h, w_down)
    build.count_launch(swiglu_down, h.dtype)
    return out


def _launch(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    name = "fused_swiglu"
    _check_shapes(name, x, w_gate, w_up, w_down)
    build.check_cuda(name, x=x, w_gate=w_gate, w_up=w_up, w_down=w_down)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        out = _launch_down(_launch_gate_up(x, w_gate, w_up), w_down)
    else:
        out = _launch_down_f32(_launch_gate_up_f32(x, w_gate, w_up), w_down)
    build.count_launch(fused_swiglu, x.dtype)
    return out


fused_swiglu.launches = 0
swiglu_gate_up.launches = 0
swiglu_down.launches = 0
fused_swiglu.f32_launches = 0
swiglu_gate_up.f32_launches = 0
swiglu_down.f32_launches = 0
