"""The column-invariant projection: a Hopper kernel and its plain version.

``projection(x, w)`` is x (..., K) @ w (K, N), summed in f32 and rounded
once to x's dtype. The model calls it (``models.layers.project``, through
``kernels.ops``) for every product against a weight that tensor
parallelism splits by columns (``sharding/tp.py``'s ``_COL_PARALLEL``:
``wq``, ``wk``, ``wv``, the decode MLP's ``w_gate`` / ``w_up`` and an
untied ``lm_head``), on one device as on the serving mesh.

It replaces no TPU kernel: the reference leaves these products to XLA.
It exists for the mesh's bit-exactness on the card. cuBLAS picks its
kernel by shape, so a bf16 product over a column slice of w can round
apart from the same columns of the unsliced product (a (1, 2) mesh's
decode logits differed from one device's by 0.0547), and its choice by
M can make a row's bits depend on how many rows share the call. On a
CUDA tensor this launches ``acar_projection`` (``csrc/projection.cu``):
one launch a call, split-K over a cluster of ``SPLIT`` CTAs. Each
cluster serves a tile of ``COLS`` columns by a constant number of token
rows (bf16 ``ROWS_BF16``, on the tensor cores with ``mma.sync``; f32
``ROWS_F32``, on the CUDA cores), rank r sums its range of K
(``projection_plan``: a function of K alone), and the ranks' f32
partials meet over distributed shared memory, added in rank order and
rounded once. Every output element's sum runs in one order that depends
on neither M nor N nor the columns beside it, so the single device and
each model column get the same bits.

What bounds it on the H100: at a decode tick's 8 rows, bytes (each
weight read once: 33.6 MB at (8, 4096, 4096) is 10 us at 3.35 TB/s),
which the 512 CTAs of that shape stream together; at a prefill chunk's
hundreds of rows, the tensor cores and the L2 traffic of x re-read once
a column tile.

bf16 needs K and N that are multiples of 8 and 16-byte-aligned tensors
(TMA's row strides). A misaligned or non-contiguous operand is copied
into a fresh buffer, and a K or N off that grid (whisper-medium's
vocabulary, 51865) is zero-padded to it, for the same kernel: zero
columns of w add columns that are sliced off, and zero products along K
add nothing, as TMA's out-of-bounds fill already does. f32 takes any
shape.

On a CPU tensor it runs ``projection_plain``, ``torch.matmul(x, w)``,
the product every CPU path ran before the kernel, so CPU bits are
unchanged. ``projection.launches`` counts kernel launches. On the card
the call is differentiable (``_Projection``): its backward is two plain
matrix products (dx = dy w^T, dw = x^T dy), as the reference's training
leaves those gradients to XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build

# bf16: TMA's 16-byte row strides, in elements
_BF16_GRID = 8

# csrc/projection.cu: CTAs a cluster, the granule of a K range, a tile's
# columns and its token rows
SPLIT = 8
K_GRANULE = 64
COLS = 64
ROWS_BF16 = 128
ROWS_F32 = 8


@dataclass(frozen=True)
class ProjectionPlan:
    """The kernel's split of a (K, N) product, as ``csrc/projection.cu``
    computes it (``acar_projection_plan`` reports each field)."""
    split: int                         # CTAs a cluster: one tile's ranks
    chunk: int                         # K a rank (the last ones clipped)
    ranges: Tuple[Tuple[int, int], ...]  # rank r's [lo, hi) of K
    cols: int                          # output columns a tile
    rows_bf16: int                     # token rows a tile, bf16
    rows_f32: int                      # token rows a tile, f32
    col_tiles: int                     # tiles along N

    def ctas(self, m: int, dtype: torch.dtype) -> int:
        """The grid's CTAs for m rows: ``split`` a tile."""
        rows = self.rows_bf16 if dtype == torch.bfloat16 else self.rows_f32
        return self.split * self.col_tiles * -(-m // rows)


def projection_plan(k: int, n: int) -> ProjectionPlan:
    """The K ranges, tile sizes and column tiles of the kernel for x
    (M, k) @ w (k, n): rank r sums k over ``ranges[r]``, chunk =
    ceil(k / SPLIT) rounded up to ``K_GRANULE``. The ranges are a
    function of k alone (never of M or N), so a column slice of w and a
    call on fewer rows take the same ones."""
    k, n = int(k), int(n)
    chunk = -(-(-(-k // SPLIT)) // K_GRANULE) * K_GRANULE
    ranges = tuple((min(r * chunk, k), min((r + 1) * chunk, k))
                   for r in range(SPLIT))
    return ProjectionPlan(split=SPLIT, chunk=chunk, ranges=ranges,
                          cols=COLS, rows_bf16=ROWS_BF16,
                          rows_f32=ROWS_F32, col_tiles=-(-n // COLS))


def projection_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N)."""
    return torch.matmul(x, w)


def _check_shapes(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """The shapes and dtypes the kernel takes, checked before the
    device."""
    build.dtype_code(x.dtype, name)
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must share a dtype, got "
                        f"{x.dtype} and {w.dtype}")
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")


def _ready(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` (r, c) as a contiguous, 16-byte-aligned (rows, cols)
    tensor: itself where it already is one, else a zero-padded copy."""
    r, c = t.shape
    if (r, c) == (rows, cols) and t.is_contiguous() and not (
            t.data_ptr() % 16):
        return t
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:r, :c].copy_(t)
    return out


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel on the card: x (..., K) @ w (K, N). Counts the
    launch."""
    name = "projection"
    _check_shapes(name, x, w)
    dev = x.device
    if w.device != dev:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{{{dev}, {w.device}}}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    k, n = w.shape
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m == 0:
        return torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=dev)
    if x.dtype == torch.bfloat16:
        kp = -(-k // _BF16_GRID) * _BF16_GRID
        np_ = -(-n // _BF16_GRID) * _BF16_GRID
        x2, w2 = _ready(x2, m, kp), _ready(w, kp, np_)
    else:
        kp, np_ = k, n
        x2, w2 = x2.contiguous(), w.contiguous()
    out = torch.empty((m, np_), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = build.load().acar_projection(
            x2.data_ptr(), w2.data_ptr(), out.data_ptr(), m, kp, np_,
            build.dtype_code(x.dtype, name), build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(projection)
    if np_ != n:
        out = out[:, :n].contiguous()
    return out.reshape(*x.shape[:-1], n)


class _Projection(torch.autograd.Function):
    """The kernel forward (the plain version on the CPU); a backward of
    two plain matrix products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return projection_plain(x, w)
        return _launch(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = torch.matmul(dy, w.t())
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                          dy.reshape(-1, dy.shape[-1]))
        return dx, dw


def projection(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K), w (K, N) -> (..., N), summed in f32 and rounded once
    to x's dtype: ``projection_plain`` on a CPU tensor, the kernel on a
    CUDA tensor (differentiable in both inputs), which raises on any
    other device."""
    if x.device.type == "cpu":
        return projection_plain(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Projection.apply(x, w)
    return _launch(x, w)


projection.launches = 0

__all__ = ["ProjectionPlan", "projection", "projection_plain",
           "projection_plan"]
