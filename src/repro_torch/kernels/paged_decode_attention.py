"""Paged GQA decode attention: the Hopper kernel and its plain version.

``paged_decode_attention`` is the wrapper the model calls
(``models.attention.gqa_decode_paged`` through ``kernels.ops``). On a
CUDA tensor it launches the hand-written kernel in
``csrc/paged_decode_attention.cu`` (it replaces the Pallas kernel
``repro/kernels/paged_decode_attention.py``) or raises; on a CPU tensor
it runs ``paged_decode_attention_plain``, the PyTorch port of the
reference oracle ``kernels/ref.py::paged_decode_attention_ref``.
``paged_decode_attention.launches`` counts kernel launches: one per
call, whatever the shape (the kernel splits each row's keys over a
cluster of CTAs and combines them inside the same launch).

``split_ranges`` gives the key range each CTA of a row's cluster takes,
as ``csrc/decode_split.cuh`` computes it (the library exports that
arithmetic as ``acar_decode_split_start``, and ``chip_smoke.py`` holds
the two together); the dense-cache decode shares it.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

# csrc/decode_split.cuh: CTAs per cluster, and the granule of a range
SPLIT = 8
SPLIT_GRANULE = 16
# the head widths the four split decodes take: Dk and Dv each up to
# MAX_HEAD_DIM; above WIDE_HEAD_DIM a lane holds two 16-byte vectors of a
# key row, so those widths must be multiples of 8 (whole vectors of bf16)
MAX_HEAD_DIM = 256
WIDE_HEAD_DIM = 128


def check_head_dims(name: str, dk: int, dv: int) -> None:
    """Raise unless the split decodes take key width ``dk`` and value
    width ``dv``: each in 1..128, or a multiple of 8 up to 256."""
    for what, d in (("dk", dk), ("dv", dv)):
        if not 0 < d <= MAX_HEAD_DIM or (d > WIDE_HEAD_DIM and d % 8):
            raise ValueError(
                f"{name}: the kernel takes head widths up to "
                f"{WIDE_HEAD_DIM}, or multiples of 8 up to {MAX_HEAD_DIM}; "
                f"got {what} {d}")


def split_ranges(length: int) -> List[Tuple[int, int]]:
    """The positions ``[lo, hi)`` that each of the ``SPLIT`` ranks of a
    row's cluster takes, in rank order, for a row of ``length`` valid
    positions: ``ceil(length / SPLIT)`` rounded up to ``SPLIT_GRANULE``
    positions a rank, the last ones clipped (possibly empty). A function
    of the row's own length alone."""
    length = max(int(length), 0)
    chunk = -(-(-(-length // SPLIT)) // SPLIT_GRANULE) * SPLIT_GRANULE
    return [(min(r * chunk, length), min((r + 1) * chunk, length))
            for r in range(SPLIT)]


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode attention over a paged KV cache.

    q: (B, H, Dk); k_pages/v_pages: (P, page_size, KV, Dk/Dv);
    block_table: (B, NB) int32 page ids per row; lengths: (B,) int32
    valid positions per row. Gathers each row's pages into a
    contiguous view and attends over the valid prefix; math in f32.
    Returns (B, H, Dv).
    """
    b, h, dk = q.shape
    page_size, kv = k_pages.shape[1], k_pages.shape[2]
    nb = block_table.shape[1]
    g = h // kv
    bt = block_table.long()
    k_cache = k_pages[bt].reshape(b, nb * page_size, kv, dk)
    v_cache = v_pages[bt].reshape(b, nb * page_size, kv, v_pages.shape[-1])
    # 1/sqrt(dk) rounded to f32 as the oracle computes it; a Python
    # scalar (not a device tensor) keeps the call free of host copies
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dk)))
    qr = q.reshape(b, kv, g, dk).float() * scale
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float())
    valid = (torch.arange(nb * page_size, device=q.device)[None]
             < lengths[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.reshape(b, h, v_cache.shape[-1]).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, Dk); k_pages/v_pages: (P, page_size, KV, Dk/Dv);
    block_table: (B, NB) int32; lengths: (B,) int32 -> (B, H, Dv).
    Positions at or past ``lengths[b]`` are masked and never read."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_table, lengths)
    name = "paged_decode_attention"
    code = build.dtype_code(q.dtype, name)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: q, k_pages and v_pages must share a "
                        "dtype")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and lengths must be int32")
    b, h, d = q.shape
    _, page_size, kv, dk = k_pages.shape
    dv = v_pages.shape[-1]
    if (dk != d or v_pages.shape[:-1] != k_pages.shape[:-1] or h % kv
            or block_table.shape[0] != b or lengths.shape != (b,)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(block_table.shape)}, lengths {tuple(lengths.shape)}")
    # any G: the kernel runs G-tiles of up to 8 query heads (4 above
    # head width 128)
    check_head_dims(name, dk, dv)
    dev = build.check_cuda(name, q=q, k_pages=k_pages, v_pages=v_pages,
                           block_table=block_table, lengths=lengths)
    out = q.new_empty((b, h, dv))
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = build.load().acar_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kv, dk, dv, page_size, block_table.shape[1], code,
            build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
