"""Paged GQA decode attention over int8-quantised KV pages: the Hopper
kernel and its plain version.

``paged_decode_attention_quant`` is the wrapper the model calls
(``models.attention.gqa_decode_quant_paged`` through ``kernels.ops``).
On a CUDA tensor it launches the hand-written kernel in
``csrc/paged_decode_attention_quant.cu`` (it replaces the Pallas kernel
``repro/kernels/paged_decode_attention_quant.py``) or raises; on a CPU
tensor it runs ``paged_decode_attention_quant_plain``, the PyTorch port
of the reference oracle
``kernels/ref.py::paged_decode_attention_quant_ref``.
``paged_decode_attention_quant.launches`` counts kernel launches: one
per call. The kernel runs the paged decode's split-KV loop
(``csrc/decode_split.cuh``) over int8 codes, so ``split_ranges`` gives
the key range each CTA of a row's cluster takes here too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import _scale
from repro_torch.kernels.paged_decode_attention import (  # noqa: F401
    check_head_dims, split_ranges)  # the int8 kernel splits alike


def paged_decode_attention_quant_plain(q: torch.Tensor,
                                       k_pages: torch.Tensor,
                                       k_scale_pages: torch.Tensor,
                                       v_pages: torch.Tensor,
                                       v_scale_pages: torch.Tensor,
                                       block_table: torch.Tensor,
                                       lengths: torch.Tensor
                                       ) -> torch.Tensor:
    """Single-token GQA decode over int8-quantised paged KV.

    q: (B, H, Dk); k_pages/v_pages: (P, page_size, KV, Dk/Dv) int8
    codes; k_scale_pages/v_scale_pages: (P, page_size, KV) f32
    per-vector scales; block_table: (B, NB) int32 page ids; lengths:
    (B,) int32 valid positions per row. Scales fold into the attention
    math as in ``models.attention.decode_attention_quant``:
        scores_s = (q . k_codes_s) * k_scale_s
        out      = sum_s (p_s * v_scale_s) * v_codes_s
    Math in f32; returns (B, H, Dv).
    """
    b, h, dk = q.shape
    page_size, kv = k_pages.shape[1], k_pages.shape[2]
    nb = block_table.shape[1]
    g = h // kv
    bt = block_table.long()
    k_cache = k_pages[bt].reshape(b, nb * page_size, kv, dk)
    v_cache = v_pages[bt].reshape(b, nb * page_size, kv, v_pages.shape[-1])
    k_scale = k_scale_pages[bt].reshape(b, nb * page_size, kv)
    v_scale = v_scale_pages[bt].reshape(b, nb * page_size, kv)
    qr = q.reshape(b, kv, g, dk).float() * _scale(dk)
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float())
    scores = scores * k_scale.transpose(1, 2)[:, :, None, :]
    valid = (torch.arange(nb * page_size, device=q.device)[None]
             < lengths[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    pv = probs * v_scale.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", pv, v_cache.float())
    return out.reshape(b, h, v_cache.shape[-1]).to(q.dtype)


def paged_decode_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                 k_scale_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 v_scale_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, Dk) f32 or bf16; k_pages/v_pages: (P, page_size, KV,
    Dk/Dv) int8; k_scale_pages/v_scale_pages: (P, page_size, KV) f32;
    block_table: (B, NB) int32; lengths: (B,) int32 -> (B, H, Dv) in q's
    dtype. Positions at or past ``lengths[b]`` are masked and never
    read; the kernel dispatches on q's dtype alone."""
    if q.device.type == "cpu":
        return paged_decode_attention_quant_plain(
            q, k_pages, k_scale_pages, v_pages, v_scale_pages,
            block_table, lengths)
    name = "paged_decode_attention_quant"
    code = build.dtype_code(q.dtype, name)
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"{name}: k_pages and v_pages must be int8")
    if (k_scale_pages.dtype != torch.float32
            or v_scale_pages.dtype != torch.float32):
        raise TypeError(f"{name}: scale pages must be float32")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and lengths must be int32")
    b, h, d = q.shape
    n_pages, page_size, kv, dk = k_pages.shape
    dv = v_pages.shape[-1]
    if (dk != d or v_pages.shape[:-1] != k_pages.shape[:-1] or h % kv
            or k_scale_pages.shape != (n_pages, page_size, kv)
            or v_scale_pages.shape != k_scale_pages.shape
            or block_table.shape[0] != b or lengths.shape != (b,)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, scales "
            f"{tuple(k_scale_pages.shape)}/{tuple(v_scale_pages.shape)}, "
            f"table {tuple(block_table.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    # any G: the kernel runs G-tiles, as the paged decode's
    check_head_dims(name, dk, dv)
    dev = build.check_cuda(name, q=q, k_pages=k_pages,
                           k_scale_pages=k_scale_pages, v_pages=v_pages,
                           v_scale_pages=v_scale_pages,
                           block_table=block_table, lengths=lengths)
    out = q.new_empty((b, h, dv))
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = build.load().acar_paged_decode_attention_quant(
            q.data_ptr(), k_pages.data_ptr(), k_scale_pages.data_ptr(),
            v_pages.data_ptr(), v_scale_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kv, dk, dv, page_size, block_table.shape[1], code,
            build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(paged_decode_attention_quant)
    return out


paged_decode_attention_quant.launches = 0
