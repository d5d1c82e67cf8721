"""Paged chunked-prefill attention: the Hopper kernel and its plain
version.

``chunked_prefill_attention`` is the wrapper the model calls
(``models.attention.gqa_prefill_chunk_paged`` through
``kernels.ops``). On a CUDA tensor it launches the hand-written kernel
in ``csrc/chunked_prefill_attention.cu`` (it replaces the Pallas kernel
``repro/kernels/chunked_prefill_attention.py``) or raises; on a CPU
tensor it runs ``chunked_prefill_attention_plain``, the PyTorch port of
the reference oracle
``kernels/ref.py::chunked_prefill_attention_ref``.
``chunked_prefill_attention.launches`` counts kernel launches. In bf16
the kernel runs on the tensor cores (mma.sync: q.k and p.v in bf16 with
f32 sums, p rounded to bf16 for the second product); in f32 on the CUDA
cores.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build


def chunked_prefill_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor,
                                    block_table: torch.Tensor,
                                    q_positions: torch.Tensor, *,
                                    prompt_len: int) -> torch.Tensor:
    """Chunked-prefill GQA attention over a paged KV cache.

    q: (B, C, H, Dk) chunk queries at absolute positions
    ``q_positions`` (B, C) — rows may sit at different prefill
    depths; k_pages/v_pages: (P, page_size, KV, Dk/Dv); block_table:
    (B, NB) int32 page ids. The chunk's own K/V must already be
    written into the pages. Gathers each row's pages to the static
    ``prompt_len`` and attends causally (key position <= query
    position); math in f32. Returns (B, C, H, Dv).
    """
    b, c, h, dk = q.shape
    page_size, kv = k_pages.shape[1], k_pages.shape[2]
    nb = block_table.shape[1]
    g = h // kv
    bt = block_table.long()
    k_cache = k_pages[bt].reshape(b, nb * page_size, kv, dk)[:, :prompt_len]
    v_cache = v_pages[bt].reshape(
        b, nb * page_size, kv, v_pages.shape[-1])[:, :prompt_len]
    # 1/sqrt(dk) rounded to f32 as the oracle computes it; a Python
    # scalar (not a device tensor) keeps the call free of host copies
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dk)))
    qr = q.reshape(b, c, kv, g, dk).float() * scale
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr, k_cache.float())
    valid = (q_positions[:, :, None]
             >= torch.arange(prompt_len, device=q.device)[None, None])
    scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache.float())
    return out.reshape(b, c, h, v_cache.shape[-1]).to(q.dtype)


def chunked_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_table: torch.Tensor,
                              q_positions: torch.Tensor, *,
                              prompt_len: int) -> torch.Tensor:
    """q: (B, C, H, D); k_pages/v_pages: (P, page_size, KV, D);
    block_table: (B, NB) int32 covering ``prompt_len``; q_positions:
    (B, C) int32 absolute positions, all below ``prompt_len`` ->
    (B, C, H, D)."""
    if q.device.type == "cpu":
        return chunked_prefill_attention_plain(
            q, k_pages, v_pages, block_table, q_positions,
            prompt_len=prompt_len)
    name = "chunked_prefill_attention"
    code = build.dtype_code(q.dtype, name)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: q, k_pages and v_pages must share a "
                        "dtype")
    if (block_table.dtype != torch.int32
            or q_positions.dtype != torch.int32):
        raise TypeError(f"{name}: block_table and q_positions must be "
                        "int32")
    b, c, h, d = q.shape
    _, page_size, kv, dk = k_pages.shape
    nb = block_table.shape[1]
    if (dk != d or v_pages.shape != k_pages.shape or h % kv
            or block_table.shape[0] != b or q_positions.shape != (b, c)
            or not 0 < prompt_len <= nb * page_size):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(block_table.shape)}, q_positions "
            f"{tuple(q_positions.shape)}, prompt_len {prompt_len}")
    if d > 128:
        raise ValueError(f"{name}: the kernel takes head_dim <= 128")
    if q.dtype == torch.bfloat16 and d != 64:
        raise ValueError(f"{name}: the bf16 kernel takes head_dim 64, got "
                         f"{d}")
    dev = build.check_cuda(name, q=q, k_pages=k_pages, v_pages=v_pages,
                           block_table=block_table, q_positions=q_positions)
    out = torch.empty_like(q)
    if b == 0 or c == 0:
        return out
    with torch.cuda.device(dev):
        err = build.load().acar_chunked_prefill_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
            b, c, h, kv, d, page_size, nb, int(prompt_len), code,
            build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(chunked_prefill_attention)
    return out


chunked_prefill_attention.launches = 0
