"""GQA decode attention over a contiguous KV cache: the Hopper kernel and
its plain version.

``decode_attention`` is the wrapper the model calls
(``models.attention.gqa_decode`` on a dense cache, through
``kernels.ops``). On a CUDA tensor it launches the hand-written kernel
in ``csrc/decode_attention.cu`` (it replaces the Pallas kernel
``repro/kernels/decode_attention.py``) or raises; on a CPU tensor it
runs ``decode_attention_plain``, the PyTorch port of the reference
oracle ``kernels/ref.py::decode_attention_ref``.
``decode_attention.launches`` counts kernel launches: one per call.
``split_ranges`` (shared with the paged decode, whose kernel runs the
same split-KV loop) gives the key range each CTA of a row's cluster
takes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode_attention import (  # noqa: F401
    check_head_dims, split_ranges)  # the dense-cache kernel splits alike


def _scale(dk: int) -> float:
    """1/sqrt(dk) rounded to f32 as the oracles compute it; a Python
    scalar (not a device tensor) keeps the call free of host copies."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dk)))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           length: int) -> torch.Tensor:
    """Single-token GQA decode attention over a padded KV cache.

    q: (B, H, Dk); k_cache/v_cache: (B, S, KV, Dk/Dv); length: number
    of valid cache positions (one for the whole batch). Returns
    (B, H, Dv), computed in f32.
    """
    b, h, dk = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qr = q.reshape(b, kv, g, dk).float() * _scale(dk)
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float())
    valid = torch.arange(s, device=q.device) < length
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.reshape(b, h, v_cache.shape[-1]).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int) -> torch.Tensor:
    """q: (B, H, Dk); k_cache/v_cache: (B, S, KV, Dk/Dv) in q's dtype;
    length: valid cache prefix, a Python int (0 <= length <= S) passed
    to the kernel as a launch argument -> (B, H, Dv). Positions at or
    past ``length`` are never read."""
    length = int(length)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length)
    name = "decode_attention"
    code = build.dtype_code(q.dtype, name)
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"{name}: q, k_cache and v_cache must share a "
                        "dtype")
    b, h, d = q.shape
    _, s, kv, dk = k_cache.shape
    dv = v_cache.shape[-1]
    if (dk != d or v_cache.shape[:-1] != k_cache.shape[:-1] or h % kv
            or k_cache.shape[0] != b or not 0 <= length <= s):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, length "
            f"{length}")
    # any G: the kernel runs G-tiles, as the paged decode's
    check_head_dims(name, dk, dv)
    dev = build.check_cuda(name, q=q, k_cache=k_cache, v_cache=v_cache)
    out = q.new_empty((b, h, dv))
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = build.load().acar_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), b, h, kv, dk, dv, s, length, code,
            build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(decode_attention)
    return out


decode_attention.launches = 0
