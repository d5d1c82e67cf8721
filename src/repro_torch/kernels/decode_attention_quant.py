"""GQA decode attention over an int8-quantised contiguous KV cache: the
Hopper kernel and its plain version.

``decode_attention_quant`` is the wrapper the model calls
(``models.attention.gqa_decode`` on an int8 cache, through
``kernels.ops``). On a CUDA tensor it launches the hand-written kernel
in ``csrc/decode_attention_quant.cu`` (it replaces the Pallas kernel
``repro/kernels/decode_attention_quant.py``) or raises; on a CPU tensor
it runs ``decode_attention_quant_plain``, the PyTorch port of what the
reference runs off the TPU for this op (``repro/kernels/ops.py``):
``models/attention.py::decode_attention_quant`` over the linear
positions. ``decode_attention_quant.launches`` counts kernel launches:
one per call. The kernel runs the dense-cache decode's split-KV loop
(``csrc/decode_split.cuh``) over int8 codes, so ``split_ranges`` gives
the key range each CTA of a row's cluster takes here too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import _scale
from repro_torch.kernels.paged_decode_attention import (  # noqa: F401
    check_head_dims, split_ranges)  # the int8 kernel splits alike

# the masking constant of the reference's jnp quant path
_NEG_INF = -1e30


def decode_attention_quant_plain(q: torch.Tensor, k_codes: torch.Tensor,
                                 k_scale: torch.Tensor,
                                 v_codes: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 length: int) -> torch.Tensor:
    """Single-token GQA decode attention over an int8 cache.

    q: (B, H, Dk); k_codes/v_codes: (B, S, KV, D) int8; k_scale/v_scale:
    (B, S, KV) f32; length: valid cache prefix (one for the whole
    batch). Scales fold into the math, never into a dequantised cache:
        scores_s = (q . k_codes_s) * k_scale_s
        out      = sum_s (p_s * v_scale_s) * v_codes_s
    Positions at or past ``length`` are masked to -1e30 before the
    softmax. Math in f32; returns (B, H, Dv) in q's dtype.
    """
    b, h, dk = q.shape
    s, kv = k_codes.shape[1], k_codes.shape[2]
    g = h // kv
    qr = q.reshape(b, kv, g, dk).float() * _scale(dk)
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k_codes.float())
    scores = scores * k_scale.transpose(1, 2)[:, :, None, :]
    valid = torch.arange(s, device=q.device) < length
    scores = scores.masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    pv = probs * v_scale.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", pv, v_codes.float())
    return out.reshape(b, h, v_codes.shape[-1]).to(q.dtype)


def decode_attention_quant(q: torch.Tensor, k_codes: torch.Tensor,
                           k_scale: torch.Tensor, v_codes: torch.Tensor,
                           v_scale: torch.Tensor,
                           length: int) -> torch.Tensor:
    """q: (B, H, Dk) f32 or bf16; k_codes/v_codes: (B, S, KV, Dk/Dv)
    int8; k_scale/v_scale: (B, S, KV) f32; length: valid cache prefix, a
    Python int passed as a launch argument -> (B, H, Dv) in q's dtype.
    The kernel dispatches on q's dtype alone."""
    length = int(length)
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, k_codes, k_scale, v_codes,
                                            v_scale, length)
    name = "decode_attention_quant"
    code = build.dtype_code(q.dtype, name)
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise TypeError(f"{name}: k_codes and v_codes must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: k_scale and v_scale must be float32")
    b, h, d = q.shape
    _, s, kv, dk = k_codes.shape
    dv = v_codes.shape[-1]
    if (dk != d or v_codes.shape[:-1] != k_codes.shape[:-1] or h % kv
            or k_codes.shape[0] != b or k_scale.shape != (b, s, kv)
            or v_scale.shape != (b, s, kv) or not 0 <= length <= s):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, codes "
            f"{tuple(k_codes.shape)}/{tuple(v_codes.shape)}, scales "
            f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}, length "
            f"{length}")
    # any G: the kernel runs G-tiles, as the paged decode's
    check_head_dims(name, dk, dv)
    dev = build.check_cuda(name, q=q, k_codes=k_codes, k_scale=k_scale,
                           v_codes=v_codes, v_scale=v_scale)
    out = q.new_empty((b, h, dv))
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = build.load().acar_decode_attention_quant(
            q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
            v_codes.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
            b, h, kv, dk, dv, s, length, code, build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(decode_attention_quant)
    return out


decode_attention_quant.launches = 0
