"""What the dense and Mamba references share: the float32 set-up, the
e4m3 product of the control, the RMS norm and the head."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def float32_exact() -> None:
    """Products in full float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in f32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32; under ``"fp8"`` both operands
    are first rounded to e4m3, x per row and w per output column, as an
    fp8 GEMM with per-token and per-channel scales computes."""
    w = w.float()
    if precision == "fp8":
        return _e4m3(x.float(), -1) @ _e4m3(w, 0)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x.float() @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def head(m: dict, w: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Logits (S, V) of the final hidden states x (S, d)."""
    h = rms_norm(x, w["final_norm"]["scale"], m["norm_eps"])
    if m.get("tie_embeddings", False):
        return mm(h, w["embedding"].t(), precision)
    return mm(h, w["lm_head"], precision)


def layer(tree: dict, i: int) -> dict:
    """Layer i's leaves of a stacked layer tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
