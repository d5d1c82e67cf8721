"""RG-LRU linear recurrence h_t = a_t h_{t-1} + u_t: the Hopper kernels
(forward and backward) and their plain versions.

``rglru_scan`` is the wrapper the model calls (``models.rglru.
rglru_block``, through ``kernels.ops``). It is a differentiable
``torch.autograd.Function``: on CUDA tensors its forward launches the
hand-written kernel in ``csrc/rglru_scan.cu`` (it replaces the Pallas
kernel ``repro/kernels/rglru_scan.py``) and its backward launches that
file's backward kernel (``rglru_scan_bwd``), or they raise; on CPU
tensors they run ``rglru_scan_plain``, the PyTorch port of the reference
oracle ``kernels/ref.py::rglru_scan_ref``, and ``rglru_scan_bwd_plain``,
the explicit reverse recurrence. ``rglru_scan.launches`` and
``rglru_scan_bwd.launches`` count kernel launches.

Both kernels round every operation on their own, in the plain versions'
order, so hs, h_final, da and du all agree with them bit for bit.
``rglru_plan`` gives the kernels' tile constants: a CTA walks
``channels`` channels of one batch row along S in tiles of ``steps``
steps, taking only the steps inside S.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build


@dataclass(frozen=True)
class RGLRUPlan:
    """The kernels' tile constants for W channels that a Python caller
    reads (the CPU emulation of their order of work). ``csrc/
    rglru_scan.cu`` owns them (``kDc``, ``kT``), with the ring depths,
    thread count and shared memory besides; its query
    ``acar_rglru_scan_plan`` reports each field."""
    channels: int     # channels a CTA, one walking lane each
    steps: int        # steps a tile
    blocks: int       # channel blocks: CTAs along W


def rglru_plan(w: int) -> RGLRUPlan:
    """The tile constants of ``csrc/rglru_scan.cu`` for W channels: fixed
    but for the block count, and never functions of B or S."""
    dc = 32
    return RGLRUPlan(channels=dc, steps=64, blocks=-(-w // dc))


def rglru_scan_plain(a: torch.Tensor, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential linear recurrence h_t = a_t * h_{t-1} + u_t, h_{-1} = 0.

    a, u: (B, S, W). Returns (hs (B, S, W) f32, h_final (B, W) f32).
    """
    af, uf = a.float(), u.float()
    hs = torch.empty_like(af)
    h = torch.zeros_like(af[:, 0])
    for t in range(a.shape[1]):
        h = af[:, t] * h + uf[:, t]
        hs[:, t] = h
    return hs, h


def rglru_scan_bwd_plain(a: torch.Tensor, u: torch.Tensor,
                         hs: torch.Tensor, dhs: torch.Tensor,
                         dh_final: Optional[torch.Tensor] = None):
    """The gradients of ``rglru_scan_plain`` by the reverse recurrence
    g_t = dhs_t + a_{t+1} g_{t+1} (h_final's gradient entering at
    t = S-1): du_t = g_t, da_t = g_t h_{t-1}. Returns (da, du) in a's
    and u's dtypes."""
    af, dhsf = a.float(), dhs.float()
    da, du = torch.empty_like(af), torch.empty_like(af)
    carry = (torch.zeros_like(af[:, 0]) if dh_final is None
             else dh_final.float())
    for t in range(a.shape[1] - 1, -1, -1):
        g = dhsf[:, t] + carry
        du[:, t] = g
        da[:, t] = g * hs[:, t - 1] if t > 0 else 0.0
        carry = af[:, t] * g
    return da.to(a.dtype), du.to(u.dtype)


def _bf16_flags(name: str, a, u):
    return (build.dtype_code(a.dtype, name), build.dtype_code(u.dtype, name))


def _check_shapes(name: str, a, u) -> None:
    if a.shape != u.shape or a.dim() != 3:
        raise ValueError(f"{name}: shapes a {tuple(a.shape)}, u "
                         f"{tuple(u.shape)}")


def _launch_fwd(a, u):
    name = "rglru_scan"
    dev = build.check_cuda(name, a=a, u=u)
    _check_shapes(name, a, u)
    bsz, s, w = a.shape
    flags = _bf16_flags(name, a, u)
    hs = torch.empty((bsz, s, w), dtype=torch.float32, device=dev)
    h_final = torch.empty((bsz, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.load().acar_rglru_scan_fwd(
            a.data_ptr(), u.data_ptr(), hs.data_ptr(), h_final.data_ptr(),
            bsz, s, w, *flags, build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(rglru_scan)
    return hs, h_final


def rglru_scan_bwd(a: torch.Tensor, u: torch.Tensor, hs: torch.Tensor,
                   dhs: torch.Tensor,
                   dh_final: Optional[torch.Tensor] = None):
    """The backward kernel: (da, du) from a, the saved hs (f32), hs's
    gradient and h_final's (or None)."""
    name = "rglru_scan_bwd"
    dhs = dhs.float().contiguous()
    if dh_final is not None:
        dh_final = dh_final.float().contiguous()
    dev = build.check_cuda(
        name, a=a, u=u, hs=hs, dhs=dhs,
        **({} if dh_final is None else {"dh_final": dh_final}))
    _check_shapes(name, a, u)
    bsz, s, w = a.shape
    if (hs.shape != a.shape or hs.dtype != torch.float32
            or dhs.shape != a.shape
            or (dh_final is not None and dh_final.shape != (bsz, w))):
        raise ValueError(
            f"{name}: a {tuple(a.shape)}, hs {tuple(hs.shape)} {hs.dtype}, "
            f"dhs {tuple(dhs.shape)}, dh_final "
            f"{None if dh_final is None else tuple(dh_final.shape)}")
    flags = _bf16_flags(name, a, u)
    da, du = torch.empty_like(a), torch.empty_like(u)
    with torch.cuda.device(dev):
        err = build.load().acar_rglru_scan_bwd(
            a.data_ptr(), hs.data_ptr(), dhs.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            da.data_ptr(), du.data_ptr(), bsz, s, w, *flags,
            build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(rglru_scan_bwd)
    return da, du


class _RGLRUScan(torch.autograd.Function):
    """Kernels on CUDA tensors, plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, a, u):
        ctx.set_materialize_grads(False)
        if a.device.type == "cpu":
            hs, h_final = rglru_scan_plain(a, u)
        else:
            hs, h_final = _launch_fwd(a, u)
        ctx.save_for_backward(a, u, hs)
        return hs, h_final

    @staticmethod
    def backward(ctx, dhs, dh_final):
        a, u, hs = ctx.saved_tensors
        if dhs is None:
            dhs = torch.zeros_like(hs)
        if a.device.type == "cpu":
            return rglru_scan_bwd_plain(a, u, hs, dhs, dh_final)
        return rglru_scan_bwd(a, u, hs, dhs, dh_final)


def rglru_scan(a: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, u: (B, S, W), float32 or bfloat16 (contiguous on a CUDA
    device). Returns (hs (B, S, W) f32, h_final (B, W) f32),
    differentiable in a and u."""
    return _RGLRUScan.apply(a, u)


rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
