"""Mamba-1 selective scan: the Hopper kernels (forward and backward) and
their plain versions.

``selective_scan`` is the wrapper the model calls (``models.ssm.
mamba_block``, through ``kernels.ops``). It is a differentiable
``torch.autograd.Function``: on CUDA tensors its forward launches the
hand-written kernel in ``csrc/selective_scan.cu`` (it replaces the Pallas
kernel ``repro/kernels/selective_scan.py``) and its backward launches
that file's backward kernel (``selective_scan_bwd``), or they raise; on
CPU tensors they run ``selective_scan_plain``, the PyTorch port of the
reference oracle ``kernels/ref.py::selective_scan_ref``, and
``selective_scan_bwd_plain``, the explicit reverse recurrence.
``selective_scan.launches`` and ``selective_scan_bwd.launches`` count
kernel launches.

Both versions round each step as h = exp(dt a) h + (dt x) b, every
operation on its own, so their states agree bit for bit; y sums over
the state axis in another order (in the thread, then a shuffle
butterfly in the kernel). ``scan_plan`` gives the kernels' tile
constants, which depend on the state size alone, and the scratch the
wrappers allocate follows it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

@dataclass(frozen=True)
class ScanPlan:
    """The kernels' tile constants for (D, N) that a Python caller reads:
    the scratch sizes and the CPU emulation of the kernels' order of work.
    ``csrc/selective_scan.cu``'s ``Plan<N>`` owns them, with the thread
    count, ring depth and shared memory besides; its query
    ``acar_selective_scan_plan`` reports each field."""
    channels: int     # channels a CTA (Dc)
    steps: int        # steps a tile (T)
    chunk: int        # checkpoint interval (K), the backward's window
    per_thread: int   # states a thread holds (k)
    lanes: int        # lanes of one channel (N / k)
    blocks: int       # channel blocks: CTAs along D


def scan_plan(d: int, n: int) -> ScanPlan:
    """The tile constants of ``csrc/selective_scan.cu``'s ``Plan<N>``
    for D channels and state size N (a power of two <= 32): functions
    of D and N alone, never of B or S."""
    if n < 1 or n > 32 or n & (n - 1):
        raise ValueError(f"selective_scan: the kernel takes a state size "
                         f"that is a power of two <= 32, got {n}")
    k = min(n, 4)
    dc = 32 if n == 32 else 64
    return ScanPlan(channels=dc, steps=16, chunk=16, per_thread=k,
                    lanes=n // k, blocks=-(-d // dc))


def scratch_shapes(bsz: int, s: int, d: int, n: int
                   ) -> Dict[str, Tuple[int, ...]]:
    """The f32 scratch of one call, by ``scan_plan(d, n)``: the
    forward's checkpoints (the state before every ``chunk``-th step,
    kept for the backward), the backward's per-row d a_log sums and its
    per-channel-block dB / dC partials."""
    p = scan_plan(d, n)
    return {"ckpt": (bsz, -(-s // p.chunk), d, n),
            "da_part": (bsz, d, n),
            "db_part": (bsz, s, p.blocks, n),
            "dc_part": (bsz, s, p.blocks, n)}


def scratch(names, bsz: int, s: int, d: int, n: int,
            device) -> Tuple[torch.Tensor, ...]:
    """Uninitialised f32 scratch tensors ``names`` of
    ``scratch_shapes``."""
    shapes = scratch_shapes(bsz, s, d, n)
    return tuple(torch.empty(shapes[k], dtype=torch.float32, device=device)
                 for k in names)


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor,
                         a_log: torch.Tensor, b_in: torch.Tensor,
                         c_in: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential Mamba-1 selective scan.

    x, dt: (B, S, D); a_log: (D, N); b_in, c_in: (B, S, N).
    Returns (y (B, S, D) in x's dtype, h_final (B, D, N) f32); math in
    f32.
    """
    hs, y = _states(x, dt, a_log, b_in, c_in, with_y=True)
    return y.to(x.dtype), hs[-1]


def _states(x, dt, a_log, b_in, c_in, with_y: bool):
    """Every state h_t (a list of S tensors (B, D, N) f32) and, with
    ``with_y``, y (B, S, D) f32."""
    bsz, s, d = x.shape
    a = -torch.exp(a_log.float())
    xf, dtf = x.float(), dt.float()
    bf, cf = b_in.float(), c_in.float()
    h = torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32,
                    device=x.device)
    hs, ys = [], []
    for t in range(s):
        dta = torch.exp(dtf[:, t, :, None] * a)             # (B, D, N)
        u = (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        h = dta * h + u
        hs.append(h)
        if with_y:
            ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return hs, (torch.stack(ys, 1) if with_y else None)


def selective_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor,
                             a_log: torch.Tensor, b_in: torch.Tensor,
                             c_in: torch.Tensor, dy: torch.Tensor,
                             dh_final: Optional[torch.Tensor] = None):
    """The gradients of ``selective_scan_plain`` by the explicit reverse
    recurrence g_t = dy_t C_t + exp(dt_{t+1} A) g_{t+1}, with h_final's
    gradient entering at t = S-1. Returns (dx, ddt, da_log, db_in,
    dc_in), each in its input's dtype; math in f32."""
    s = x.shape[1]
    a = -torch.exp(a_log.float())
    xf, dtf, dyf = x.float(), dt.float(), dy.float()
    bf, cf = b_in.float(), c_in.float()
    hs, _ = _states(x, dt, a_log, b_in, c_in, with_y=False)
    carry = (torch.zeros_like(hs[0]) if dh_final is None
             else dh_final.float())
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(a)
    for t in range(s - 1, -1, -1):
        dta = torch.exp(dtf[:, t, :, None] * a)
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(hs[0])
        g = dyf[:, t, :, None] * cf[:, t, None, :] + carry  # (B, D, N)
        dc[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], hs[t])
        db[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
        dx[:, t] = torch.einsum("bdn,bn->bd", g, bf[:, t]) * dtf[:, t]
        ddt[:, t] = (g * (xf[:, t, :, None] * bf[:, t, None, :]
                          + h_prev * dta * a)).sum(-1)
        da += (g * h_prev * dta * dtf[:, t, :, None]).sum(0)
        carry = dta * g
    return (dx.to(x.dtype), ddt.to(dt.dtype), (da * a).to(a_log.dtype),
            db.to(b_in.dtype), dc.to(c_in.dtype))


def _codes(name: str, tensors) -> int:
    """One bit per operand, in csrc's Operand order, set where it is
    bf16."""
    codes = 0
    for bit, t in enumerate(tensors):
        codes |= build.dtype_code(t.dtype, name) << bit
    return codes


def _check(name: str, x, dt, a_log, b_in, c_in) -> torch.device:
    dev = build.check_cuda(name, x=x, dt=dt, a_log=a_log, b_in=b_in,
                           c_in=c_in)
    bsz, s, d = x.shape
    n = a_log.shape[1]
    if (dt.shape != x.shape or a_log.shape != (d, n)
            or b_in.shape != (bsz, s, n) or c_in.shape != (bsz, s, n)):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a_log {tuple(a_log.shape)}, b_in {tuple(b_in.shape)}, "
            f"c_in {tuple(c_in.shape)}")
    scan_plan(d, n)         # raises on a state size it does not take
    return dev


def _launch_fwd(x, dt, a_log, b_in, c_in):
    """The forward kernel: (y, h_final, checkpoints)."""
    name = "selective_scan"
    dev = _check(name, x, dt, a_log, b_in, c_in)
    codes = _codes(name, (x, dt, a_log, b_in, c_in))
    bsz, s, d = x.shape
    n = a_log.shape[1]
    lib = build.load()
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    ckpt, = scratch(("ckpt",), bsz, s, d, n, dev)
    with torch.cuda.device(dev):
        err = lib.acar_selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
            b_in.data_ptr(), c_in.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), ckpt.data_ptr(), bsz, s, d, n, codes,
            build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(selective_scan)
    return y, h_final, ckpt


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b_in: torch.Tensor,
                       c_in: torch.Tensor, ckpt: torch.Tensor,
                       dy: torch.Tensor,
                       dh_final: Optional[torch.Tensor] = None):
    """The backward kernel: (dx, ddt, da_log, db_in, dc_in) from the
    forward's inputs and checkpoints, y's gradient (in x's dtype) and
    h_final's (f32, or None)."""
    name = "selective_scan_bwd"
    dev = _check(name, x, dt, a_log, b_in, c_in)
    codes = _codes(name, (x, dt, a_log, b_in, c_in))
    bsz, s, d = x.shape
    n = a_log.shape[1]
    dy = dy.to(x.dtype).contiguous()
    if dh_final is not None:
        dh_final = dh_final.float().contiguous()
    build.check_cuda(name, ckpt=ckpt, dy=dy,
                     **({} if dh_final is None else {"dh_final": dh_final}))
    want = scratch_shapes(bsz, s, d, n)["ckpt"]
    if tuple(ckpt.shape) != want or ckpt.dtype != torch.float32:
        raise ValueError(f"{name}: ckpt {tuple(ckpt.shape)} {ckpt.dtype}, "
                         f"the forward's checkpoints are {want} f32")
    lib = build.load()
    dx, ddt, da_log = (torch.empty_like(t) for t in (x, dt, a_log))
    db, dc = torch.empty_like(b_in), torch.empty_like(c_in)
    da_part, db_part, dc_part = scratch(("da_part", "db_part", "dc_part"),
                                        bsz, s, d, n, dev)
    with torch.cuda.device(dev):
        err = lib.acar_selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
            b_in.data_ptr(), c_in.data_ptr(), ckpt.data_ptr(),
            dy.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da_log.data_ptr(),
            db.data_ptr(), dc.data_ptr(), da_part.data_ptr(),
            db_part.data_ptr(), dc_part.data_ptr(), bsz, s, d, n, codes,
            build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(selective_scan_bwd)
    return dx, ddt, da_log, db, dc


class _SelectiveScan(torch.autograd.Function):
    """Kernels on CUDA tensors, plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_in, c_in):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            y, h_final = selective_scan_plain(x, dt, a_log, b_in, c_in)
            ckpt = None
        else:
            y, h_final, ckpt = _launch_fwd(x, dt, a_log, b_in, c_in)
        ctx.save_for_backward(x, dt, a_log, b_in, c_in, ckpt)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, a_log, b_in, c_in, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if ckpt is None:
            return selective_scan_bwd_plain(x, dt, a_log, b_in, c_in, dy,
                                            dh_final)
        return selective_scan_bwd(x, dt, a_log, b_in, c_in, ckpt, dy,
                                  dh_final)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b_in: torch.Tensor, c_in: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (B, S, D); a_log: (D, N); b_in, c_in: (B, S, N), each
    float32 or bfloat16 on its own (contiguous on a CUDA device).

    Returns (y (B, S, D) in x's dtype, h_final (B, D, N) f32),
    differentiable in every input."""
    return _SelectiveScan.apply(x, dt, a_log, b_in, c_in)


selective_scan.launches = 0
selective_scan_bwd.launches = 0
