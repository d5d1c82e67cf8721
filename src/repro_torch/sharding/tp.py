"""Bit-exact tensor parallelism for the serving mesh's "model" axis.

The port of ``repro/sharding/tp.py``. The sharded serving programs must
stay *bit-identical* to single-device execution, which rules out the
textbook row-parallel scheme: a sum over a sharded contraction reorders
the float reduction. Instead every matmul whose *output* axis is
sharded (wq -> heads, wk/wv -> kv_heads, w_gate/w_up -> ff / expert_ff,
lm_head -> vocab) runs column-parallel, and before any contraction
*over* a sharded axis the activation is all-gathered back to full
length — pure concatenation in column order, matching the contiguous
column slices of the weight, so every contraction sees the exact
full-length operands the single-device program does. Contracted-input
weights (wo, w_down, router, shared experts, norms, embeddings) stay
replicated.

The mesh is one controller in one process (``serving/mesh.py``): each
cell of a ``(data, model)`` grid runs its program on a worker thread of
its own, and this module's thread-local context names the cell's
column group — the ``m`` workers of its data row — and its column.
``tp_all_gather`` deposits the cell's slice, waits at the group's
barrier for the row's ``m`` columns, and returns the concatenation of
their slices on the cell's device, in column order, along the last
axis. A failure in any cell aborts the barrier, so every other column
raises instead of waiting. Outside a ``tp_context`` it returns its
input unchanged, so the single-device and 1-D ("data",) paths run the
single-device program bit for bit.

Every product against a ``_COL_PARALLEL`` leaf goes through
``models.layers.project`` (the prefill MLP's through kernel 3's stages),
on one device as on the mesh. On the CPU that is ``torch.matmul``, whose
product over a column slice gives the unsliced product's columns. On a
CUDA device it is the column-invariant projection kernel
(``kernels/projection.py``): cuBLAS picks its kernel by shape, so its
bf16 product over a column slice can round apart from the unsliced
one, while the kernel sums every output element in one order that
depends on neither N nor the columns beside it. Kernel 3's stages keep
their bits across column widths the same way. So on either device a
model column's program computes the single-device program's bits.

Not column-parallel in either package: the capacity MoE
(``models.moe.moe_ffn``) contracts its experts' column-split hidden
with the replicated ``w_down`` without gathering it first, so it cannot
run model-sharded; the gather and per-token MoE gather before
``w_down``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

# Weights sharded over "model" on their LAST (output) axis; everything
# else is replicated. Keyed on the leaf name in the param tree —
# logical axis names can't express the column/row distinction (wq and
# wo both carry "heads").
_COL_PARALLEL = frozenset({"wq", "wk", "wv", "w_gate", "w_up",
                           "lm_head"})


class TpGatherAborted(RuntimeError):
    """A column of the group failed, so the gather cannot complete."""


class ColumnGroup:
    """The rendezvous of one data row's ``m`` model columns: two sets of
    slots, a slot per column in each, and a barrier. Gathers alternate
    between the two sets, so each passes the barrier once: a column can
    deposit into a set again only after the next gather's barrier,
    which every column reaches only once it has read the set."""

    def __init__(self, m: int, timeout: Optional[float] = None):
        self.m = int(m)
        self.slots: List[List[Optional[torch.Tensor]]] = [
            [None] * self.m, [None] * self.m]
        self._parity = [0] * self.m
        self._barrier = threading.Barrier(self.m, timeout=timeout)

    def _wait(self) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise TpGatherAborted(
                "tp_all_gather: another column of this data row failed "
                "or timed out") from None

    def gather(self, col: int, x: torch.Tensor) -> torch.Tensor:
        slots = self.slots[self._parity[col]]
        self._parity[col] ^= 1
        slots[col] = x
        self._wait()
        parts = [t if t.device == x.device else t.to(x.device)
                 for t in slots]
        return torch.cat(parts, dim=x.ndim - 1)

    def abort(self) -> None:
        """Break the barrier: every column waiting, or arriving later,
        raises ``TpGatherAborted``."""
        self._barrier.abort()



class _Tp(threading.local):
    def __init__(self):
        self.axis: Optional[str] = None
        self.size: int = 1
        self.group: Optional[ColumnGroup] = None
        self.col: int = 0


_CTX = _Tp()


@contextlib.contextmanager
def tp_context(axis: str, size: int,
               group: Optional[ColumnGroup] = None, col: int = 0):
    """Activate tensor parallelism for model code run inside, on this
    thread: ``size`` columns over mesh axis ``axis``; this thread is
    column ``col`` of ``group``."""
    prev = (_CTX.axis, _CTX.size, _CTX.group, _CTX.col)
    _CTX.axis, _CTX.size = axis, int(size)
    _CTX.group, _CTX.col = group, int(col)
    try:
        yield
    finally:
        _CTX.axis, _CTX.size, _CTX.group, _CTX.col = prev


def tp_active() -> bool:
    return _CTX.axis is not None


def tp_size() -> int:
    return _CTX.size if _CTX.axis is not None else 1


def tp_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Gather a model-sharded last axis back to full length (no-op
    outside a tp context). The slices concatenate in column order —
    exactly the column order of the sharded weight that produced them
    — so the result is bit-identical to the unsharded activation."""
    if _CTX.axis is None or _CTX.size == 1:
        return x
    if _CTX.group is None:
        raise RuntimeError(
            "tp_all_gather: a tp context of size > 1 needs its column "
            "group (run it through ServingMesh.run)")
    return _CTX.group.gather(_CTX.col, x)


def tp_local_cfg(cfg, m: int):
    """Config whose head counts describe one model shard's param
    slice, for the reshapes inside attention. Head dim is pinned so
    halving num_heads cannot silently change ``resolved_head_dim``."""
    if m <= 1:
        return cfg
    if cfg.num_heads % m or cfg.num_kv_heads % m:
        raise ValueError(
            f"config {cfg.name!r}: num_heads={cfg.num_heads} / "
            f"num_kv_heads={cfg.num_kv_heads} not divisible by "
            f"model={m}")
    return cfg.replace(num_heads=cfg.num_heads // m,
                       num_kv_heads=cfg.num_kv_heads // m,
                       head_dim=cfg.resolved_head_dim)


def tp_param_specs(params, axis: str = "model"):
    """Per-leaf spec tree for the bit-exact column-parallel layout, in
    the shape of a ``PartitionSpec``: a tuple naming the mesh axis of
    each tensor axis. ``_COL_PARALLEL`` leaves split their last axis
    over ``axis`` (leading axes — including a stacked "layers" axis —
    stay whole); every other leaf is replicated (``()``)."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        if name in _COL_PARALLEL:
            return (None,) * (tree.ndim - 1) + (axis,)
        return ()

    return walk(params, None)


def tp_check_cfg(cfg, m: int) -> None:
    """Raise early (at placement, not mid-run) when a config cannot run
    bit-exact column-parallel at model=m."""
    if m <= 1:
        return
    tp_local_cfg(cfg, m)  # head divisibility
    if cfg.d_ff % m:
        raise ValueError(
            f"config {cfg.name!r}: d_ff={cfg.d_ff} not divisible by "
            f"model={m}")
    if cfg.moe is not None and cfg.moe.d_ff_expert % m:
        raise ValueError(
            f"config {cfg.name!r}: d_ff_expert={cfg.moe.d_ff_expert} "
            f"not divisible by model={m}")
    if not cfg.tie_embeddings and cfg.vocab_size % m:
        raise ValueError(
            f"config {cfg.name!r}: untied vocab_size={cfg.vocab_size} "
            f"not divisible by model={m}")
