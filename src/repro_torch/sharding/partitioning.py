"""Logical-axis partitioning rules.

The port of ``repro/sharding/partitioning.py``. Model code in the
reference annotates activations with *logical* axis names
(``shard(x, "batch", "seq", "heads", None)``), and at launch a rule
set maps logical names to mesh axes. The rule tables and ``resolve``
are ported as they are; ``resolve`` returns a tuple of mesh-axis names
(the reference's ``PartitionSpec`` is such a tuple).

``axis_rules``, ``shard`` and ``named_sharding`` are XLA placement
hints with no torch meaning: the port's mesh places tensors explicitly
(``serving/mesh.py``). They keep the reference's behaviour outside a
rules context — ``shard`` returns its input, ``named_sharding``
returns None — and inside one ``shard`` checks the annotation's rank
and still returns its input, while ``named_sharding`` returns the
resolved spec. A mesh here is any object with ``axis_names`` and a
``shape`` mapping (``launch.mesh.DeviceMesh``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple, Union

import torch

Axis = Union[str, None, Tuple[str, ...]]

# Default rules for the ("data", "model") production mesh. "pod" (multi-pod)
# extends the data axis: batch shards over ("pod", "data").
SINGLE_POD_RULES = {
    "batch": "data",
    "seq": None,
    "seq_kv": "model",     # MQA decode: shard KV cache along sequence
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": None,       # "tp" MoE: experts replicated, d_ff sharded
    "expert_ff": "model",
    "state": None,
    "d_inner": "model",    # mamba/rglru channel dim
    "layers": None,
    "frames": None,
    "kv_lora": None,
}

MULTI_POD_RULES = dict(SINGLE_POD_RULES, batch=("pod", "data"))

# Pure data parallelism: weights replicated, batch shards over BOTH mesh
# axes. For small models the model axis only buys redundant compute;
# folding it into batch divides per-device work by the model-axis size.
FULL_DP_RULES = dict(
    SINGLE_POD_RULES,
    batch=("data", "model"),
    heads=None, kv_heads=None, ff=None, vocab=None, expert_ff=None,
    d_inner=None, seq_kv=None,
)

# KV replicated across the model axis (for kv_heads < model-axis archs
# where head sharding pads and seq sharding all-reduces every step).
NO_KV_SHARD_RULES = dict(SINGLE_POD_RULES, kv_heads=None, seq_kv=None)

# Expert parallelism: routed-expert weights and dispatch buffers shard
# over the model axis along the EXPERT dim; per-expert d_ff stays whole,
# so the expert FFN contracts locally.
EXPERT_PARALLEL_RULES = dict(
    SINGLE_POD_RULES, experts="model", expert_ff=None)

RULE_SETS = {
    "default": SINGLE_POD_RULES,
    "dp": FULL_DP_RULES,
    "no-kv-shard": NO_KV_SHARD_RULES,
    "ep": EXPERT_PARALLEL_RULES,
}


def rule_set(name: str, multi_pod: bool = False) -> dict:
    rules = dict(RULE_SETS[name])
    if multi_pod:
        ba = rules["batch"]
        ba = ba if isinstance(ba, tuple) else (ba,)
        rules["batch"] = ("pod",) + ba
    return rules


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[dict] = None


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[dict] = None):
    """Activate a logical->mesh axis mapping on this thread."""
    if rules is None:
        rules = MULTI_POD_RULES if "pod" in mesh.axis_names \
            else SINGLE_POD_RULES
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active() -> bool:
    return _CTX.mesh is not None


def resolve(*logical: Optional[str]) -> Tuple[Axis, ...]:
    """Map logical axis names to a spec (one mesh axis, a tuple of
    them, or None per tensor axis) under the active rules."""
    assert _CTX.rules is not None
    spec = []
    used = set()
    for name in logical:
        if name is None:
            spec.append(None)
            continue
        mesh_axis = _CTX.rules.get(name)
        # an axis may appear only once in a spec; drop duplicates
        if mesh_axis is None or mesh_axis in used:
            spec.append(None)
        else:
            spec.append(mesh_axis)
            used.add(mesh_axis)
            if isinstance(mesh_axis, tuple):
                used.update(mesh_axis)
    return tuple(spec)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Logical-axis annotation: returns ``x`` (a placement hint only)."""
    if not active():
        return x
    assert x.ndim == len(logical), (tuple(x.shape), logical)
    return x


def named_sharding(*logical: Optional[str]):
    """The resolved spec under the active rules, None outside them."""
    if not active():
        return None
    return resolve(*logical)


def mesh_axis_size(logical: str) -> int:
    """Size of the mesh axis a logical name maps to (1 outside a context)."""
    if not active():
        return 1
    mesh_axis = _CTX.rules.get(logical)
    if mesh_axis is None:
        return 1
    if isinstance(mesh_axis, tuple):
        n = 1
        for a in mesh_axis:
            n *= _CTX.mesh.shape[a]
        return n
    return _CTX.mesh.shape[mesh_axis]
