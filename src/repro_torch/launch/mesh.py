"""Device meshes over torch devices.

The port of ``repro/launch/mesh.py``. A mesh is a grid of
``torch.device``s with named axes (``DeviceMesh``); the serving mesh
(``serving/mesh.py``) runs one worker per cell of it in this process.
Meshes are built by FUNCTIONS, never at import, so importing this
module touches no device.

``force_device_count(n)`` is the counterpart of
``repro.xla_flags.force_host_device_count``: it makes ``n`` logical
devices over the physical ones, round-robin, for the whole process —
on a host with one card, every cell of a 4-cell mesh sits on
``cuda:0``. It takes CUDA devices unless asked for ``"cpu"`` (the
tests' mesh), and must run before a mesh is built. Without it a mesh
sees the visible CUDA devices only, and a mesh with more cells than
devices raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.sharding import MULTI_POD_RULES, SINGLE_POD_RULES

_FORCED: Optional[List[torch.device]] = None


def force_device_count(n: int, device: Union[str, torch.device, None] = None
                       ) -> List[torch.device]:
    """Make ``n`` logical devices, round-robin over the physical ones of
    ``device``'s kind (``"cuda"`` by default: every visible card, or
    only the one named, as ``"cuda:1"``; ``"cpu"``: the host). Returns
    the logical device list. Raises when no such device exists."""
    global _FORCED
    n = int(n)
    if n < 1:
        raise ValueError("force_device_count needs n >= 1")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        k = torch.cuda.device_count()
        if k == 0:
            raise RuntimeError(
                "force_device_count: no CUDA device is visible (pass "
                "device='cpu' for a host mesh)")
        phys = ([dev] if dev.index is not None
                else [torch.device("cuda", i) for i in range(k)])
    elif dev.type == "cpu":
        phys = [torch.device("cpu")]
    else:
        raise ValueError(f"force_device_count: no meshes over {dev}")
    _FORCED = [phys[i % len(phys)] for i in range(n)]
    return list(_FORCED)


def clear_forced_devices() -> None:
    """Forget ``force_device_count``: meshes see the visible cards."""
    global _FORCED
    _FORCED = None


def devices() -> List[torch.device]:
    """The logical devices meshes are built over: the forced list, else
    every visible CUDA device."""
    if _FORCED is not None:
        return list(_FORCED)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class DeviceMesh:
    """A grid of ``torch.device``s with named axes: ``devices`` is an
    object array of the grid's shape, ``shape`` maps axis name to
    size."""

    def __init__(self, grid: np.ndarray, axis_names: Sequence[str]):
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"mesh grid of rank {grid.ndim} for axes {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape})"


def _grid(devs: Sequence[torch.device], shape) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devs = devices()
    if len(devs) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {len(devs)} — "
            f"force {n} logical devices first "
            "(repro_torch.launch.mesh.force_device_count)")
    return DeviceMesh(_grid(devs[:n], shape), axes)


def make_serving_mesh(data: Optional[int] = None,
                      model: int = 1) -> DeviceMesh:
    """Request-parallel mesh for the sharded serving subsystem: each
    "data" shard owns a slice of the paged KV pool and decodes its
    resident rows. ``model > 1`` adds a second ("model",) axis so each
    data shard runs ensemble members tensor-parallel across ``model``
    columns (``sharding/tp.py``); ``model=1`` keeps the 1-D ("data",)
    mesh. ``data=None`` takes every logical device (divided by
    ``model``). With fewer devices than cells it raises: force the
    count first (``force_device_count``)."""
    devs = devices()
    m = int(model)
    if m < 1:
        raise ValueError("serving mesh needs model >= 1")
    n = (len(devs) // m) if data is None else int(data)
    if n < 1:
        raise ValueError("serving mesh needs at least one shard")
    need = n * m
    if len(devs) < need:
        raise RuntimeError(
            f"serving mesh data={n} model={m} needs {need} devices, "
            f"have {len(devs)} — force {need} logical devices before "
            "building it (repro_torch.launch.mesh.force_device_count"
            f"({need}), or force_device_count({need}, 'cpu') for a "
            "host mesh)")
    if m == 1:
        return DeviceMesh(_grid(devs[:n], (n,)), ("data",))
    return DeviceMesh(_grid(devs[:need], (n, m)), ("data", "model"))


def make_smoke_mesh(model: int = 1) -> DeviceMesh:
    """(n / model) x model mesh over every logical device."""
    devs = devices()
    n = len(devs)
    assert n % model == 0
    return DeviceMesh(_grid(devs, (n // model, model)),
                      ("data", "model"))


def rules_for(mesh: DeviceMesh) -> dict:
    return MULTI_POD_RULES if "pod" in mesh.axis_names \
        else SINGLE_POD_RULES


def mesh_chip_count(mesh: DeviceMesh) -> int:
    """Cells of the mesh (logical devices)."""
    return int(np.prod(list(mesh.shape.values())))
