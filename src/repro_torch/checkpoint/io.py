"""npz checkpoints of nested-dict trees of tensors.

The reference's format (``repro/checkpoint/io.py``): one npz entry per
leaf, keyed by its ``/``-joined dict path, plus a ``__meta__`` JSON
string {step, dtypes, user}; bfloat16 has no numpy dtype, so a bf16
leaf is stored as its uint16 bits and tagged "bfloat16" in ``dtypes``.
A checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.models.params import _leaves, _set


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_tensor(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save_checkpoint(path: Union[str, Path], tree: dict, step: int = 0,
                    metadata: Optional[Dict] = None) -> Path:
    """Atomically write ``tree`` (+ metadata json) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _leaves(tree):
        arrays[k] = _to_numpy(v)
        dtypes[k] = ("bfloat16" if v.dtype == torch.bfloat16
                     else str(arrays[k].dtype))
    meta = {"step": step, "dtypes": dtypes, "user": metadata or {}}
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_metadata(path: Union[str, Path]) -> Dict:
    with np.load(Path(path), allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def restore_checkpoint(path: Union[str, Path], template: dict) -> dict:
    """Restore into the structure, dtypes and devices of ``template``
    (a tree of tensors, e.g. ``init_params`` of the same config)."""
    path = Path(path)
    out: dict = {}
    with np.load(path, allow_pickle=False) as z:
        dtypes = json.loads(str(z["__meta__"]))["dtypes"]
        for key, leaf in _leaves(template):
            if key not in z:
                raise KeyError(f"checkpoint {path} missing {key!r}")
            t = _to_tensor(z[key], dtypes.get(key) == "bfloat16")
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {tuple(t.shape)} != template "
                    f"{tuple(leaf.shape)}")
            _set(out, key, t.to(device=leaf.device, dtype=leaf.dtype))
    return out
