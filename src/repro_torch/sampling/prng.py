"""A replica of jax's default PRNG (threefry2x32) for the sampler.

The serving loop draws every token from a per-row key stream
(``sampler.sample_token_rows``): ``categorical(fold_in(row_key, step),
logits)``. Reproducing the reference's tokens therefore needs the
reference's random bits. This module reproduces jax 0.9.0's
``threefry2x32`` as jax runs it by default: raw ``(2,)`` uint32 keys,
``jax_threefry_partitionable=True`` (random bits at index ``j`` of a
draw hash the counter pair ``(j >> 32, j & 0xffffffff)``), ``fold_in``,
``split``, and ``uniform`` -> gumbel -> ``categorical``. Keys and bits agree with
jax's bit for bit (``tests/test_torch_sampling.py``).

uint32 arithmetic is emulated in int64 tensors (values kept in
[0, 2**32)), so the same code runs on the host and on the card: a
(B, V) draw computes its bits on the logits' device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) on int64 tensors holding
    uint32 values; all four operands broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _as_keys(keys, device=None) -> torch.Tensor:
    """uint32 key data (numpy or tensor, (..., 2)) -> int64 tensor."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device or keys.device, dtype=torch.int64)
    arr = np.asarray(keys)
    if arr.dtype != np.uint32:
        raise TypeError(f"raw PRNG keys are uint32, got {arr.dtype}")
    return torch.from_numpy(arr.astype(np.int64)).to(device or "cpu")


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (2,) uint32."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} is outside the 32-bit range")
    return np.asarray([0, seed & _MASK], np.uint32)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: keys (..., 2) int64, data
    broadcastable to keys[..., 0] (uint32 values) -> (..., 2) int64."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) \
        & _MASK
    zero = torch.zeros_like(data)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], zero, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def fold_in_np(key: np.ndarray, data) -> np.ndarray:
    """Host ``fold_in``: key (..., 2) uint32 numpy -> uint32 numpy."""
    out = fold_in(_as_keys(key), torch.as_tensor(np.asarray(data,
                                                            np.int64)))
    return out.numpy().astype(np.uint32)


def split(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.split(key, n)``: (n, 2) uint32. Under the
    partitionable layout subkey ``i`` hashes the counter pair
    ``(i >> 32, i & 0xffffffff)``, which for ``i < 2**32`` is
    ``fold_in(key, i)``."""
    if not 0 <= n <= 1 << 32:
        raise ValueError(f"cannot split a key into {n} subkeys")
    key = np.asarray(key, np.uint32)
    return fold_in_np(np.broadcast_to(key, (n, 2)),
                      np.arange(n, dtype=np.int64))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random bits of a length-``n`` draw per key (partitionable
    layout): keys (B, 2) int64 -> (B, n) int64 in [0, 2**32)."""
    j = torch.arange(n, device=keys.device, dtype=torch.int64)
    hi, lo = j >> 32, j & _MASK
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], hi[None], lo[None])
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``
    per key: (B, n) float32 in [tiny, 1)."""
    bits = random_bits(keys, n)
    # 23 random mantissa bits under the exponent of 1.0 -> [1, 2) - 1
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # floats * (maxval - minval) + minval, with maxval - minval == 1.0f
    return torch.clamp_min(floats + _TINY_F32, _TINY_F32)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") per key: (B, n) float32."""
    return -torch.log(-torch.log(uniform(keys, n)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key_b, logits[b])`` per row: keys
    (B, 2) int64, logits (B, V) float32 -> (B,) int32 (gumbel-max;
    ties go to the first index, as ``jnp.argmax`` does)."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1).to(torch.int32)
