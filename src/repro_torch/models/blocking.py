"""Fixed-shape token blocking: bitwise batch invariance for projections.

A GEMM library picks its tiling (and on the card its kernel) per shape,
so a token's projection can round differently depending on how many
other tokens share the GEMM — batch composition. The serving stack's
contracts need a token's bits to depend only on its own values: the
step loop decodes a row inside whatever bucket it lands in, and every
rerun of a stream must reproduce its answers.

``blocked_rows`` removes the shape dependence: the row-parallel function
runs over fixed (``TOKEN_BLOCK``, d) row blocks (tail zero-padded,
output sliced back), one call per block, so every elementary matmul has
one static shape and one reduction order whatever the token count.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

# 8 rows: every serving-path GEMM becomes (8, d) x (d, f). Small enough
# that decode batches (<= max_active_rows) stay one or two blocks, big
# enough that chunked prefill is not dominated by loop overhead.
TOKEN_BLOCK = 8


def blocked_rows(fn: Callable[[torch.Tensor], torch.Tensor],
                 xt: torch.Tensor) -> torch.Tensor:
    """Apply a row-parallel ``fn`` over fixed-size row blocks of ``xt``.

    xt: (T, d). ``fn`` maps (TOKEN_BLOCK, d) -> (TOKEN_BLOCK, ...) and
    must be row-parallel (each output row a function of the matching
    input row only — projections, gated MLPs). Returns the
    concatenation of the per-block outputs, sliced back to T rows.
    """
    t = xt.shape[0]
    nb = -(-t // TOKEN_BLOCK)
    pad = nb * TOKEN_BLOCK - t
    xp = F.pad(xt, (0, 0, 0, pad)) if pad else xt
    y = torch.cat([fn(xp[i * TOKEN_BLOCK:(i + 1) * TOKEN_BLOCK])
                   for i in range(nb)], dim=0)
    return y[:t] if pad else y
