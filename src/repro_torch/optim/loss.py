"""Next-token cross-entropy with masking, numerically stable in fp32."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, dict]:
    """logits: (B, S, V); labels: (B, S) int; mask: (B, S) {0,1}.

    Returns (mean loss over unmasked positions, metrics dict).
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    mask = (torch.ones_like(nll) if mask is None else mask.float())
    total = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / total
    acc = ((torch.argmax(logits, -1) == labels) * mask).sum() / total
    return loss, {"loss": loss, "token_accuracy": acc, "tokens": total}
