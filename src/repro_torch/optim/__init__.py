from repro_torch.optim.adamw import (
    AdamWState, clip_by_global_norm, cosine_schedule, global_norm, init,
    update)
from repro_torch.optim.loss import softmax_cross_entropy

__all__ = [
    "AdamWState", "clip_by_global_norm", "cosine_schedule", "global_norm",
    "init", "softmax_cross_entropy", "update",
]
