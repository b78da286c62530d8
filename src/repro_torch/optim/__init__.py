"""Optimizer substrate: AdamW and learning-rate schedules (port of
``repro.optim`` without ``accum.py``, which waits for the trainer)."""

from repro_torch.optim.adamw import (OptState, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import (constant, cosine_decay,
                                        linear_warmup, warmup_cosine)

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "constant", "cosine_decay", "linear_warmup",
           "warmup_cosine"]
