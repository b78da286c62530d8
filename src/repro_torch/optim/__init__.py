"""Optimizer substrate: AdamW, learning-rate schedules and gradient
accumulation (port of ``repro.optim``)."""

from repro_torch.optim.adamw import (OptState, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import (constant, cosine_decay,
                                        linear_warmup, warmup_cosine)
from repro_torch.optim.accum import microbatch_grads

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "constant", "cosine_decay", "linear_warmup",
           "warmup_cosine", "microbatch_grads"]
