"""Parameter initialisers shared by the cells (the part of
``repro.models.layers`` the ported cells use)."""

from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, in_dim: int,
               out_dim: int) -> torch.Tensor:
    """``N(0, 1) * in_dim ** -0.5`` of shape ``[in_dim, out_dim]``, float32,
    drawn on the CPU from ``generator`` (so a seed gives the same weights
    on every device)."""
    return torch.randn((in_dim, out_dim), generator=generator,
                       dtype=torch.float32) * in_dim ** -0.5
