"""Parameter initialisers and the type-promoting product shared by the
cells (the part of ``repro.models.layers`` the ported cells use)."""

from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, in_dim: int,
               out_dim: int) -> torch.Tensor:
    """``N(0, 1) * in_dim ** -0.5`` of shape ``[in_dim, out_dim]``, float32,
    drawn on the CPU from ``generator`` (so a seed gives the same weights
    on every device)."""
    return torch.randn((in_dim, out_dim), generator=generator,
                       dtype=torch.float32) * in_dim ** -0.5


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion: a bf16 operand meeting a
    float32 one is taken to float32 first (``torch.matmul`` refuses mixed
    types; ``jnp.matmul`` promotes).  Same-typed operands go through
    unchanged, so a float32 product is bit for bit ``a @ b``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)
