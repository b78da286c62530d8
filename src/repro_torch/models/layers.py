"""Shared building blocks (port of ``repro.models.layers``): parameter
initialisers, the type-promoting product the cells share, and the
transformer's norms, RoPE, SwiGLU MLP and token cross-entropy.

The reference's activation-sharding hooks (``shard``, ``shard_param``,
``axis_rules``) have no meaning on one device and are not ported.

Initialisers take a ``torch.Generator`` and draw on the generator's
device in float32 (a CPU generator gives the same weights on every
device; a CUDA generator draws a full-size model on the card without a
host copy), then cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _normal(generator: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return x.to(device=device if device is not None else generator.device,
                dtype=dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """``N(0, 1) * in_dim ** -0.5`` of shape ``[in_dim, out_dim]``, drawn
    in float32 from ``generator`` on its device, cast to ``dtype`` on
    ``device`` (default: the generator's)."""
    return _normal(generator, (in_dim, out_dim), in_dim ** -0.5, dtype,
                   device)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """``N(0, 1) * 0.02`` of shape ``[vocab, dim]`` (the reference's)."""
    return _normal(generator, (vocab, dim), 0.02, dtype, device)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion: a bf16 operand meeting a
    float32 one is taken to float32 first (``torch.matmul`` refuses mixed
    types; ``jnp.matmul`` promotes).  Same-typed operands go through
    unchanged, so a float32 product is bit for bit ``a @ b``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Computed in float32 whatever ``x``'s type, cast back to it."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """``x``: ``[..., S, D]`` (D even); ``positions``: ``[S]`` or
    broadcastable to x's leading dims + ``[S]``.  Rotates INTERLEAVED
    pairs ``(x[..., 2i], x[..., 2i+1])`` by ``pos * freq_i`` with the
    angles in float32, as the reference does (not the half-split layout);
    returns ``x``'s type."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)                 # [D/2]
    angles = positions[..., :, None].float() * freqs             # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    out = torch.stack([xr1, xr2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32, device=None) -> Params:
    return {"w_gate": dense_init(generator, d_model, d_ff, dtype, device),
            "w_up": dense_init(generator, d_model, d_ff, dtype, device),
            "w_down": dense_init(generator, d_ff, d_model, dtype, device)}


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# LM loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 0.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean CE in float32 with optional z-loss.  ``logits``:
    ``[..., V]``; ``labels``: ``[...]`` integer ids."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    return loss, {"nll": loss, "tokens": mask.sum()}
