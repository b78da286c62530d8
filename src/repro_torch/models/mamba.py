"""Mamba-2 mixer block in SSD form (port of ``repro.models.mamba``).

Config follows mamba2-370m: ``d_inner = expand * d_model``, heads
``H = d_inner / headdim``, one B/C group, a depthwise causal conv over
the ``x``/``B``/``C`` lanes, gated RMSNorm before the output projection.
Three modes, as the reference:

  - ``train``:   the whole sequence through the chunked SSD (``ops.ssd``:
                 K12 once a call on the card), no cache;
  - ``prefill``: as train, and returns the decode cache: the last
                 ``d_conv - 1`` pre-conv rows (``conv``) and the final
                 SSM state (``ssm``, float32);
  - ``decode``:  one token a sequence against the cache, plain ops (the
                 reference's decode step is plain jnp too).

Unlike the reference, decode updates the cache IN PLACE (both leaves)
and returns the same dict, and prefill takes the conv tail from the
pre-conv rows it already holds instead of projecting the tail again
(:func:`xBC_raw_tail`).  The reference's ``shard``/``shard_param`` hooks
have no counterpart on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, matmul

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_state: int = 128       # N
    headdim: int = 64        # P
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def mamba_init(generator: torch.Generator, dims: MambaDims,
               dtype=torch.float32, device=None) -> Params:
    """The reference's initialisation: ``w_in`` ``[D, 2 Din + 2N + H]``
    (``z | x | B | C | dt``) and ``w_out`` ``[Din, D]`` scaled by
    ``in_dim ** -0.5``, ``conv_w`` ``N(0, 0.1)``, ``A = -exp(0) = -1``,
    ``D = 1``, ``dt_bias = -2`` (the last three float32 whatever
    ``dtype``), drawn on the generator's device, cast to ``dtype`` on
    ``device``."""
    device = generator.device if device is None else device
    D, Din, N, H = dims.d_model, dims.d_inner, dims.d_state, dims.n_heads
    f32 = torch.float32
    w_in = dense_init(generator, D, 2 * Din + 2 * N + H, dtype, device)
    conv_w = (torch.randn((dims.d_conv, dims.conv_dim), generator=generator,
                          dtype=f32, device=generator.device) * 0.1)
    return {
        "w_in": w_in,
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((dims.conv_dim,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), dtype=f32, device=device),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.full((H,), -2.0, dtype=f32, device=device),
        "norm_scale": torch.ones((Din,), dtype=dtype, device=device),
        "w_out": dense_init(generator, Din, D, dtype, device),
    }


def _split_proj(zxbcdt: torch.Tensor, dims: MambaDims):
    """``(z, xBC, dt)`` views of the input projection."""
    Din, N = dims.d_inner, dims.d_state
    return (zxbcdt[..., :Din], zxbcdt[..., Din:2 * Din + 2 * N],
            zxbcdt[..., 2 * Din + 2 * N:])


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis, then SiLU.
    ``xBC``: ``[B, L, C]``, ``w``: ``[K, C]``."""
    K, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)`` in float32, cast back to ``y``'s type."""
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * scale.float()).to(y.dtype)


def mamba_empty_cache(dims: MambaDims, batch: int, dtype=torch.float32,
                      device="cuda") -> Params:
    """Zeroed decode cache: ``conv`` ``[batch, d_conv - 1, conv_dim]`` at
    ``dtype``, ``ssm`` ``[batch, H, P, N]`` float32 whatever ``dtype``."""
    return {
        "conv": torch.zeros((batch, dims.d_conv - 1, dims.conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, dims.n_heads, dims.headdim,
                            dims.d_state), dtype=torch.float32,
                           device=device),
    }


def xBC_raw_tail(xBC: torch.Tensor, dims: MambaDims) -> torch.Tensor:
    """The prefill -> decode hand-off of the conv: the last ``d_conv - 1``
    pre-conv rows of ``xBC`` ``[B, L, conv_dim]``, zero rows in front when
    ``L`` is shorter.  The reference projects the last rows of the block
    input again (``xBC_raw_tail(x, params, dims)``); these are the same
    rows of the full projection."""
    K1 = dims.d_conv - 1
    tail = xBC[:, -K1:, :]
    return F.pad(tail, (0, 0, K1 - tail.shape[1], 0))


def mamba_apply(params: Params, x: torch.Tensor, *, dims: MambaDims,
                mode: str = "train", cache: Optional[Params] = None,
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """``x``: ``[B, L, D]`` (``L == 1`` in decode).  Returns ``(out
    [B, L, D], cache)``: ``None`` in train mode, a fresh cache in prefill,
    ``cache`` itself, updated in place, in decode."""
    B = x.shape[0]
    Din, N, H, P = dims.d_inner, dims.d_state, dims.n_heads, dims.headdim
    A = -torch.exp(params["A_log"])

    if mode in ("train", "prefill"):
        L = x.shape[1]
        z, xBC_pre, dt_raw = _split_proj(matmul(x, params["w_in"]), dims)
        xBC = _causal_conv(xBC_pre, params["conv_w"], params["conv_b"])
        xs = xBC[..., :Din].reshape(B, L, H, P)
        Bm = xBC[..., Din:Din + N]
        Cm = xBC[..., Din + N:]
        dt = F.softplus(dt_raw.float() + params["dt_bias"])   # [B, L, H]
        y, s_fin = kops.ssd(xs, dt, A, Bm, Cm, params["D"], chunk=dims.chunk)
        y = _gated_norm(y.reshape(B, L, Din), z, params["norm_scale"])
        out = matmul(y, params["w_out"])
        if mode == "train":
            return out, None
        return out, {"conv": xBC_raw_tail(xBC_pre, dims), "ssm": s_fin}
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")

    if cache is None:
        raise ValueError("decode needs the cache")
    xt = x[:, 0] if x.dim() == 3 else x
    z, xBC_new, dt_raw = _split_proj(matmul(xt, params["w_in"]), dims)
    # The conv window: the last d_conv - 1 pre-conv rows and the new one.
    conv_in = torch.cat([cache["conv"], xBC_new[:, None, :]], dim=1)
    xBC = F.silu(torch.sum(conv_in * params["conv_w"][None], dim=1)
                 + params["conv_b"])
    xs = xBC[..., :Din].reshape(B, H, P)
    Bm = xBC[..., Din:Din + N]
    Cm = xBC[..., Din + N:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    y, _ = kops.ssd_decode_step(xs, dt, A, Bm, Cm, params["D"], cache["ssm"])
    y = _gated_norm(y.reshape(B, Din), z, params["norm_scale"])
    cache["conv"].copy_(conv_in[:, 1:])
    return matmul(y, params["w_out"])[:, None, :], cache
