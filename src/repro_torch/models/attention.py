"""Grouped-query attention (port of the GQA part of
``repro.models.attention``): ``AttnDims``, ``gqa_init``,
``gqa_empty_cache`` and the mode-polymorphic ``gqa_apply``:

  - ``mode="train"``   : full-sequence attention (K10), no cache;
  - ``mode="prefill"`` : as train, but also returns the KV cache;
  - ``mode="decode"``  : one new token against the cache at ``cache_pos``
    (K11).

Weights stay HEAD-MAJOR 3-D (``[D, n, Dh]`` / ``[n, Dh, D]``), the
reference's layout, so carrying them across is a plain copy.  Unlike the
reference, decode writes the new K/V row into the cache IN PLACE (one
row a sequence; the reference builds a new cache array) and returns the
same dict.  MLA (``mla_*``) and cross-attention (``cross_*``) are not
ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_q: int
    n_kv: int
    head_dim: int
    window: Optional[int] = None
    rope_theta: float = 10000.0
    bias: bool = False
    causal: bool = True


def gqa_init(generator: torch.Generator, dims: AttnDims,
             dtype=torch.float32, device=None) -> Params:
    """``N(0, 1)`` projections scaled by ``D ** -0.5`` (``wo`` by
    ``(n_q * Dh) ** -0.5``), drawn in float32 on the generator's device,
    cast to ``dtype`` on ``device``; zero biases when ``dims.bias``."""
    D, Dh = dims.d_model, dims.head_dim
    device = generator.device if device is None else device

    def hd(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale
        return x.to(device=device, dtype=dtype)

    p = {"wq": hd((D, dims.n_q, Dh), D ** -0.5),
         "wk": hd((D, dims.n_kv, Dh), D ** -0.5),
         "wv": hd((D, dims.n_kv, Dh), D ** -0.5),
         "wo": hd((dims.n_q, Dh, D), (dims.n_q * Dh) ** -0.5)}
    if dims.bias:
        for name, n in (("bq", dims.n_q), ("bk", dims.n_kv),
                        ("bv", dims.n_kv)):
            p[name] = torch.zeros((n, Dh), dtype=dtype, device=device)
    return p


def _proj_heads(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x``: ``[B, S, D]``; ``w``: ``[D, n, Dh]`` → ``[B, n, S, Dh]`` (a
    permuted view of one product)."""
    B, S, D = x.shape
    _, n, dh = w.shape
    y = (x.reshape(B * S, D) @ w.reshape(D, n * dh)).view(B, S, n, dh)
    if b is not None:
        y = y + b
    return y.permute(0, 2, 1, 3)


def gqa_empty_cache(dims: AttnDims, batch: int, max_len: int,
                    dtype=torch.float32, device="cuda") -> Params:
    shp = (batch, dims.n_kv, max_len, dims.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def gqa_apply(params: Params, x: torch.Tensor, positions: torch.Tensor, *,
              dims: AttnDims, mode: str = "train",
              cache: Optional[Params] = None,
              cache_pos: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """``x``: ``[B, S, D]`` (``S == 1`` for decode); ``positions``: ``[S]``
    (train/prefill) or ignored (decode, which takes ``cache_pos``: ``[B]``
    absolute positions, int32 on ``x``'s device).  Returns ``(y, cache)``:
    ``y`` ``[B, S, D]``; the prefill's fresh ``{"k", "v"}`` ``[B, n_kv,
    S, Dh]``, the decode's cache (written in place), or ``None``."""
    bq, bk, bv = params.get("bq"), params.get("bk"), params.get("bv")
    if mode in ("train", "prefill"):
        q = _proj_heads(x, params["wq"], bq)
        k = _proj_heads(x, params["wk"], bk)
        v = _proj_heads(x, params["wv"], bv)
        q = apply_rope(q, positions, dims.rope_theta)
        k = apply_rope(k, positions, dims.rope_theta)
        o = kops.attention(q, k, v, causal=dims.causal, window=dims.window)
        y = torch.einsum("bnsk,nkd->bsd", o, params["wo"])
        return y, ({"k": k, "v": v} if mode == "prefill" else None)
    if mode != "decode":
        raise ValueError(f"unknown attention mode {mode!r}")

    if cache is None or cache_pos is None:
        raise ValueError("decode needs a cache and cache_pos")
    B = x.shape[0]
    xt = x[:, 0] if x.dim() == 3 else x                       # [B, D]
    q = torch.einsum("bd,dnk->bnk", xt, params["wq"])
    k_new = torch.einsum("bd,dnk->bnk", xt, params["wk"])
    v_new = torch.einsum("bd,dnk->bnk", xt, params["wv"])
    if bq is not None:
        q, k_new, v_new = q + bq, k_new + bk, v_new + bv
    pos = cache_pos.to(torch.int64)
    q = apply_rope(q[:, :, None, :], pos[:, None, None],
                   dims.rope_theta)[:, :, 0]
    k_new = apply_rope(k_new[:, :, None, :], pos[:, None, None],
                       dims.rope_theta)[:, :, 0]
    # SWA caches are rolling buffers of exactly ``window`` rows: the write
    # wraps and the valid-row count saturates, the absolute RoPE already
    # in each row keeps the scores right.  The new row is cast to the
    # cache's type before it is attended, as in the reference.
    k, v = cache["k"], cache["v"]
    L = k.shape[2]
    rolling = dims.window is not None and L <= dims.window
    write = pos % L if rolling else pos
    bidx = torch.arange(B, device=x.device)
    k[bidx, :, write] = k_new.to(k.dtype)
    v[bidx, :, write] = v_new.to(v.dtype)
    kv_len = (torch.clamp(pos + 1, max=L) if rolling else pos + 1) \
        .to(torch.int32)
    o = kops.decode_attention(q.to(k.dtype), k, v, kv_len=kv_len,
                              window=None if rolling else dims.window)
    y = torch.einsum("bnk,nkd->bd", o, params["wo"])
    return y[:, None, :], cache
