"""Single-token decode attention over a KV cache: one hand-written CUDA
launch (K11).

Port of ``repro.kernels.decode_attention``'s Pallas kernel
(``decode_attention``): ``q`` ``[B, Hq, D]`` against the cache ``k``/``v``
``[B, Hkv, S, D]`` with per-sequence valid lengths ``kv_len`` ``[B]``
(rows ``>= kv_len[b]`` masked; with ``window``, rows
``< kv_len[b] - window`` too) → ``[B, Hq, D]`` at ``q``'s type, float32
math, GQA, ``scale`` (default ``D ** -0.5``).  ``csrc/decode_attention.cu``
holds the kernel; its header states the bound and the design.  ``kv_len``
stays a device tensor, so a launch never synchronises with the host.

Each slot's valid rows are split over the ``ns`` CTAs of a thread-block
cluster, which combine their partial softmax statistics in rank order
inside the launch.  The split's arithmetic is written once, in
:mod:`repro_torch.kernels.decode_split`, and mirrored in the ``.cu``;
this wrapper takes ``ns`` from its ``split_count``.

The wrapper takes CUDA tensors only: it launches the kernel or raises.
The plain version for CPU tensors (``ref.decode_attention``) is chosen in
:mod:`repro_torch.kernels.ops`.  Each launch is counted in
``level_megastep.LAUNCHES``.  Forward only, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.decode_split import heads_per_cta, split_count
from repro_torch.kernels.flash_attention import (check_heads, check_operand,
                                                 refuse_grad)
from repro_torch.kernels.level_megastep import launch_kernel, require_cuda


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Optional[torch.Tensor] = None,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query token a sequence, ``q`` ``[B, Hq, D]``, against the
    cache ``k``/``v`` ``[B, Hkv, S, D]`` (K11), float32 or bf16 (one
    type; unit stride along ``D``).  ``kv_len``: ``[B]`` int32 on the
    card (default: every row valid).  Returns a new contiguous
    ``[B, Hq, D]`` tensor at ``q``'s type."""
    op = "decode_attention"
    require_cuda(op, q)
    refuse_grad(op, "src/repro/kernels/decode_attention.py:70", q, k, v)
    dev = q.device
    check_operand(op, "q", q, 3, q.dtype, dev)
    check_operand(op, "k", k, 4, q.dtype, dev)
    check_operand(op, "v", v, 4, q.dtype, dev)
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{op}: k/v must be [B, Hkv, S, D] = [{B}, Hkv, S, "
                         f"{D}] alike, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    check_heads(op, Hq, Hkv, D)
    if kv_len is None:
        kv_len = torch.full((B,), S, dtype=torch.int32, device=dev)
    if (kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,)
            or kv_len.device != dev or not kv_len.is_contiguous()):
        raise ValueError(f"{op}: kv_len must be a contiguous [{B}] int32 "
                         f"tensor on {dev}, got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    if window is not None and window < 1:
        raise ValueError(f"{op}: window must be >= 1, got {window}")
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=dev)
    if out.numel():
        G = Hq // Hkv
        clusters = B * Hkv * -(-G // heads_per_cta(G))
        ns = split_count(S, clusters, _sm_count(dev.index))
        launch_kernel(op, dev, out.data_ptr(), q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), kv_len.data_ptr(), B, Hq, Hkv, S, D,
                      q.stride(0), q.stride(1),
                      k.stride(0), k.stride(1), k.stride(2),
                      v.stride(0), v.stride(1), v.stride(2),
                      scale, window or 0, ns, int(q.dtype == torch.bfloat16))
    return out
