"""Blocked online-softmax attention: one hand-written CUDA launch (K10).

Port of ``repro.kernels.flash_attention``'s Pallas kernel
(``flash_attention``): ``q`` ``[B, Hq, Sq, D]`` against ``k``/``v``
``[B, Hkv, Sk, D]`` → ``[B, Hq, Sq, D]`` at ``q``'s type, float32 math,
with ``causal`` masking (the ends aligned: query ``i`` sits at key
position ``i + Sk - Sq``), a sliding ``window`` (keys ``> p - window``),
GQA (query head ``h`` reads KV head ``h // (Hq / Hkv)``, no copy) and
``scale`` (default ``D ** -0.5``).  ``csrc/flash_attention.cu`` holds the
kernel; its header states the bound and the design.  A query with no
valid key gets a zero row.

The wrapper takes CUDA tensors only: it launches the kernel or raises.
The plain version for CPU tensors (``ref.mha``) is chosen in
:mod:`repro_torch.kernels.ops`.  Each launch is counted in
``level_megastep.LAUNCHES``.  Forward only, as in the reference (no
VJP): a call that would need a gradient raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.level_megastep import launch_kernel, require_cuda

#: Element types the attention kernels take, and the widest head.
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def check_operand(op: str, name: str, t: torch.Tensor, ndim: int,
                  dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is an ``ndim``-D tensor of ``dtype`` on
    ``device`` with unit stride along its last (head) dimension: the
    kernels read the other dimensions through their strides."""
    if t.dim() != ndim:
        raise ValueError(f"{op}: {name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype or dtype not in DTYPES:
        raise TypeError(f"{op}: {name} must be float32 or bfloat16 like q, "
                        f"got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, q on {device}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{op}: {name} needs unit stride along its head "
                         f"dim, got strides {t.stride()}")


def check_heads(op: str, Hq: int, Hkv: int, D: int) -> None:
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{op}: {Hq} query heads do not fold onto {Hkv} "
                         f"KV heads")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{op}: head dim {D} outside 1..{MAX_HEAD_DIM}")


def refuse_grad(op: str, reference: str, *ts: torch.Tensor) -> None:
    """The kernels run forward only, as the reference's Pallas kernels
    (no ``custom_vjp``): raise where autograd would need a backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{op}: the kernel runs forward only -- the reference's Pallas "
            f"kernel ({reference}) has no VJP; LM training needs a backward "
            f"kernel written by hand (ROADMAP.md, queue 2)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q`` ``[B, Hq, Sq, D]`` over ``k``/``v``
    ``[B, Hkv, Sk, D]`` (K10), float32 or bf16 (one type; permuted views
    welcome, unit stride along ``D``).  Returns a new contiguous
    ``[B, Hq, Sq, D]`` tensor at ``q``'s type."""
    op = "flash_attention"
    require_cuda(op, q)
    refuse_grad(op, "src/repro/kernels/flash_attention.py:88", q, k, v)
    dev = q.device
    check_operand(op, "q", q, 4, q.dtype, dev)
    check_operand(op, "k", k, 4, q.dtype, dev)
    check_operand(op, "v", v, 4, q.dtype, dev)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{op}: k/v must be [B, Hkv, Sk, D] = [{B}, Hkv, "
                         f"Sk, {D}] alike, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    check_heads(op, Hq, Hkv, D)
    if window is not None and window < 1:
        raise ValueError(f"{op}: window must be >= 1, got {window}")
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=dev)
    if out.numel():
        launch_kernel(op, dev, out.data_ptr(), q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
                      q.stride(0), q.stride(1), q.stride(2),
                      k.stride(0), k.stride(1), k.stride(2),
                      v.stride(0), v.stride(1), v.stride(2),
                      scale, int(causal), window or 0,
                      int(q.dtype == torch.bfloat16))
    return out
