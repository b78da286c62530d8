"""Blocked online-softmax attention: one hand-written CUDA launch (K10).

Port of ``repro.kernels.flash_attention``'s Pallas kernel
(``flash_attention``): ``q`` ``[B, Hq, Sq, D]`` against ``k``/``v``
``[B, Hkv, Sk, D]`` → ``[B, Hq, Sq, D]`` at ``q``'s type, fp32
accumulation, with ``causal`` masking (the ends aligned: query ``i`` sits
at key position ``i + Sk - Sq``), a sliding ``window`` (keys ``> p -
window``), GQA (query head ``h`` reads KV head ``h // (Hq / Hkv)``, no
copy) and ``scale`` (default ``D ** -0.5``).  A query with no valid key
gets a zero row.

Two kernels, chosen by the operands (:func:`route`), never as a
fallback:

* ``"wgmma"`` -- bf16 with ``D % 16 == 0`` and ``D <= 256``:
  ``csrc/flash_attention_sm90.cu``, QKᵀ and PV on the tensor cores by
  ``wgmma``, operands staged by TMA.  QKᵀ of bf16 operands is exact in
  fp32; each fp32 probability is split into ``P_hi = bf16(P)`` and
  ``P_lo = bf16(P - P_hi)`` and PV runs on both, so PV keeps about 16
  bits of ``P``.  TMA reads the batch, head and row strides, which must
  be multiples of 16 bytes (:func:`tma_strides` raises otherwise);
* ``"tf32"`` -- float32 at every head dim ``1..256``, and bf16 at the
  head dims ``"wgmma"`` does not take: ``csrc/flash_attention_tf32.cu``,
  QKᵀ and PV on the TF32 tensor cores by ``mma.sync``, each f32 operand
  split into ``x_big = tf32(x)`` and ``x_small = tf32(x - x_big)`` and
  each product run as three TF32 products (small·big + big·small +
  big·big) into fp32, about 21 bits of each operand; a bf16 operand is
  exact in TF32, so QKᵀ takes one product and PV two.  K/V staged by
  ``cp.async`` through any strides; a head dim that is no multiple of 8
  zero-padded to the next (``mma.sync`` steps 8 columns).

Each source's header states its bound and design.  The wrapper takes
CUDA tensors only: it launches a kernel or raises.  The plain version for
CPU tensors (``ref.mha``) is chosen in :mod:`repro_torch.kernels.ops`.
Each launch is counted in ``level_megastep.LAUNCHES`` under
``"flash_attention"`` and under its route (``"flash_attention.wgmma"``,
``"flash_attention.tf32"``).  Forward only, as in the reference (no
VJP): a call that would need a gradient raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.level_megastep import launch_kernel, require_cuda

#: Element types the attention kernels take, and the widest head.
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
#: route → the library (``_build.KERNELS`` name) that runs it.
LIBRARIES = {"wgmma": "flash_attention_sm90",
             "tf32": "flash_attention_tf32"}


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that takes operands of ``dtype`` at head dim ``D``:
    ``"wgmma"`` for bf16 with ``D % 16 == 0`` (bf16 ``wgmma`` takes k16
    steps), ``"tf32"`` for every other float32 or bf16 head dim in
    ``1..256``; raises for another type or head dim."""
    if dtype not in DTYPES or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: no kernel takes {dtype} at head "
                         f"dim {D} (float32 or bfloat16, 1..{MAX_HEAD_DIM})")
    if dtype == torch.bfloat16 and D % 16 == 0:
        return "wgmma"
    return "tf32"


def tma_strides(op: str, name: str, t: torch.Tensor) -> Tuple[int, ...]:
    """The (batch, head, row) strides, in elements, through which TMA
    reads the ``[B, H, S, D]`` operand ``t``; a dimension of size 1 gets
    its contiguous stride, since no copy steps along it.  Raises unless
    each is a positive multiple of 16 bytes and ``t`` starts on a 16-byte
    boundary, which TMA needs (a view that breaks this is not copied)."""
    B, H, S, D = t.shape
    e = t.element_size()
    sizes, contiguous = (B, H, S), (H * S * D, S * D, D)
    st = tuple(c if n == 1 else s for n, s, c in
               zip(sizes, t.stride()[:3], contiguous))
    if any(s <= 0 or s * e % 16 for s in st) or t.data_ptr() % 16:
        raise ValueError(
            f"{op}: TMA reads {name} through its batch, head and row "
            f"strides, which must be positive multiples of 16 bytes on a "
            f"16-byte aligned base; got strides {t.stride()} of "
            f"{t.dtype} at offset {t.data_ptr() % 16} from 16 bytes")
    return st


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
    ``[B, Hq, Sq, D]`` tensor at ``q``'s type.  The operands are checked
    before the device, so a view TMA cannot read raises on any device."""
    op = "flash_attention"
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
    path = route(q.dtype, D)
    if path == "wgmma":
        strides = [s for name, t in (("q", q), ("k", k), ("v", v))
                   for s in tma_strides(op, name, t)]
        flags = (scale, int(causal), window or 0)
    else:
        # A dimension of size 1 is never stepped along: stride 0, so that
        # its stride does not keep the kernel off its 16-byte copies.
        strides = [0 if t.shape[i] == 1 else t.stride(i)
                   for t in (q, k, v) for i in range(3)]
        flags = (scale, int(causal), window or 0,
                 int(q.dtype == torch.bfloat16))
    require_cuda(op, q)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=dev)
    if out.numel():
        launch_kernel(LIBRARIES[path], dev, out.data_ptr(), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
                      *strides, *flags, counts=(op, f"{op}.{path}"))
    return out
