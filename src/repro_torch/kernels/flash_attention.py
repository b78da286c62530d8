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
``"flash_attention.tf32"``).

Gradients.  The reference's kernel has no VJP; the port's has one at
float32, written by hand (``csrc/flash_attention_bwd.cu``, plain version
``ref.mha_bwd``).  A call that needs a gradient goes through
:class:`FlashAttention`: its forward runs the tf32 route asking the kernel
for the rows' log-sum-exp too, and saves ``q, k, v, lse``; its backward
is :func:`flash_attention_bwd` (dQ, dK, dV; counted under
``"flash_attention_bwd"``).  bf16 operands take the wgmma forward, which
saves no log-sum-exp: a gradient through them raises
(:data:`BF16_BACKWARD`).  A call without a gradient launches what it
always did.
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


#: What a gradient through a kernel that has no backward waits for.
BF16_BACKWARD = ("a K10 backward at bf16 waits for the wgmma forward to "
                 "save the log-sum-exp (ROADMAP.md queue 2, \"K10 backward "
                 "at bf16\")")
DECODE_BACKWARD = ("decode attention is never differentiated: training "
                   "runs K10")
REPLACES = "src/repro/kernels/flash_attention.py:88"


def refuse_grad(op: str, reference: str, *ts: torch.Tensor,
                waits_for: str = DECODE_BACKWARD) -> None:
    """Raise where autograd would need a backward of a kernel that runs
    forward only, as the reference's Pallas kernel (no ``custom_vjp``);
    ``waits_for`` says what would give it one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{op}: the kernel runs forward only -- the reference's Pallas "
            f"kernel ({reference}) has no VJP; {waits_for}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q`` ``[B, Hq, Sq, D]`` over ``k``/``v``
    ``[B, Hkv, Sk, D]`` (K10), float32 or bf16 (one type; permuted views
    welcome, unit stride along ``D``).  Returns a new contiguous
    ``[B, Hq, Sq, D]`` tensor at ``q``'s type.  The operands are checked
    before the device, so a view TMA cannot read raises on any device.
    Where a gradient is needed (float32 only) the call goes through
    :class:`FlashAttention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.dtype != torch.float32:
            refuse_grad("flash_attention", REPLACES, q, k, v,
                        waits_for=BF16_BACKWARD)
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, with_lse=False)[0]


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int], scale: Optional[float],
             with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K10's launch: ``(out, lse)``, ``lse`` the rows' float32 log-sum-exp
    ``[B, Hq, Sq]`` where ``with_lse`` (the tf32 route only), else None."""
    op = "flash_attention"
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
    if with_lse and path != "tf32":
        raise ValueError(f"{op}: the {path} route stores no log-sum-exp")
    require_cuda(op, q)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev) \
        if with_lse else None
    if path == "tf32":
        flags += (0 if lse is None else lse.data_ptr(),)
    if out.numel():
        launch_kernel(LIBRARIES[path], dev, out.data_ptr(), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
                      *strides, *flags, counts=(op, f"{op}.{path}"))
    return out, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 at float32 (the tf32 route) returning ``(out, lse)``: the
    output, and each row's log-sum-exp of its scaled scores, float32
    ``[B, Hq, Sq]`` (-inf for a row with no valid key), as ``ref.mha`` and
    ``ref.mha_lse`` give them.  The forward of :class:`FlashAttention`."""
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_lse: float32 operands only (the "
                        f"tf32 route), got {q.dtype}")
    return _forward(q, k, v, causal, window, scale, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10's backward (``csrc/flash_attention_bwd.cu``): ``(dq, dk, dv)``
    of :func:`flash_attention` at output gradient ``do``, from the
    forward's operands and its log-sum-exp ``lse``
    (:func:`flash_attention_lse`), as ``ref.mha_bwd`` computes them (the
    probabilities normalised by their own row sums, Δ from them: no
    output needed).  float32 only; ``q``, ``k``, ``v`` and ``do`` are read
    through their strides (unit stride along ``D``), ``lse`` ``[B, Hq,
    Sq]`` must be contiguous.  dK and dV sum the group of query heads of
    each KV head; the three come back new and contiguous.  One call is
    two launches (dQ with the row sums, then dK/dV), counted once under
    ``"flash_attention_bwd"``; deterministic (no float atomics)."""
    op = "flash_attention_bwd"
    dev = q.device
    f32 = torch.float32
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        check_operand(op, name, t, 4, f32, dev)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{op}: k/v must be [B, Hkv, Sk, D] = [{B}, Hkv, "
                         f"Sk, {D}] alike, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    check_heads(op, Hq, Hkv, D)
    for name, t, shape in (("do", do, q.shape), ("lse", lse, (B, Hq, Sq))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
    if lse.dtype != f32 or lse.device != dev:
        raise TypeError(f"{op}: lse must be float32 on {dev}")
    if not lse.is_contiguous():
        raise ValueError(f"{op}: lse must be contiguous (the forward's "
                         f"output)")
    if window is not None and window < 1:
        raise ValueError(f"{op}: window must be >= 1, got {window}")
    scale = D ** -0.5 if scale is None else float(scale)
    require_cuda(op, q)
    dq = torch.empty((B, Hq, Sq, D), dtype=f32, device=dev)
    dk = torch.empty((B, Hkv, Sk, D), dtype=f32, device=dev)
    dv = torch.empty((B, Hkv, Sk, D), dtype=f32, device=dev)
    rows = torch.empty((2, B, Hq, Sq), dtype=f32, device=dev)
    if dq.numel():
        strides = [t.stride(i) for t in (q, k, v, do) for i in range(3)]
        launch_kernel(op, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), rows[0].data_ptr(),
                      rows[1].data_ptr(), B, Hq, Hkv, Sq, Sk, D, *strides,
                      scale, int(causal), window or 0)
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K10 with a gradient, at float32: the forward runs
    :func:`flash_attention_lse` and saves ``q, k, v, lse``; the backward
    runs :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.opts = {"causal": causal, "window": window, "scale": scale}
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        if do.shape[-1] > 1 and do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None
