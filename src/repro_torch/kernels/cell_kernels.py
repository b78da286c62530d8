"""Fused gate-chain kernels of the op-by-op leg (the kernel-fusion axis of
the paper's Fig. 10 ablation): one hand-written CUDA launch each.

Port of ``repro.kernels.cell_kernels``:

  :func:`lstm_gates`     — the LSTM gate chain over ``[M, 4H]``
    pre-activations and ``c_prev`` (K8a);
  :func:`treelstm_gates` — the child-sum Tree-LSTM gate chain over the
    ``i/o/u`` pre-activations, the per-child forget pre-activations and
    child cells, and the child mask (K8b).

Both live in ``csrc/cell_gates.cu``, whose header states the bound and
the design; :mod:`repro_torch.kernels._build` compiles it with ``nvcc``
for ``sm_90a`` on first use.  Each operand is read at its own type (float
or bf16) through its own strides, so the strided halves of a gathered
state go in without a copy; the math is float32 and the outputs are two
fresh ``[M, H]`` tensors at the pre-activations' type, as in the
reference.

The wrappers take CUDA tensors only: they launch the kernel or raise.
The plain versions for CPU tensors (``ref.lstm_gates``,
``ref.treelstm_gates``) are chosen in :mod:`repro_torch.kernels.ops`.
Each launch is counted in ``level_megastep.LAUNCHES`` under the kernel's
name; an empty shape launches nothing.

Forward only.  Each wrapper is a ``torch.autograd.Function`` whose
backward raises ``NotImplementedError``: the reference's Pallas kernels
have no VJP, so a gradient through them fails loudly on the card, as it
does on the TPU, rather than going quietly through the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels.level_megastep import launch_kernel, require_cuda

#: Element types the kernels read and write.
DTYPES = (torch.float32, torch.bfloat16)

_INT_MAX = 2 ** 31 - 1

#: K8a's (columns a thread, threads a block) on its vector route, in the
#: order tried: the most columns a CTA first.
K8A_GEOMETRIES = ((4, 256), (4, 128), (2, 128), (4, 64), (2, 64))


def k8a_geometry(M: int, H: int, sms: int, vec: bool) -> Tuple[int, int]:
    """K8a's ``(V, threads a block)`` at ``[M, H]`` on a card of ``sms``
    SMs (``csrc/cell_gates.cu`` states why).  Where a 4-wide vector fits
    (``vec``): the first of :data:`K8A_GEOMETRIES` whose grid puts at least
    two CTAs on every SM, else the last (the most CTAs).  Else one column
    a thread in blocks of 256."""
    if not vec:
        return 1, 256
    for V, nt in K8A_GEOMETRIES:
        if -(-M * (H // V) // nt) >= 2 * sms:
            return V, nt
    return K8A_GEOMETRIES[-1]


def _vec4(H: int, *ts: torch.Tensor) -> bool:
    """True where K8a's 4-wide vectors fit: ``H``, every row stride and
    every base address on a multiple of 4 elements."""
    return H % 4 == 0 and all(
        t.stride(0) % 4 == 0 and t.data_ptr() % (4 * t.element_size()) == 0
        for t in ts)


def no_vjp(op: str, reference: str) -> str:
    """The message of a kernel's backward, which the reference lacks."""
    return (f"{op}: the kernel runs forward only -- the reference's Pallas "
            f"kernel ({reference}) has no VJP.  Differentiate through "
            f"cell_impl='jnp', or through the fused megastep leg "
            f"(fusion_mode='auto').")


def check_view(op: str, name: str, t: torch.Tensor, shape,
               device: torch.device, dtype=None) -> None:
    """Raise unless argument ``name`` of kernel ``op`` has this shape and
    device, a type the kernels take (``dtype`` if given), unit stride in
    its last dimension and strides that fit an ``int``: the kernels read a
    strided view in place, through its strides, so no copy is made."""
    if t.dtype not in DTYPES or (dtype is not None and t.dtype != dtype):
        want = dtype if dtype is not None else "float32 or bfloat16"
        raise TypeError(f"{op}: {name} must be {want}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, the first "
                         f"operand on {device}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{op}: {name} needs unit stride in its last "
                         f"dimension, got strides {t.stride()}")
    if any(s < 0 or s > _INT_MAX for s in t.stride()):
        raise ValueError(f"{op}: {name} has strides {t.stride()} outside "
                         f"0..2^31-1")


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


class _LSTMGates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates: torch.Tensor, c_prev: torch.Tensor):
        M, H = c_prev.shape
        c = torch.empty((M, H), dtype=gates.dtype, device=gates.device)
        h = torch.empty_like(c)
        if M and H:
            V, nt = k8a_geometry(M, H, lm._sm_count(gates.device),
                                 _vec4(H, gates, c_prev, c, h))
            launch_kernel("lstm_gates", gates.device, c.data_ptr(),
                          h.data_ptr(), gates.data_ptr(), c_prev.data_ptr(),
                          M, H, gates.stride(0), c_prev.stride(0),
                          _is_bf16(gates), _is_bf16(c_prev), V, nt)
        return c, h

    @staticmethod
    def backward(ctx, g_c, g_h):
        raise NotImplementedError(no_vjp(
            "lstm_gates", "src/repro/kernels/cell_kernels.py:46"))


def lstm_gates(gates: torch.Tensor, c_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM gate chain (K8a): ``gates`` ``[M, 4H]`` (``i|f|o|u``
    pre-activations), ``c_prev`` ``[M, H]`` (may be a strided view, and of
    another type) → ``(c, h)``, each a new ``[M, H]`` tensor at
    ``gates.dtype``; the forget gate adds +1.0."""
    op = "lstm_gates"
    require_cuda(op, gates)
    if gates.dim() != 2 or gates.shape[1] % 4:
        raise ValueError(f"{op}: gates must be [M, 4H], got "
                         f"{tuple(gates.shape)}")
    M, H = gates.shape[0], gates.shape[1] // 4
    check_view(op, "gates", gates, (M, 4 * H), gates.device)
    check_view(op, "c_prev", c_prev, (M, H), gates.device)
    return _LSTMGates.apply(gates, c_prev)


class _TreeLSTMGates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, i_pre, f_pre, o_pre, u_pre, c_k, child_mask):
        M, A, H = f_pre.shape
        c = torch.empty((M, H), dtype=i_pre.dtype, device=i_pre.device)
        h = torch.empty_like(c)
        if M and H:
            launch_kernel(
                "treelstm_gates", i_pre.device, c.data_ptr(), h.data_ptr(),
                i_pre.data_ptr(), f_pre.data_ptr(), o_pre.data_ptr(),
                u_pre.data_ptr(), c_k.data_ptr(), child_mask.data_ptr(),
                M, A, H, i_pre.stride(0), o_pre.stride(0), u_pre.stride(0),
                *f_pre.stride()[:2], *c_k.stride()[:2],
                *child_mask.stride(), _is_bf16(i_pre), _is_bf16(c_k))
        return c, h

    @staticmethod
    def backward(ctx, g_c, g_h):
        raise NotImplementedError(no_vjp(
            "treelstm_gates", "src/repro/kernels/cell_kernels.py:86"))


def treelstm_gates(i_pre: torch.Tensor, f_pre: torch.Tensor,
                   o_pre: torch.Tensor, u_pre: torch.Tensor,
                   c_k: torch.Tensor, child_mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The child-sum Tree-LSTM gate chain (K8b).  ``i_pre/o_pre/u_pre``:
    ``[M, H]``; ``f_pre``: ``[M, A, H]``, all of one type; ``c_k``:
    ``[M, A, H]`` and ``child_mask``: ``[M, A]``, both of the node
    buffer's type (strided views welcome) → ``(c, h)``, each a new
    ``[M, H]`` tensor at ``i_pre.dtype``.  The children are summed in the
    order ``a = 0..A-1``."""
    op = "treelstm_gates"
    require_cuda(op, i_pre)
    if f_pre.dim() != 3:
        raise ValueError(f"{op}: f_pre must be [M, A, H], got "
                         f"{tuple(f_pre.shape)}")
    M, A, H = f_pre.shape
    if A < 1:
        raise ValueError(f"{op}: needs at least one child slot, got A={A}")
    dev, pre = i_pre.device, i_pre.dtype
    for name, t in (("i_pre", i_pre), ("o_pre", o_pre), ("u_pre", u_pre)):
        check_view(op, name, t, (M, H), dev, pre)
    check_view(op, "f_pre", f_pre, (M, A, H), dev, pre)
    check_view(op, "c_k", c_k, (M, A, H), dev)
    check_view(op, "child_mask", child_mask, (M, A), dev, c_k.dtype)
    return _TreeLSTMGates.apply(i_pre, f_pre, o_pre, u_pre, c_k, child_mask)
