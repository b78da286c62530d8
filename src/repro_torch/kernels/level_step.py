"""The fused LSTM level step: the recurrent product and the gate chain of
one batching task in one hand-written CUDA launch (K9).

Port of ``repro.kernels.level_step``.  A batching task of an LSTM cell is

    gates = ext_proj + h_prev · W_h + b        (the recurrent product)
    i, f, o, u = split(gates);  c, h = cell(...)

and the op-by-op leg with ``cell_impl="pallas"`` writes ``gates`` to
device memory between the product and the gate kernel (K8a).
:func:`lstm_level_fused` keeps them in registers: in
``csrc/cell_megastep_sm90.cu`` it runs K3's product (the gathered product
of ``csrc/gathered_product.cuh``: TF32 tensor cores with the 3xTF32
split, the depth split over a cluster sized by
``level_megastep.cell_split``) and K3's LSTM epilogue; the source's
header states the bound and the design.  Unlike K3 it neither gathers the
predecessor rows nor writes the level's block: it reads the gathered
halves ``h_prev``/``c_prev`` in place (strided views, float32 or bf16;
bf16 rows are staged raw and widened at the fragment load, two TF32
products a k-step) and returns ``(c, h)`` as new tensors.

The wrapper takes CUDA tensors only: it launches the kernel or raises.
The plain version for CPU tensors (``ref.lstm_level_fused``) is chosen
in :mod:`repro_torch.kernels.ops`.  Each launch is counted in
``level_megastep.LAUNCHES``; an empty level launches nothing.  Forward
only, as in the reference (no VJP): a backward raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.cell_kernels import check_view, no_vjp
from repro_torch.kernels.level_megastep import (_sm_count, cell_split,
                                                check_arg, launch_kernel,
                                                require_cuda)


class _LSTMLevelFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_prev, c_prev, ext_proj, wh, b):
        M, H = h_prev.shape
        c = torch.empty((M, H), dtype=h_prev.dtype, device=h_prev.device)
        h = torch.empty_like(c)
        if M and H:
            launch_kernel("lstm_level_fused", h_prev.device, c.data_ptr(),
                          h.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
                          ext_proj.data_ptr(), wh.data_ptr(), b.data_ptr(),
                          M, H, h_prev.stride(0), c_prev.stride(0),
                          ext_proj.stride(0),
                          int(h_prev.dtype == torch.bfloat16),
                          cell_split(M, H, _sm_count(h_prev.device)))
        return c, h

    @staticmethod
    def backward(ctx, g_c, g_h):
        raise NotImplementedError(no_vjp(
            "lstm_level_fused", "src/repro/kernels/level_step.py:53"))


def lstm_level_fused(h_prev: torch.Tensor, c_prev: torch.Tensor,
                     ext_proj: torch.Tensor, wh: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM batching task, fully fused (K9).  ``h_prev``/``c_prev``:
    ``[M, H]`` gathered predecessor states, float32 or bf16 (one type;
    strided views welcome); ``ext_proj``: ``[M, 4H]`` float32 hoisted
    ``W_x·x`` rows; ``wh``: ``[H, 4H]`` and ``b``: ``[4H]``, float32 and
    contiguous → ``(c, h)``, each a new ``[M, H]`` tensor at
    ``h_prev.dtype``."""
    op = "lstm_level_fused"
    require_cuda(op, h_prev)
    if h_prev.dim() != 2:
        raise ValueError(f"{op}: h_prev must be [M, H], got "
                         f"{tuple(h_prev.shape)}")
    M, H = h_prev.shape
    dev = h_prev.device
    check_view(op, "h_prev", h_prev, (M, H), dev)
    check_view(op, "c_prev", c_prev, (M, H), dev, h_prev.dtype)
    check_view(op, "ext_proj", ext_proj, (M, 4 * H), dev, torch.float32)
    check_arg(op, "wh", wh, torch.float32, (H, 4 * H), dev)
    check_arg(op, "b", b, torch.float32, (4 * H,), dev)
    return _LSTMLevelFused.apply(h_prev, c_prev, ext_proj, wh, b)
