"""Row gather and row scatter: the Cavs ``gather``/``scatter`` memcpy
primitives (§4 Backend), one hand-written CUDA launch each.

Port of ``repro.kernels.gather_scatter`` (K6):

  :func:`gather_rows`  — ``out[i] = src[idx[i]]`` (K6a);
  :func:`scatter_rows` — ``dst[idx[i]] = rows[i]`` in place, ids unique,
    an id outside ``[0, R)`` dropped (K6b).

Both live in ``csrc/gather_scatter.cu``, whose header states the bound
and the design; :mod:`repro_torch.kernels._build` compiles it with
``nvcc`` for ``sm_90a`` on first use.  They copy rows of bf16 or fp32
elements exactly, so on the card they equal their plain versions
(``ref.gather_rows``/``ref.scatter_rows``) bit for bit.

The wrappers take CUDA tensors only: they launch the kernel or raise.
The plain version for CPU tensors is chosen in
:mod:`repro_torch.kernels.ops`.  Each launch is counted in
``level_megastep.LAUNCHES`` under the kernel's name, and a call with no
rows launches nothing.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.level_megastep import (check_arg, launch_kernel,
                                                require_cuda)

#: Element types the kernels copy.
DTYPES = (torch.float32, torch.bfloat16)


def _check_rows(op: str, name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.dtype not in DTYPES:
        raise TypeError(f"{op}: {name} must be a 2-D float32 or bfloat16 "
                        f"tensor, got {t.dtype} of shape {tuple(t.shape)}")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` (K6a).  ``src``: ``[R, D]`` float32 or
    bfloat16; ``idx``: ``[n]`` int32 in ``[0, R)`` (the caller's
    contract: the kernel writes a zero row for an index outside).
    Returns a new ``[n, D]`` tensor."""
    op = "gather_rows"
    require_cuda(op, src)
    _check_rows(op, "src", src)
    R, D = src.shape
    n = idx.shape[0]
    dev = src.device
    _check = functools.partial(check_arg, op)
    _check("src", src, src.dtype, (R, D), dev)
    _check("idx", idx, torch.int32, (n,), dev)
    out = torch.empty((n, D), dtype=src.dtype, device=dev)
    if n and D:
        launch_kernel(op, dev, out.data_ptr(), src.data_ptr(),
                      idx.data_ptr(), n, R, D, src.element_size(),
                      out.stride(0), src.stride(0))
    return out


def scatter_rows(dst: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``dst[idx[i]] = rows[i]``, IN PLACE (K6b).  ``dst``: ``[R, D]``
    float32 or bfloat16; ``idx``: ``[n]`` int32, unique, an id outside
    ``[0, R)`` dropped (a pad lane); ``rows``: ``[n, D]`` of ``dst``'s
    type.  Rows no id names keep their bits.  Returns ``dst``."""
    op = "scatter_rows"
    require_cuda(op, dst)
    _check_rows(op, "dst", dst)
    R, D = dst.shape
    n = idx.shape[0]
    dev = dst.device
    _check = functools.partial(check_arg, op)
    _check("dst", dst, dst.dtype, (R, D), dev)
    _check("idx", idx, torch.int32, (n,), dev)
    _check("rows", rows, dst.dtype, (n, D), dev)
    if n and D:
        launch_kernel(op, dev, dst.data_ptr(), rows.data_ptr(),
                      idx.data_ptr(), n, R, D, dst.element_size(),
                      dst.stride(0), rows.stride(0))
    return dst
