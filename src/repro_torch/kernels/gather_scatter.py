"""Row gather and row scatter: the Cavs ``gather``/``scatter`` memcpy
primitives (§4 Backend), one hand-written CUDA launch each.

Port of ``repro.kernels.gather_scatter`` (K6):

  :func:`gather_rows`  — ``out[i] = src[idx[i]]`` (K6a), the ids on the
    host and carried in the launch itself, each row stored to ``out`` on
    the card and, optionally, into a page-locked host buffer;
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

import ctypes
import functools
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.level_megastep import (check_arg, launch_kernel,
                                                require_cuda)

#: Element types the kernels copy.
DTYPES = (torch.float32, torch.bfloat16)

#: Ids one K6a launch carries in its parameters (``GATHER_CAP`` of
#: ``csrc/gather_scatter.cu``); more take one launch per this many.
GATHER_CAP = 512


def _check_rows(op: str, name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.dtype not in DTYPES:
        raise TypeError(f"{op}: {name} must be a 2-D float32 or bfloat16 "
                        f"tensor, got {t.dtype} of shape {tuple(t.shape)}")


def host_ids(op: str, idx: Union[torch.Tensor, np.ndarray]) -> np.ndarray:
    """``idx`` as a contiguous 1-D int32 array on the host.  Ids on a
    device raise ``TypeError``: K6a takes them by value, and copying them
    back would cost the sync it removes."""
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise TypeError(f"{op}: idx must lie on the host (the kernel "
                            f"takes the ids by value), got one on "
                            f"{idx.device}")
        idx = idx.numpy()
    if idx.dtype != np.int32 or idx.ndim != 1:
        raise TypeError(f"{op}: idx must be a 1-D int32 array, got "
                        f"{idx.dtype} of shape {idx.shape}")
    return np.ascontiguousarray(idx)


def host_rows(n: int, D: int, dtype: torch.dtype,
              pinned: bool) -> torch.Tensor:
    """An ``[n, D]`` host buffer for :func:`gather_rows`' ``host_out``:
    page-locked (so mapped into the card's address space) when
    ``pinned``."""
    return torch.empty((n, D), dtype=dtype, pin_memory=pinned)


def host_pointer(op: str, t: torch.Tensor) -> int:
    """The card's address of the page-locked host tensor ``t``
    (``cudaHostGetDevicePointer`` of its block, plus its offset); raises
    unless ``t`` is pinned and mapped."""
    if t.device.type != "cpu" or not t.is_pinned():
        raise ValueError(f"{op}: host_out must be a page-locked host "
                         f"tensor (pin_memory=True), got one on {t.device}")
    base = t.untyped_storage().data_ptr()
    dev = ctypes.c_void_p()
    rc = _build.load("host_device_pointer")(base, ctypes.byref(dev))
    if rc != 0 or not dev.value:
        raise RuntimeError(f"{op}: host_out is not mapped into the card's "
                           f"address space (CUDA error {rc})")
    return dev.value + (t.data_ptr() - base)


def gather_rows(src: torch.Tensor, idx: Union[torch.Tensor, np.ndarray], *,
                host_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` (K6a).  ``src``: ``[R, D]`` float32 or
    bfloat16 on the card; ``idx``: ``[n]`` int32 ids in ``[0, R)`` ON THE
    HOST (a CPU tensor or a numpy array; the kernel writes a zero row for
    an id outside), carried in the launch: ``GATHER_CAP`` a launch.
    ``host_out``: a page-locked ``[>= n, D]`` host tensor of ``src``'s
    type, whose first ``n`` rows get the same bits as ``out`` once the
    stream has passed the launch.  Returns a new ``[n, D]`` tensor on the
    card."""
    op = "gather_rows"
    require_cuda(op, src)
    _check_rows(op, "src", src)
    R, D = src.shape
    dev = src.device
    check_arg(op, "src", src, src.dtype, (R, D), dev)
    ids = host_ids(op, idx)
    n = ids.shape[0]
    out = torch.empty((n, D), dtype=src.dtype, device=dev)
    host, host_stride = 0, 0
    if host_out is not None:
        if (host_out.dtype != src.dtype or host_out.dim() != 2
                or host_out.shape[0] < n or host_out.shape[1] != D
                or not host_out.is_contiguous()):
            raise ValueError(f"{op}: host_out must be a contiguous "
                             f"[>= {n}, {D}] {src.dtype} tensor, got "
                             f"{host_out.dtype} of shape "
                             f"{tuple(host_out.shape)}")
        host, host_stride = host_pointer(op, host_out), host_out.stride(0)
    if not D:
        return out
    es = src.element_size()
    for c in range(0, n, GATHER_CAP):
        k = min(GATHER_CAP, n - c)
        launch_kernel(op, dev, out.data_ptr() + c * out.stride(0) * es,
                      host + c * host_stride * es if host else None,
                      src.data_ptr(), ids[c:].ctypes.data, k, R, D, es,
                      out.stride(0), src.stride(0), host_stride)
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
