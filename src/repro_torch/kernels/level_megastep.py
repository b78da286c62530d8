"""Fused level-megastep: one hand-written CUDA launch per batching task.

Port of ``repro.kernels.level_megastep.treelstm_megastep``.  The CUDA
source is ``csrc/treelstm_megastep.cu`` (its header states the bound and
the design); :mod:`repro_torch.kernels._build` compiles it with ``nvcc``
for ``sm_90a`` on first use.

The launch writes rows ``[offset, offset+M)`` of the node-state buffer
IN PLACE — the counterpart of the Pallas kernel's
``input_output_aliases`` — on PyTorch's current stream, allocating
nothing.  Reads (child rows below ``offset`` and the zero sentinel) never
overlap the written block, which is what makes the in-place write sound.

The wrapper takes CUDA tensors only: it launches the kernel or raises.
The choice of the plain version for CPU tensors is made once, in
:func:`repro_torch.kernels.ops.level_megastep`.  ``LAUNCHES`` counts
kernel launches (and nothing else), so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _build

#: kernel name → launches of that kernel in this process.
LAUNCHES: "collections.Counter[str]" = collections.Counter()

#: Largest arity the kernel is instantiated for.
MAX_ARITY = 4


def reset_launches() -> None:
    LAUNCHES.clear()


def packed_recurrent(ui: torch.Tensor, uf: torch.Tensor, uo: torch.Tensor,
                     uu: torch.Tensor) -> torch.Tensor:
    """The ``[H, 4H]`` (``ui|uf|uo|uu``) weight the kernel reads: a view,
    no copy, of the one packed tensor behind the four.

    The four must be adjacent column views of that tensor, which is what
    ``interop.pack_recurrent`` builds and ``TreeLSTMVertex.init`` and
    ``interop.params_from_jax`` return; anything else raises."""
    H = ui.shape[0]
    adjacent = all(
        w.shape == (H, H) and w.stride() == (4 * H, 1)
        and w.dtype == ui.dtype
        and w.untyped_storage().data_ptr() == ui.untyped_storage().data_ptr()
        and w.storage_offset() == ui.storage_offset() + g * H
        for g, w in enumerate((ui, uf, uo, uu)))
    if not adjacent:
        raise ValueError("treelstm_megastep: ui/uf/uo/uu must be adjacent "
                         "column views of one [H, 4H] tensor; pack them "
                         "with repro_torch.interop.pack_recurrent")
    return torch.as_strided(ui, (H, 4 * H), (4 * H, 1))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"treelstm_megastep: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"treelstm_megastep: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"treelstm_megastep: {name} is on {t.device}, "
                         f"the buffer on {device}")
    if not t.is_contiguous():
        raise ValueError(f"treelstm_megastep: {name} must be contiguous")


def treelstm_megastep(buf: torch.Tensor, child_ids: torch.Tensor,
                      ext_ids: torch.Tensor, node_mask: torch.Tensor,
                      offset: int, ext: torch.Tensor, ui: torch.Tensor,
                      uf: torch.Tensor, uo: torch.Tensor, uu: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """One fused N-ary child-sum Tree-LSTM batching task, in place.

    ``buf``: ``[T*M+1, 2H]`` float32 node-state buffer; ``child_ids``:
    ``[M, A]`` int32 buffer rows (absent children at the zero sentinel);
    ``ext_ids``: ``[M]`` int32 rows of ``ext`` (``[R+1, 4H]``, the hoisted
    projection); ``node_mask``: ``[M]`` float32; ``offset``: first row
    written.  Returns ``buf``.
    """
    if not buf.is_cuda:
        raise ValueError(f"treelstm_megastep: the kernel takes CUDA "
                         f"tensors, got a buffer on {buf.device}")
    M, A = child_ids.shape
    H = ui.shape[0]
    dev = buf.device
    _check("buf", buf, torch.float32, (buf.shape[0], 2 * H), dev)
    _check("child_ids", child_ids, torch.int32, (M, A), dev)
    _check("ext_ids", ext_ids, torch.int32, (M,), dev)
    _check("node_mask", node_mask, torch.float32, (M,), dev)
    _check("ext", ext, torch.float32, (ext.shape[0], 4 * H), dev)
    _check("b", b, torch.float32, (4 * H,), dev)
    w = packed_recurrent(ui, uf, uo, uu)
    _check("packed recurrent weight", w, torch.float32, (H, 4 * H), dev)
    if not 1 <= A <= MAX_ARITY:
        raise NotImplementedError(
            f"treelstm_megastep: arity {A} outside 1..{MAX_ARITY}")
    offset = int(offset)
    if offset < 0 or offset + M > buf.shape[0]:
        raise ValueError(f"treelstm_megastep: rows [{offset}, {offset + M})"
                         f" outside a buffer of {buf.shape[0]} rows")
    launch = _build.load("treelstm_megastep")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = launch(buf.data_ptr(), child_ids.data_ptr(), ext_ids.data_ptr(),
                    node_mask.data_ptr(), ext.data_ptr(), w.data_ptr(),
                    b.data_ptr(), M, A, H, offset, buf.stride(0),
                    ext.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"treelstm_megastep: launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["treelstm_megastep"] += 1
    return buf
