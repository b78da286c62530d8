"""The reverse level-megastep and the duplicate-safe row scatter-add: the
hand-written CUDA kernels of the backward.

Port of ``repro.kernels.level_megastep_bwd``:

  :func:`bwd_megastep` — one reverse batching task of any megastep kind:
    re-gather the child rows from the residual node buffer, recompute the
    gates, run the cotangent math of ``level_megastep.level_bwd`` and
    scatter-ADD the child-row cotangents into the gradient buffer
    (∂gather = scatter-add, §3.4), IN PLACE — the counterpart of the
    Pallas kernel's ``input_output_aliases``.  Every kind is
    ``csrc/bwd_megastep_sm90.cu``: both products on the TF32 tensor
    cores (3xTF32), the depth split over a thread-block cluster sized by
    :func:`k2_split`, the grid over the level's live slots; two launches
    a level, three on a level where a row has several contributions, none
    on a level with no live slot (its header).
    ``LAUNCHES["<kind>_bwd_megastep"]`` counts levels that launched,
    ``LAUNCHES["<kind>_bwd_megastep.cuda_launches"]`` their CUDA
    launches.
  :func:`scatter_add_rows` (``csrc/scatter_add_rows.cu``) —
    ``dst[idx[i]] += rows[i]`` with repeats, in place, no float atomics,
    along a per-schedule plan (``core.structure.ScatterPlan``); one
    count in ``LAUNCHES["scatter_add_rows"]`` a call (an add launch and,
    where a destination's run is split, a combine launch).

Both take CUDA tensors only: they launch the kernel or raise.  The
choice of the plain version for CPU tensors is made once, in
:mod:`repro_torch.kernels.ops`.  Neither synchronises the card when
given its plan (a schedule's, built once by ``to_device``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.structure import ScatterPlan, level_bwd_plan
from repro_torch.kernels.level_megastep import (K2_BK, K2_BM, LAUNCHES,
                                                MAX_ARITY, _sm_count,
                                                cell_hidden, check_arg,
                                                k2_split, launch_kernel,
                                                packed_recurrent,
                                                require_cuda, widths)


#: The scatter-add's workspace rows (one a chunk of a split run) are ``D``
#: rounded up to a multiple of this (``kNarrow`` in
#: ``csrc/scatter_add_rows.cu``).
SCATTER_STRIPE = 128


#: K2's tiles are ``K2_BM`` slots, its chunks ``K2_BK`` deep, the
#: gathered product's (``level_megastep``); by kind, the hidden columns a
#: pass (a) tile, the output columns a pass (b) tile, and pass (b)'s depth
#: in segments of H (``Cfg`` in ``csrc/bwd_megastep_sm90.cu``).
K2_BJ = {"treelstm": 16, "lstm": 16, "gru": 16, "treefc": 64}
K2_BN = {"treelstm": 32, "lstm": 64, "gru": 64, "treefc": 64}
K2_SEGS = {"treelstm": 4, "lstm": 4, "gru": 3, "treefc": 1}
#: Warps a CTA of pass (a) by kind, and of pass (b) (``Cfg::NTA``,
#: ``Cfg::NTB`` there).
K2_WARPS_A = {"treelstm": 8, "lstm": 4, "gru": 4, "treefc": 4}
K2_WARPS_B = 8


def k2_grid(kind: str, live: int, A: int, H: int):
    """``((tiles, chunks, warps), (tiles, chunks, warps))`` of K2's two
    passes over a level with ``live`` live slots: the CTA tiles of a pass,
    the chunks of ``K2_BK`` along its depth (segments of H, each cut into
    ``ceil(H / K2_BK)`` chunks: pass (a) has one, treefc's A, one a
    child; pass (b) ``K2_SEGS``), and the warps of its CTAs."""
    rows = -(-live // K2_BM)
    cps = -(-H // K2_BK)
    cols_b = A * H if kind == "treefc" else H
    return ((rows * -(-H // K2_BJ[kind]),
             (A if kind == "treefc" else 1) * cps, K2_WARPS_A[kind]),
            (rows * -(-cols_b // K2_BN[kind]), K2_SEGS[kind] * cps,
             K2_WARPS_B))


def k2_splits(kind: str, live: int, A: int, H: int, sms: int) -> tuple:
    """The depth splits of K2's two passes over a level with ``live``
    live slots, on a card of ``sms`` SMs."""
    return tuple(k2_split(tiles, chunks, sms, warps)
                 for tiles, chunks, warps in k2_grid(kind, live, A, H))


def workspace_numel(kind: str, M: int, A: int, H: int) -> int:
    """Floats of the reverse megastep's workspace for levels of ``M``
    slots of kind ``kind``:

      - ``treelstm``: ``d_i|d_o|d_u`` ``[M, 3H]``, each child's ``d_f``
        ``[M·A, H]`` and the child cotangents ``[M·A, 2H]``;
      - ``lstm``: ``d_gates`` ``[M, 4H]`` and the predecessor cotangent
        ``[M, 2H]``;
      - ``gru``: the recurrent cotangent ``[M, 3H]`` and the predecessor
        cotangent ``[M, H]``;
      - ``treefc``: ``d_pre`` ``[M, H]`` and the child cotangents
        ``[M·A, H]``.

    The child cotangents are written only on a level where a row has
    several contributions (elsewhere the kernel adds them into ``g``;
    gru's rows hold ``g_h * z`` between its passes); the depth split's
    partial sums live in the cluster's shared memory, not here.
    """
    per_slot = {"treelstm": 3 + 3 * A, "lstm": 4 + 2, "gru": 3 + 1,
                "treefc": 1 + A}
    if kind not in per_slot:
        raise ValueError(f"unknown megastep gate kind: {kind!r}")
    return M * per_slot[kind] * H


def bwd_workspace(kind: str, M: int, A: int, H: int,
                  device) -> torch.Tensor:
    """One workspace for every level of a backward (allocated once)."""
    return torch.empty(workspace_numel(kind, M, A, H), dtype=torch.float32,
                       device=device)


def bwd_megastep(kind: str, g: torch.Tensor, buf: torch.Tensor,
                 child_ids: torch.Tensor, ext_ids: torch.Tensor,
                 node_mask: torch.Tensor, offset: int, ext: torch.Tensor,
                 weights: Tuple[torch.Tensor, ...], *,
                 sort_perm: Optional[torch.Tensor],
                 sorted_child_ids: Optional[torch.Tensor],
                 run_head: Optional[torch.Tensor],
                 workspace: Optional[torch.Tensor] = None,
                 live: Optional[int] = None, single: Optional[bool] = None,
                 heads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused reverse batching task of kind ``kind``, in place.

    ``g``: ``[T*M+1, S]`` float32 gradient buffer; the child-row
    cotangents of the level at ``offset`` are scatter-ADDED into it.
    ``buf``: the residual forward node buffer (read only); ``child_ids``
    ``[M, A]`` int32 (absent children at the sentinel row ``T*M``, from
    which the child mask is derived); ``ext``: ``[R+1, G]``; ``weights``:
    the cell's ``GateSpec.weights``.  ``sort_perm`` / ``sorted_child_ids``
    / ``run_head``: the level's flat ``[M·A]`` sorted runs, which
    ``pack_batch(with_runs=True)`` precomputes (absent: raises).
    ``workspace``: see :func:`bwd_workspace`; allocated here when omitted.
    ``live`` / ``single`` / ``heads``: the level's
    :func:`~repro_torch.core.structure.level_bwd_plan` (``DeviceSchedule.
    live`` / ``bwd_single`` / ``bwd_heads``, host values but
    ``heads``, on ``g``'s device).  Without them the plan is built here
    from ``child_ids`` and ``sorted_child_ids`` copied to the host, which
    waits for the card.  A level with no live slot launches nothing.
    Rows ``[offset, offset+M)``, the sentinel and every row no child
    points at come out bit-unchanged.  Returns ``g``.
    """
    if kind not in ("treelstm", "lstm", "gru", "treefc"):
        raise ValueError(f"unknown megastep gate kind: {kind!r}")
    op = f"{kind}_bwd_megastep"
    require_cuda(op, g)
    if sort_perm is None or sorted_child_ids is None or run_head is None:
        raise ValueError(f"{op}: the level's sorted runs are missing; pack "
                         f"the schedule with pack_batch(with_runs=True)")
    M, A = child_ids.shape
    if kind == "treelstm":
        ui, uf, uo, uu, b = weights
        H = ui.shape[0]
        w = packed_recurrent(ui, uf, uo, uu)
    else:
        w, b = weights
        H = cell_hidden(kind, w, A)
    S, G = widths(kind, H)
    w_shape = (A * H, H) if kind == "treefc" else (H, G)
    R = g.shape[0]
    dev = g.device
    check = functools.partial(check_arg, op)
    check("g", g, torch.float32, (R, S), dev)
    check("buf", buf, torch.float32, (R, S), dev)
    check("child_ids", child_ids, torch.int32, (M, A), dev)
    check("ext_ids", ext_ids, torch.int32, (M,), dev)
    check("node_mask", node_mask, torch.float32, (M,), dev)
    check("ext", ext, torch.float32, (ext.shape[0], G), dev)
    check("w", w, torch.float32, w_shape, dev)
    check("b", b, torch.float32, (G,), dev)
    for name, t in (("sort_perm", sort_perm),
                    ("sorted_child_ids", sorted_child_ids),
                    ("run_head", run_head)):
        check(name, t, torch.int32, (M * A,), dev)
    need = workspace_numel(kind, M, A, H)
    if workspace is None:
        workspace = bwd_workspace(kind, M, A, H, dev)
    if workspace.numel() < need:
        raise ValueError(f"{op}: workspace of {workspace.numel()} floats, "
                         f"needs {need}")
    check("workspace", workspace, torch.float32, workspace.shape, dev)
    if not 1 <= A <= MAX_ARITY:
        raise NotImplementedError(f"{op}: arity {A} outside 1..{MAX_ARITY}")
    offset = int(offset)
    if offset < 0 or offset + M > R - 1:
        raise ValueError(f"{op}: rows [{offset}, {offset + M}) outside a "
                         f"buffer of {R} rows with its sentinel")
    if live is None or single is None or (not single and heads is None):
        live, single, h = level_bwd_plan(
            child_ids.cpu().numpy(), R - 1,
            sorted_child_ids.cpu().numpy())
        heads = None if h is None else torch.from_numpy(h).to(dev)
    live, single = int(live), bool(single)
    if not 0 <= live <= M:
        raise ValueError(f"{op}: live={live} outside [0, {M}]")
    nruns = 0
    if not single:
        if heads is None or heads.dim() != 1 or heads.shape[0] < 2:
            raise ValueError(f"{op}: a level with several contributions "
                             f"to a row needs its run heads")
        check("heads", heads, torch.int32, heads.shape, dev)
        nruns = heads.shape[0] - 1
    if live == 0:
        return g
    split_a, split_b = k2_splits(kind, live, A, H, _sm_count(dev))
    n = ctypes.c_int(0)
    launch_kernel(op, dev, g.data_ptr(), buf.data_ptr(), child_ids.data_ptr(),
                  ext_ids.data_ptr(), node_mask.data_ptr(), ext.data_ptr(),
                  w.data_ptr(), b.data_ptr(), sort_perm.data_ptr(),
                  sorted_child_ids.data_ptr(),
                  None if single else heads.data_ptr(),
                  workspace.data_ptr(), M, A, H, offset, R - 1, g.stride(0),
                  buf.stride(0), ext.stride(0), live, int(single), nruns,
                  split_a, split_b, ctypes.addressof(n))
    LAUNCHES[f"{op}.cuda_launches"] += n.value
    return g


def scatter_add_rows(dst: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor, *,
                     plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """``dst[idx[i]] += rows[i]`` in place, duplicates accumulating in a
    fixed order (no float atomics).  ``dst``: ``[R, D]`` float32, rows
    possibly strided; ``idx``: ``[n]`` int32, every entry in ``[0, R)`` —
    masked rows arrive as zero rows aimed at a sentinel, and nothing is
    dropped; ``rows``: ``[n, D]`` float32.  Rows no index points at come
    out bit-unchanged.  Returns ``dst``.

    ``plan``: ``idx``'s :class:`~repro_torch.core.structure.ScatterPlan`
    on ``dst``'s device, which the kernel reads instead of ``idx`` (the
    scheduler passes the schedule's, built once by ``to_device``).
    Without one it is built here: ``idx`` is copied to the host, which
    waits for the card, and sorted there, O(n log n) — the cost the plan
    exists to take out of the step.  The sum of each destination row is
    its chunks' sums (each in increasing ``i``) and, for a row whose run
    is split, the chunk sums grouped as ``run_combine_kernel`` does
    (``ref.scatter_add_rows_planned`` is that order in plain PyTorch)."""
    op = "scatter_add_rows"
    require_cuda(op, dst)
    if dst.dim() != 2:
        raise ValueError(f"{op}: dst must be [R, D], got {tuple(dst.shape)}")
    R, D = dst.shape
    n = idx.shape[0]
    dev = dst.device
    check = functools.partial(check_arg, op)
    check("idx", idx, torch.int32, (n,), dev)
    for name, t, shape in (("dst", dst, (R, D)), ("rows", rows, (n, D))):
        _check_rows(op, name, t, shape, dev)
    if n == 0:
        return dst
    if plan is None:
        plan = ScatterPlan.build(idx, dev)
    if plan.n != n or plan.device != dev or plan.rows > R:
        raise ValueError(f"{op}: the plan is of {plan.n} indices up to row "
                         f"{plan.rows - 1} on {plan.device}; the call has "
                         f"{n} into {R} rows on {dev}")
    stripes = -(-D // SCATTER_STRIPE)
    partial = torch.empty(plan.split_chunks * stripes * SCATTER_STRIPE,
                          dtype=torch.float32, device=dev)
    launch_kernel(op, dev, dst.data_ptr(), rows.data_ptr(),
                  plan.order.data_ptr(), plan.chunks.data_ptr(),
                  plan.run_start.data_ptr(), partial.data_ptr(),
                  plan.chunks.shape[0], plan.split_chunks,
                  plan.run_start.shape[0] - 1, D, dst.stride(0),
                  rows.stride(0))
    return dst


def _check_rows(op: str, name: str, t: torch.Tensor, shape,
                device: torch.device) -> None:
    """Like ``check_arg``, but the rows may be strided: only the columns
    must be contiguous."""
    if t.dtype != torch.float32:
        raise TypeError(f"{op}: {name} must be torch.float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, dst on {device}")
    if t.numel() > 1 and t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{op}: {name}'s columns must be contiguous")
