"""Backend dispatch for the kernel layer (port of the part of
``repro.kernels.ops`` the serving and training paths need).

Dispatch goes by the device of the tensors, never by a silent fallback:

  - a CPU tensor → the plain PyTorch version (``ref.py``);
  - a CUDA tensor → the hand-written kernel, which launches or raises;
    a kind or dtype with no kernel raises too.

This is the only place that makes the choice: the kernels' wrappers
(``level_megastep.MEGASTEPS``, ``level_megastep_bwd.bwd_megastep`` and
``level_megastep_bwd.scatter_add_rows``) take CUDA tensors only.  Every
megastep kind (``treelstm``, ``lstm``, ``gru``, ``treefc``) has its
kernels; an unknown kind raises ``ValueError`` on either device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.kernels import ref
from repro_torch.obs.registry import get_registry


def _tick(op: str, impl: str) -> None:
    """Count one dispatch through this layer on the metrics registry
    (``kernel.dispatch{op=...,impl=...}``).  PyTorch runs eagerly, so
    this counts calls, one per level."""
    get_registry().inc("kernel.dispatch", op=op, impl=impl)


def level_megastep(kind: str, buf: torch.Tensor, child_ids: torch.Tensor,
                   child_mask: torch.Tensor, ext_ids: torch.Tensor,
                   node_mask: torch.Tensor, offset: int, ext: torch.Tensor,
                   weights: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """One fused batching task: gather child rows out of ``buf``, run the
    declared gate math, write rows ``[offset, offset+M)`` in place.
    Returns ``buf``.  ``kind``/``weights`` come from the cell's
    ``GateSpec``."""
    if not buf.is_cuda:
        _tick("level_megastep", "ref")
        return ref.level_megastep(kind, buf, child_ids, child_mask, ext_ids,
                                  node_mask, offset, ext, weights)
    kernel = lm.MEGASTEPS.get(kind)
    if kernel is None:
        raise ValueError(f"unknown megastep gate kind: {kind!r}")
    _tick("level_megastep", "cuda")
    return kernel(buf, child_ids, ext_ids, node_mask, offset, ext, *weights)


def bwd_workspace(kind: str, g: torch.Tensor, M: int, A: int,
                  H: int) -> Optional[torch.Tensor]:
    """The reverse megastep's workspace for a backward of kind ``kind``
    over levels of ``M`` slots, allocated once and handed to every
    level's :func:`bwd_megastep`; ``None`` for a CPU gradient buffer (the
    plain version needs none)."""
    return lmb.bwd_workspace(kind, M, A, H, g.device) if g.is_cuda else None


def bwd_megastep(kind: str, g: torch.Tensor, buf: torch.Tensor,
                 child_ids: torch.Tensor, child_mask: torch.Tensor,
                 ext_ids: torch.Tensor, node_mask: torch.Tensor,
                 offset: int, ext: torch.Tensor,
                 weights: Tuple[torch.Tensor, ...], *,
                 sort_perm: Optional[torch.Tensor] = None,
                 sorted_child_ids: Optional[torch.Tensor] = None,
                 run_head: Optional[torch.Tensor] = None,
                 workspace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused reverse batching task: recompute the level's gates from
    the residual node buffer ``buf``, run the cotangent math and
    scatter-ADD the child-row cotangents into the gradient buffer ``g``
    in place (∂gather = scatter-add, §3.4).  Returns ``g``.

    On the card the level's sorted runs (``sort_perm`` /
    ``sorted_child_ids`` / ``run_head``, from ``pack_batch``) are
    required; the plain version ignores them and the workspace."""
    if not g.is_cuda:
        _tick("bwd_megastep", "ref")
        return ref.bwd_megastep(kind, g, buf, child_ids, child_mask,
                                ext_ids, node_mask, offset, ext, weights)
    _tick("bwd_megastep", "cuda")
    return lmb.bwd_megastep(kind, g, buf, child_ids, ext_ids, node_mask,
                            offset, ext, weights, sort_perm=sort_perm,
                            sorted_child_ids=sorted_child_ids,
                            run_head=run_head, workspace=workspace)


def scatter_add_rows(dst: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``dst[idx[i]] += rows[i]`` with repeats, in place, deterministic
    (∂gather = scatter-add, ∂pull = push, §3.4).  Returns ``dst``."""
    if not dst.is_cuda:
        _tick("scatter_add_rows", "ref")
        return ref.scatter_add_rows(dst, idx, rows)
    _tick("scatter_add_rows", "cuda")
    return lmb.scatter_add_rows(dst, idx, rows)
