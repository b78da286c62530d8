"""Backend dispatch for the kernel layer (port of the part of
``repro.kernels.ops`` the serving path needs).

Dispatch goes by the device of the tensors, never by a silent fallback:

  - a CPU tensor → the plain PyTorch version (``ref.py``);
  - a CUDA tensor → the hand-written kernel, which launches or raises;
    a kind or dtype with no kernel raises too.

This is the only place that makes the choice: the kernel's wrapper
(``level_megastep.treelstm_megastep``) takes CUDA tensors only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import level_megastep as lm
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
    if kind != "treelstm":
        raise NotImplementedError(
            f"no CUDA kernel for megastep kind {kind!r} yet")
    _tick("level_megastep", "cuda")
    ui, uf, uo, uu, b = weights
    return lm.treelstm_megastep(buf, child_ids, ext_ids, node_mask, offset,
                                ext, ui, uf, uo, uu, b)
