"""Gradient compression, the single-process part (port of
``repro.dist.compress`` without the cross-pod collectives
``cross_pod_mean_int8*``, which wait for the port's mesh: ROADMAP.md
queue 1, item 4).

Int8 symmetric fake-quantization plus error feedback (EF): the residual
``e_t = g_t + e_{t-1} - Q(g_t + e_{t-1})`` is carried across steps, so
the *sum* of emitted gradients converges to the true sum (the EF
guarantee) while naive per-step quantization accumulates bias.  Trees
are nested dicts of tensors, as the optimizer's.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_map


def fake_quant(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantize→dequantize (max error ``amax/254`` + ulp)."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return (q.to(x.dtype) * scale).to(x.dtype)


def compress_tree(tree: Any) -> Any:
    """Quantize→dequantize every leaf (what the wire would carry)."""
    return tree_map(fake_quant, tree)


class ErrorFeedback:
    """Carries the per-leaf quantization residual across steps.

    ``apply`` returns ``(compressed, new_state)`` and leaves this state
    as it was."""

    def __init__(self, residual: Any):
        self.residual = residual

    @classmethod
    def init(cls, tree: Any) -> "ErrorFeedback":
        return cls(tree_map(torch.zeros_like, tree))

    def apply(self, tree: Any) -> Tuple[Any, "ErrorFeedback"]:
        out, new_res = ef_apply(tree, self.residual)
        return out, ErrorFeedback(new_res)


def ef_apply(tree: Any, residual: Any) -> Tuple[Any, Any]:
    """Tree-level local EF step: ``(emitted, new_residual)``, both new
    tensors (``residual`` is not written).

    No collective — the single-replica trainer leg, where the "wire" is
    just the optimizer update.
    """
    acc = tree_map(torch.add, tree, residual)
    emitted = tree_map(fake_quant, acc)
    return emitted, tree_map(torch.sub, acc, emitted)
