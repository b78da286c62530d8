"""Gradient accumulation over microbatches (port of ``repro.optim.accum``).

The batch's leading axis is cut into ``n_micro`` equal slices; each
slice's loss is differentiated on its own and the gradients are summed
in float32, so a batch too large for one backward trains in pieces with
the mean gradient of the whole.

``loss_fn(params, batch) -> (loss, metrics)`` is differentiated the way
the Tree-LSTM example does it: on detached leaves that share storage
with ``params``, so views (the packed ``ui|uf|uo|uu`` recurrent weight)
stay views and the fused kernels still take them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_map

Params = Any
Batch = Dict[str, Any]


def _value_and_grad(loss_fn: Callable[[Params, Batch], Tuple[Any, Dict]],
                   params: Params, batch: Batch
                   ) -> Tuple[torch.Tensor, Params, Dict[str, Any]]:
    """``(loss, grads, metrics)`` of one call of ``loss_fn``; a param the
    loss does not reach gets a zero gradient.  Loss and metrics come
    back detached."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(leaves, batch)
    flat = tree_leaves(leaves)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, gs)}
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), tree_map(lambda p: by_leaf[id(p)], leaves), metrics


def _slices(x: Any, n_micro: int):
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        raise TypeError(f"microbatching slices tensors and arrays on their "
                        f"leading axis, not {type(x).__name__}")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"leading dim {b} is not divisible by "
                         f"n_micro={n_micro}")
    m = b // n_micro
    return [x[i * m:(i + 1) * m] for i in range(n_micro)]


def microbatch_grads(loss_fn: Callable[[Params, Batch], Tuple[Any, Dict]],
                     params: Params, batch: Batch, n_micro: int,
                     grad_specs: Any = None,
                     ) -> Tuple[torch.Tensor, Params, Dict[str, Any]]:
    """Mean loss + mean gradients over ``n_micro`` slices of the batch.

    ``batch`` values must be tensors or arrays whose leading dim is
    divisible by ``n_micro``; with ``n_micro`` 1 they may be anything
    ``loss_fn`` takes (a ``DeviceSchedule``).  Gradients and metrics are
    summed in float32 and divided by ``n_micro``.

    ``grad_specs`` constrains gradients to a mesh's param sharding in
    the JAX package; the port has no mesh yet (ROADMAP.md queue 1, item
    4), so only ``None`` is taken.
    """
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs shards gradients over a mesh, which the port does "
            "not have yet: see ROADMAP.md queue 1, item 4")
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)
    parts = {k: _slices(v, n_micro) for k, v in batch.items()}
    gsum = lsum = msum = None
    for i in range(n_micro):
        loss, grads, metrics = _value_and_grad(
            loss_fn, params, {k: v[i] for k, v in parts.items()})
        grads = tree_map(lambda g: g.float(), grads)
        metrics = {k: torch.as_tensor(v, dtype=torch.float32)
                   for k, v in metrics.items()}
        if gsum is None:
            gsum, lsum, msum = grads, loss, metrics
        else:
            gsum = tree_map(torch.add, gsum, grads)
            lsum = lsum + loss
            msum = {k: msum[k] + v for k, v in metrics.items()}
    inv = 1.0 / n_micro
    return (lsum * inv, tree_map(lambda g: g * inv, gsum),
            {k: v * inv for k, v in msum.items()})
