"""AdamW with decoupled weight decay over nested dicts and lists of
tensors (port of ``repro.optim.adamw``, same defaults: b2 0.95, weight
decay 0.1 on matrices only, clipping at a global norm of 1.0, float32
moments).

Unlike the JAX version, which returns new arrays, :func:`adamw_update`
updates the params and the moments IN PLACE under ``torch.no_grad()``.
That keeps every tensor's storage, so the Tree-LSTM's recurrent weights
stay column views of one packed ``[H, 4H]`` tensor, which the fused
kernels read (``interop.pack_recurrent``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

Params = Any


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of nested dicts, lists and tuples: dict keys in sorted
    order, list and tuple items in theirs (the order of ``jax.tree.leaves``
    on the same structure).  An LM's ``layers`` is a list."""
    return list(_leaves(tree))


def _leaves(tree: Params) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def tree_map(f, tree: Params, *rest: Params) -> Params:
    """``f`` over the leaves of nested dicts, lists and tuples of one
    structure; the result has that structure (a list stays a list)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return f(tree, *rest)


@dataclasses.dataclass
class OptState:
    step: int                # updates taken
    mu: Params               # first moment  (f32, param-shaped)
    nu: Params               # second moment (f32, param-shaped)


def adamw_init(params: Params, moment_dtype=torch.float32) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,  # noqa: E731
                                  device=p.device)
    return OptState(step=0, mu=tree_map(zeros, params),
                    nu=tree_map(zeros, params))


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: OptState, *,
                 lr: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: Optional[float] = 1.0,
                 ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE: ``params`` and ``state``'s moments are
    updated where they lie and returned.  ``lr`` is the schedule's value
    for ``state.step``."""
    if max_grad_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = global_norm(grads)
    state.step += 1
    bc1 = 1.0 - b1 ** state.step
    bc2 = 1.0 - b2 ** state.step
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.float()
        m.mul_(b1).add_(g.to(m.dtype), alpha=1.0 - b1)
        v.mul_(b2).add_((g * g).to(v.dtype), alpha=1.0 - b2)
        delta = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + eps)
        # Decoupled weight decay: only on matrices (rank >= 2), the usual
        # no-decay-on-norms/biases rule.
        if p.dim() >= 2 and weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm,
               "lr": torch.tensor(float(lr), dtype=torch.float32)}
    return params, state, metrics
