"""Vertex-centric programming interface (Cavs §3.1), PyTorch port of
``repro.core.vertex``.

A dynamic neural network is decomposed into a static *vertex function*
``F`` and a dynamic, instance-specific *input graph* ``G``.  ``F`` is
declared once against four message-passing primitives — ``gather``,
``scatter``, ``pull`` and ``push`` — mediated here by two dataclasses:

  - :class:`VertexIO` is what a (batched) application of ``F`` *sees*:
    the gathered child states, the pulled external rows and validity
    masks.  ``gather``/``pull`` are methods on it.
  - :class:`VertexOutput` is what the application *produces*: the
    scattered state and the (optional) pushed output.

:class:`LambdaVertex` wraps plain functions as ``F``;
:func:`apply_unbatched` evaluates ``F`` on one vertex (the serial path
the token readout's generation loop steps through).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.level_megastep import widths

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class VertexIO:
    """The batched view one evaluation of ``F`` receives (Cavs Fig. 3).

    All leading dimensions are ``M`` — the number of node slots in the
    current batching task ``V_t`` (padded; see ``node_mask``).
    """

    #: ``[M, A, S]`` gathered child states (``A`` = max arity).  Rows of
    #: absent children are the zero sentinel and masked off below.
    child_states: torch.Tensor
    #: ``[M, A]`` float {0,1}: 1 where the child exists.
    child_mask: torch.Tensor
    #: ``[M, X]`` pulled external rows (embeddings, or eager-hoisted
    #: input projections).
    external: torch.Tensor
    #: ``[M]`` float {0,1}: 1 where the slot holds a real vertex.
    node_mask: torch.Tensor

    def gather(self, child_idx: int) -> torch.Tensor:
        """Cavs ``gather(child_idx)``: state of the child at that index,
        ``[M, S]`` (zeros where the child does not exist)."""
        return self.child_states[:, child_idx, :] \
            * self.child_mask[:, child_idx, None]

    def gather_sum(self) -> torch.Tensor:
        """Child-sum convenience: sum of all existing children, ``[M, S]``."""
        return torch.sum(self.child_states * self.child_mask[..., None],
                         dim=1)

    def pull(self) -> torch.Tensor:
        """Cavs ``pull()``: the external input row for each slot, ``[M, X]``."""
        return self.external

    @property
    def num_slots(self) -> int:
        return self.child_states.shape[0]

    @property
    def arity(self) -> int:
        return self.child_states.shape[1]


@dataclasses.dataclass(frozen=True)
class VertexOutput:
    """What one evaluation of ``F`` produces: ``state`` (``[M, S]``) is
    scattered into the node-state buffer for parents to ``gather``;
    ``push`` (``[M, O]`` or ``None``) is made visible to consumers
    external to ``(F, G)``."""

    state: torch.Tensor
    push: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class GateSpec:
    """A cell's declaration that its gate math is *megastep-fusable*:

        gates = pulled_ext_proj + recurrent(child_states) ; state = cell(gates)

    with a known ``kind``.  A cell that declares a ``GateSpec`` (via a
    ``gate_spec()`` method) opts into the scheduler's fused path: one
    kernel launch per batching task instead of gather → apply → scatter
    as separate ops.  ``weight_names`` are the keys of the params dict
    the kernel consumes (the eager ``wx`` projection stays outside — it
    is hoisted, §3.5).
    """

    #: Gate-math kind: "lstm", "treelstm", "gru" or "treefc" (the
    #: vocabulary of ``repro.kernels.level_megastep``); each has a forward
    #: and a reverse megastep kernel in ``repro_torch.kernels``.
    kind: str
    hidden: int
    weight_names: Tuple[str, ...]
    #: Fixed gather arity required by the kernel, or ``None`` when the
    #: gate math is arity-agnostic.
    arity: Optional[int] = None

    @property
    def state_dim(self) -> int:
        """Width of the scattered state row (``[c|h]`` doubles it)."""
        return widths(self.kind, self.hidden)[0]

    @property
    def gate_dim(self) -> int:
        """Width of the pulled (eagerly projected) external row."""
        return widths(self.kind, self.hidden)[1]

    def weights(self, params: Params) -> Tuple[torch.Tensor, ...]:
        return tuple(params[n] for n in self.weight_names)

    def inject_grads(self, params: Params,
                     grads: Sequence[torch.Tensor]) -> Params:
        """Zero cotangent dict for ``params`` with the megastep weight
        gradients filled in (the hoisted ``wx`` gradients are added by the
        caller through the projection's VJP)."""
        out = {k: torch.zeros_like(v) for k, v in params.items()}
        for name, g in zip(self.weight_names, grads):
            out[name] = g
        return out


def get_gate_spec(fn: Any) -> Optional[GateSpec]:
    """The cell's fusable gate declaration, or ``None`` (unfused path)."""
    getter = getattr(fn, "gate_spec", None)
    return getter() if callable(getter) else None


@dataclasses.dataclass(frozen=True)
class LambdaVertex:
    """Wrap plain functions as a vertex function: ``init_fn(generator)``
    → params, ``apply_fn(params, io)`` → :class:`VertexOutput`, and an
    optional eager prefix ``project_fn(params, raw)``."""

    state_dim: int
    ext_dim: int
    arity: int
    init_fn: Callable[[torch.Generator], Params]
    apply_fn: Callable[[Params, VertexIO], VertexOutput]
    project_fn: Optional[Callable[[Params, torch.Tensor],
                                  torch.Tensor]] = None

    def init(self, generator: torch.Generator) -> Params:
        return self.init_fn(generator)

    def apply(self, params: Params, io: VertexIO) -> VertexOutput:
        return self.apply_fn(params, io)

    def project_inputs(self, params: Params,
                       raw: torch.Tensor) -> torch.Tensor:
        if self.project_fn is None:
            raise AttributeError("no eager projection declared")
        return self.project_fn(params, raw)

    @property
    def has_projection(self) -> bool:
        return self.project_fn is not None


def has_eager_projection(fn: Any) -> bool:
    """True if ``fn`` declares an eager input projection (streaming hook)."""
    if isinstance(fn, LambdaVertex):
        return fn.has_projection
    return callable(getattr(fn, "project_inputs", None))


def apply_unbatched(fn: Any, params: Params, child_states: torch.Tensor,
                    child_mask: torch.Tensor,
                    external: torch.Tensor) -> VertexOutput:
    """Evaluate ``F`` on a single vertex (M = 1) — the serial reference
    path.  ``child_states``: ``[A, S]``; ``child_mask``: ``[A]``;
    ``external``: ``[X]``."""
    io = VertexIO(
        child_states=child_states[None],
        child_mask=child_mask[None].to(child_states.dtype),
        external=external[None],
        node_mask=torch.ones((1,), dtype=child_states.dtype,
                             device=child_states.device),
    )
    out = fn.apply(params, io)
    return VertexOutput(state=out.state[0],
                        push=None if out.push is None else out.push[0])
