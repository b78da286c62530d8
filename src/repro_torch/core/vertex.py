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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

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


def has_eager_projection(fn: Any) -> bool:
    """True if ``fn`` declares an eager input projection (streaming hook)."""
    return callable(getattr(fn, "project_inputs", None))
