"""The Cavs scheduler: batched level-synchronous execution (paper Alg. 1),
the forward half of ``repro.core.scheduler`` in PyTorch.

One step per batching task ``V_t``: gather child states from the
node-state buffer, apply the static vertex function ``F`` once over all
``M`` slots, write the results into the buffer block ``[t*M, (t+1)*M)``
(the dynamic-tensor offset discipline, §3.3).  PyTorch runs eagerly, so
the level loop is a Python loop where the JAX package has a
``lax.scan``.

The *eager* side of §3.5 (streaming) is ``hoist=True``: when ``F``
declares ``project_inputs`` (its vertex-independent prefix, e.g. the
``W·x`` input projections), it is evaluated for ALL external rows in one
batched matmul *before* the sequential region.

Fused megasteps (``fusion_mode``): a cell that declares a
:class:`~repro_torch.core.vertex.GateSpec` routes each batching task
through ONE fused kernel launch (``kernels/level_megastep.py``) instead
of gather → apply → scatter as separate ops.  ``fusion_mode="auto"``
(default; overridable via the ``REPRO_FUSION`` env var) fuses whenever
the cell supports it; ``"none"`` keeps the op-by-op path (the
correctness oracle); ``"megastep"`` requires fusion and raises when
unsupported.  Both return the same buffer to 1e-4.

This module is forward only: ``execute_lazy`` and the fused backward
come with the training slice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.structure import DeviceSchedule
from repro_torch.core.vertex import (GateSpec, VertexIO, get_gate_spec,
                                     has_eager_projection)
from repro_torch.kernels import ops as kops

Params = Any


@dataclasses.dataclass(frozen=True)
class ExecResult:
    """Outcome of scheduling ``F`` over a packed batch of graphs.

    ``buf``: ``[T*M + 1, S]`` node-state buffer (row ``T*M`` = sentinel).
    ``pushed``: ``[T*M, O]`` per-slot pushed outputs, or ``None``.
    """

    buf: torch.Tensor
    pushed: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Level utilities
# ---------------------------------------------------------------------------

def _level_io(buf: torch.Tensor, external: torch.Tensor,
              child_ids: torch.Tensor, child_mask: torch.Tensor,
              ext_ids: torch.Tensor, node_mask: torch.Tensor,
              state_dim: int) -> VertexIO:
    """Materialize the VertexIO of one batching task from the buffer:
    the row gather on the buffer is the Cavs ``gather`` primitive, the
    one on ``external`` is ``pull``."""
    M, A = child_ids.shape
    ch = buf.index_select(0, child_ids.reshape(-1)).reshape(M, A, state_dim)
    ext = external.index_select(0, ext_ids)
    return VertexIO(child_states=ch, child_mask=child_mask.to(buf.dtype),
                    external=ext, node_mask=node_mask.to(buf.dtype))


def _maybe_hoist(fn, params: Params, external: torch.Tensor,
                 hoist: bool) -> Tuple[torch.Tensor, bool]:
    """If ``F`` declares an eager prefix and hoisting is on, project ALL
    external rows in one batched call (streaming, §3.5).  Returns the
    external matrix plus whether projection still needs to happen
    per-level (hoisting ablated OFF)."""
    if has_eager_projection(fn):
        if hoist:
            return fn.project_inputs(params, external), False
        return external, True
    return external, False


# ---------------------------------------------------------------------------
# Fused megastep path (one launch per batching task)
# ---------------------------------------------------------------------------

def _fusion_spec(fn, fusion_mode: str, *, hoist: bool, collect_push: bool,
                 dtype=torch.float32,
                 sched_arity: Optional[int] = None) -> Optional[GateSpec]:
    """Resolve the fusion decision: the cell's GateSpec when the fused
    megastep path applies, else ``None`` (op-by-op path).

    The fused buffer is float32, so a non-f32 ``dtype`` falls back to
    the op-by-op path under "auto" and raises under "megastep".
    Fixed-arity kinds additionally require the packed schedule's ``A``
    to match ``spec.arity`` exactly.
    """
    mode = fusion_mode
    if mode == "auto":
        mode = os.environ.get("REPRO_FUSION", "auto")
    if mode not in ("auto", "megastep", "none"):
        raise ValueError(f"fusion_mode must be 'auto', 'megastep' or "
                         f"'none', got {mode!r}")
    if mode == "none":
        return None
    spec = get_gate_spec(fn)
    f32 = dtype == torch.float32
    arity_ok = (spec is None or spec.arity is None or sched_arity is None
                or spec.arity == sched_arity)
    ok = (spec is not None and has_eager_projection(fn) and hoist
          and not collect_push and f32 and arity_ok)
    if mode == "megastep" and not ok:
        if spec is not None and not arity_ok:
            raise ValueError(
                f"fusion_mode='megastep': {type(fn).__name__} declares a "
                f"fixed gather arity {spec.arity} but the packed schedule "
                f"has A={sched_arity} — repack with pad_arity="
                f"{spec.arity} or use fusion_mode='none'")
        raise ValueError(
            "fusion_mode='megastep' needs a cell with a GateSpec and an "
            "eager projection, hoist=True, collect_push=False and a "
            f"float32 buffer dtype (got fn={type(fn).__name__}, "
            f"hoist={hoist}, collect_push={collect_push}, dtype={dtype})")
    return spec if ok else None


def resolve_fusion(fn, fusion_mode: str = "auto", *, hoist: bool = True,
                   collect_push: bool = False, dtype=torch.float32,
                   sched_arity: Optional[int] = None) -> Optional[GateSpec]:
    """Public fusion resolution (used by ``serve.engine``): the GateSpec
    the fused path will use, or ``None`` for op-by-op — the same
    decision :func:`execute` makes internally."""
    return _fusion_spec(fn, fusion_mode, hoist=hoist,
                        collect_push=collect_push, dtype=dtype,
                        sched_arity=sched_arity)


def _megastep_forward(spec: GateSpec, weights, sched: DeviceSchedule,
                      ext: torch.Tensor) -> torch.Tensor:
    """Forward where each batching task is ONE fused megastep.  Every
    level writes IN PLACE into one ``[T*M+1, S]`` buffer — the
    counterpart of the Pallas kernel's ``input_output_aliases``, which
    lets the JAX scan carry one buffer without a per-level copy."""
    T, M = sched.T, sched.M
    buf = torch.zeros((T * M + 1, spec.state_dim), dtype=ext.dtype,
                      device=ext.device)
    for t in range(T):
        kops.level_megastep(spec.kind, buf, sched.child_ids[t],
                            sched.child_mask[t], sched.ext_ids[t],
                            sched.node_mask[t], t * M, ext, weights)
    return buf


# ---------------------------------------------------------------------------
# Batched forward (the paper's FORWARD, Alg. 1)
# ---------------------------------------------------------------------------

def execute(fn, params: Params, sched: DeviceSchedule,
            external: torch.Tensor, *, hoist: bool = True,
            collect_push: bool = False, dtype: torch.dtype = torch.float32,
            fusion_mode: str = "auto") -> ExecResult:
    """Run the batching policy over a packed minibatch of graphs.

    ``external``: ``[R + 1, X_raw]`` packed external inputs (last row is
    the zero sentinel), on the schedule's device.  ``fusion_mode``:
    ``"auto"`` | ``"megastep"`` | ``"none"`` — see the module docstring.
    """
    spec = _fusion_spec(fn, fusion_mode, hoist=hoist,
                        collect_push=collect_push, dtype=dtype,
                        sched_arity=sched.A)
    if spec is not None:
        # The hoisted W·x is one plain matmul, as the JAX package leaves
        # it to XLA.
        ext = fn.project_inputs(params, external)
        return ExecResult(buf=_megastep_forward(spec, spec.weights(params),
                                                sched, ext))
    T, M = sched.T, sched.M
    S = fn.state_dim
    ext, project_per_level = _maybe_hoist(fn, params, external, hoist)
    buf = torch.zeros((T * M + 1, S), dtype=dtype, device=external.device)
    pushes = []
    for t in range(T):
        io = _level_io(buf, ext, sched.child_ids[t], sched.child_mask[t],
                       sched.ext_ids[t], sched.node_mask[t], S)
        if project_per_level:
            # Streaming ablated off: the eager prefix runs inside the
            # sequential region, once per batching task.
            io = dataclasses.replace(
                io, external=fn.project_inputs(params, io.external))
        out = fn.apply(params, io)
        buf[t * M:(t + 1) * M] = (out.state * io.node_mask[:, None]) \
            .to(dtype)
        if collect_push:
            pushes.append(out.push)
    pushed = None
    if collect_push and pushes and pushes[0] is not None:
        pushed = torch.stack(pushes).reshape(T * M, -1)
    return ExecResult(buf=buf, pushed=pushed)


# ---------------------------------------------------------------------------
# Readouts (lazy `push`: external consumers read the buffer afterwards)
# ---------------------------------------------------------------------------

def readout_roots(buf: torch.Tensor, sched: DeviceSchedule) -> torch.Tensor:
    """``[K, S]`` root states (e.g. tree classification heads)."""
    return buf.index_select(0, sched.root_slots)


def readout_nodes(buf: torch.Tensor, sched: DeviceSchedule) -> torch.Tensor:
    """``[K, N, S]`` per-node states in original node order; padded nodes
    read the zero sentinel."""
    K, N = sched.slot_of.shape
    out = buf.index_select(0, sched.slot_of.reshape(-1)).reshape(K, N, -1)
    return out * sched.node_valid[..., None]
