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

Training goes through :func:`execute_lazy`, whose backward is lazily
batched (§3.5): the state-chain cotangents are swept level by level in
reverse, then ONE flat pass over all ``T*M`` slots gives the parameter
and pulled-row gradients.  On the fused leg the reverse sweep is one
reverse megastep per level (``kernels/level_megastep_bwd.py``) and the
forward saves only the node buffer (remat).  The scatters of the
backward (∂gather, ∂pull) go through ``ops.scatter_add_rows``, which on
the card is a deterministic kernel (no float atomics) reading the
schedule's scatter plans (``DeviceSchedule.ext_plan``/``child_plans``).

Continuous serving goes through :func:`frontier_step`: one batching task
over a union frontier of many in-flight graphs at different depths,
scattering each lane's state to its own arena row.

:func:`execute_serial` is the DyNet-style baseline the paper measures
against (Fig. 8): per sample and per vertex, no batching at all.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.structure import DeviceSchedule, InputGraph
from repro_torch.core.vertex import (GateSpec, VertexIO, apply_unbatched,
                                     get_gate_spec, has_eager_projection)
from repro_torch.kernels import level_megastep as lm
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
                            sched.node_mask[t], t * M, ext, weights,
                            live=None if sched.live is None
                            else sched.live[t])
    return buf


def _level_runs(sched: DeviceSchedule, t: int) -> Dict[str, Any]:
    """Level ``t``'s precomputed sorted runs and reverse-megastep plan
    (``live``, ``single``, ``heads``) as keyword arguments of
    ``ops.bwd_megastep`` (``None`` on a schedule packed without them)."""
    names = ("sort_perm", "sorted_child_ids", "run_head")
    kw = {k: None if getattr(sched, k) is None else getattr(sched, k)[t]
          for k in names}
    if sched.bwd_single is not None:
        kw.update(live=sched.live[t], single=sched.bwd_single[t],
                  heads=sched.bwd_heads[t])
    return kw


def _level_plan(sched: DeviceSchedule, t: int):
    """Level ``t``'s scatter plan of its flat child ids (``None`` on a
    schedule packed without the sorted runs)."""
    return None if sched.child_plans is None else sched.child_plans[t]


class _ExecuteMegastep(torch.autograd.Function):
    """The fused leg: one megastep per level forward, and the fused
    backward — ONE reverse megastep per level for the state chain
    (recompute + cotangent math + ∂gather scatter-add, §3.4), then ONE
    flat lazily batched pass for the parameter and pulled-row gradients
    (§3.5).  It takes the hoisted ``ext`` (autograd runs the projection's
    VJP on the returned cotangent) and the params as separate tensors,
    and saves only the node buffer, ``ext``, the params and the schedule:
    activations are recomputed (remat)."""

    @staticmethod
    def forward(ctx, spec: GateSpec, sched: DeviceSchedule,
                names: Tuple[str, ...], ext: torch.Tensor,
                *values: torch.Tensor) -> torch.Tensor:
        params = dict(zip(names, values))
        buf = _megastep_forward(spec, spec.weights(params), sched, ext)
        ctx.spec, ctx.sched, ctx.names = spec, sched, names
        ctx.save_for_backward(buf, ext, *values)
        return buf

    @staticmethod
    def backward(ctx, g_buf: torch.Tensor):
        buf, ext, *values = ctx.saved_tensors
        spec, sched = ctx.spec, ctx.sched
        params = dict(zip(ctx.names, values))
        weights = spec.weights(params)
        T, M, A = sched.T, sched.M, sched.A
        S = spec.state_dim
        # The reverse megastep writes the gradient buffer in place: sweep
        # a copy, never autograd's grad_output.
        g = torch.empty_like(buf).copy_(g_buf)
        ws = kops.bwd_workspace(spec.kind, g, M, A, spec.hidden)
        for t in reversed(range(T)):
            kops.bwd_megastep(spec.kind, g, buf, sched.child_ids[t],
                              sched.child_mask[t], sched.ext_ids[t],
                              sched.node_mask[t], t * M, ext, weights,
                              workspace=ws, **_level_runs(sched, t))
        # Row t*M+m reaches its final value before level t's reverse step
        # runs (all its parents live at levels > t), so the swept buffer
        # IS the per-slot state cotangent: no per-level stacking.
        g_state = g[:T * M] * sched.node_mask.reshape(T * M, 1)
        # Lazy batching: one analytic pass over ALL T*M slots.
        child = buf.index_select(0, sched.child_ids.reshape(-1)) \
            .reshape(T * M, A, S)
        ext_ids = sched.ext_ids.reshape(T * M)
        _, d_gates, aux = lm.level_bwd(spec.kind, g_state, child,
                                       ext.index_select(0, ext_ids),
                                       sched.child_mask.reshape(T * M, A),
                                       weights)
        g_params = spec.inject_grads(
            params, lm.level_param_grads(spec.kind, d_gates, aux, weights))
        # ∂pull = push: scatter the pulled-row cotangents back to the
        # packed matrix (autograd then runs the projection's VJP).
        g_ext = kops.scatter_add_rows(torch.zeros_like(ext), ext_ids,
                                      d_gates, plan=sched.ext_plan)
        return (None, None, None, g_ext,
                *(g_params[k] for k in ctx.names))


def _execute_megastep(spec: GateSpec, params: Params, ext: torch.Tensor,
                      sched: DeviceSchedule) -> torch.Tensor:
    names = tuple(params)
    return _ExecuteMegastep.apply(spec, sched, names, ext,
                                  *(params[k] for k in names))


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
        return ExecResult(buf=_execute_megastep(spec, params, ext, sched))
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
# Lazy-batched gradients (the paper's lazy batching, §3.5)
# ---------------------------------------------------------------------------

def _forward_buf(fn, params: Params, sched: DeviceSchedule,
                 ext: torch.Tensor) -> torch.Tensor:
    """Op-by-op forward producing only the node buffer (pushes are
    post-run readouts, the lazy treatment of ``push``)."""
    T, M, S = sched.T, sched.M, fn.state_dim
    buf = torch.zeros((T * M + 1, S), dtype=ext.dtype, device=ext.device)
    for t in range(T):
        io = _level_io(buf, ext, sched.child_ids[t], sched.child_mask[t],
                       sched.ext_ids[t], sched.node_mask[t], S)
        out = fn.apply(params, io)
        buf[t * M:(t + 1) * M] = out.state * io.node_mask[:, None]
    return buf


def _flat_io(fn, sched: DeviceSchedule, buf: torch.Tensor,
             ext: torch.Tensor) -> VertexIO:
    """One VertexIO covering ALL ``T*M`` slots at once (for the single
    batched parameter-gradient evaluation)."""
    T, M, A, S = sched.T, sched.M, sched.A, fn.state_dim
    return _level_io(buf, ext, sched.child_ids.reshape(T * M, A),
                     sched.child_mask.reshape(T * M, A),
                     sched.ext_ids.reshape(T * M),
                     sched.node_mask.reshape(T * M), S)


def _vjp(f, inputs: Sequence[torch.Tensor],
         cotangent: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Cotangents of ``f(*inputs)`` w.r.t. ``inputs`` (zeros for an input
    ``f`` does not use), on detached copies: the counterpart of
    ``jax.vjp`` inside a backward."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    with torch.enable_grad():
        out = f(*leaves)
    grads = torch.autograd.grad(out, leaves, cotangent, allow_unused=True)
    return tuple(torch.zeros_like(x) if gx is None else gx
                 for x, gx in zip(leaves, grads))


class _ExecuteLazyOpByOp(torch.autograd.Function):
    """The op-by-op leg (the ablation baseline and the correctness
    oracle): gather / apply / scatter per level forward; backward sweeps
    the state-chain cotangents level by level in reverse (a VJP of
    ``fn.apply`` w.r.t. the child states, then the ∂gather scatter-add),
    then ONE flat parameter/pulled-row VJP over all ``T*M`` slots."""

    @staticmethod
    def forward(ctx, fn, sched: DeviceSchedule, names: Tuple[str, ...],
                ext: torch.Tensor, *values: torch.Tensor) -> torch.Tensor:
        buf = _forward_buf(fn, dict(zip(names, values)), sched, ext)
        ctx.fn, ctx.sched, ctx.names = fn, sched, names
        ctx.save_for_backward(buf, ext, *values)
        return buf

    @staticmethod
    def backward(ctx, g_buf: torch.Tensor):
        buf, ext, *values = ctx.saved_tensors
        fn, sched, names = ctx.fn, ctx.sched, ctx.names
        params = {k: v.detach() for k, v in zip(names, values)}
        T, M, A, S = sched.T, sched.M, sched.A, fn.state_dim
        g = torch.empty_like(buf).copy_(g_buf)
        g_states = [None] * T
        for t in reversed(range(T)):
            io = _level_io(buf, ext, sched.child_ids[t], sched.child_mask[t],
                           sched.ext_ids[t], sched.node_mask[t], S)
            nm = io.node_mask[:, None]
            g_states[t] = g[t * M:(t + 1) * M] * nm

            def f_of_children(ch, io=io, nm=nm):
                out = fn.apply(params, dataclasses.replace(io,
                                                           child_states=ch))
                return out.state * nm

            (g_ch,) = _vjp(f_of_children, (io.child_states,), g_states[t])
            g_ch = g_ch * io.child_mask[..., None]
            # ∂gather = scatter (§3.4): child cotangents back into the
            # buffer; duplicate children accumulate.
            kops.scatter_add_rows(g, sched.child_ids[t].reshape(-1),
                                  g_ch.reshape(M * A, S),
                                  plan=_level_plan(sched, t))

        # Lazy batching: ONE parameter/external VJP over all T*M slots.
        io_flat = _flat_io(fn, sched, buf, ext)
        nm_flat = io_flat.node_mask[:, None]

        def f_flat(e_rows, *vals):
            out = fn.apply(dict(zip(names, vals)),
                           dataclasses.replace(io_flat, external=e_rows))
            return out.state * nm_flat

        g_rows, *g_params = _vjp(f_flat, (io_flat.external, *values),
                                 torch.cat(g_states))
        # ∂pull = push: pulled-row cotangents back to the packed matrix.
        g_ext = kops.scatter_add_rows(torch.zeros_like(ext),
                                      sched.ext_ids.reshape(T * M), g_rows,
                                      plan=sched.ext_plan)
        return (None, None, None, g_ext, *g_params)


def execute_lazy(fn, params: Params, external: torch.Tensor,
                 sched: DeviceSchedule,
                 fusion_mode: str = "auto") -> torch.Tensor:
    """Like :func:`execute` (hoist on, no push) but with the lazy-batched
    backward; differentiable in ``params`` and ``external``.  Returns the
    ``[T*M + 1, S]`` buffer.

    With ``fusion_mode`` "auto"/"megastep" and a GateSpec-declaring cell,
    forward AND backward run the fused megastep path (on the card: the
    forward and reverse megastep kernels; the schedule must carry its
    sorted runs, ``pack_batch(with_runs=True)``); ``"none"`` keeps the
    op-by-op lazy path as the ablation baseline.
    """
    spec = _fusion_spec(fn, fusion_mode, hoist=True, collect_push=False,
                        sched_arity=sched.A)
    if spec is not None:
        return _execute_megastep(spec, params,
                                 fn.project_inputs(params, external), sched)
    ext, _ = _maybe_hoist(fn, params, external, True)
    names = tuple(params)
    return _ExecuteLazyOpByOp.apply(fn, sched, names, ext,
                                    *(params[k] for k in names))


# ---------------------------------------------------------------------------
# Union-frontier execution (continuous cross-request batching)
# ---------------------------------------------------------------------------

def frontier_step(fn, params: Params, buf: torch.Tensor,
                  child_ids: torch.Tensor, child_mask: torch.Tensor,
                  ext_rows: torch.Tensor, node_mask: torch.Tensor,
                  out_ids: torch.Tensor, *, spec: Optional[GateSpec] = None,
                  ext_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One batching task over a mixed-depth UNION frontier, IN PLACE on
    ``buf``; returns it.

    The continuous serving engine schedules ready vertices of MANY
    in-flight graphs into one frontier: lane ``m`` gathers its children
    from arbitrary arena rows (``child_ids``), pulls its external row
    (``ext_rows[m]``, or ``ext_rows[ext_ids[m]]`` when ``ext_ids`` is
    given — already eagerly projected for GateSpec cells), and scatters
    its state to its own arena row ``out_ids[m]`` instead of a contiguous
    level block.  Per-request level offsets are pure data resolved
    host-side.

    With ``spec`` the row math goes through the fused frontier megastep
    (``ops.frontier_megastep``: on the card one level megastep that
    stores each lane's row at ``out_ids``); without it the
    op-by-op gather → ``fn.apply`` → ``ops.scatter_rows``.  Both legs
    compute the rows :func:`execute` computes for the same vertex on the
    matching leg.

    Pad lanes: ``node_mask`` 0, ``child_ids`` at the buffer sentinel,
    ``out_ids`` out of range (unique; the scatter drops them).
    """
    if spec is not None:
        return kops.frontier_megastep(spec.kind, buf, child_ids, child_mask,
                                      ext_rows, node_mask, out_ids,
                                      spec.weights(params), ext_ids=ext_ids)
    M, A = child_ids.shape
    S = buf.shape[1]
    if ext_ids is not None:
        ext_rows = ext_rows.index_select(0, ext_ids)
    ch = buf.index_select(0, child_ids.reshape(-1)).reshape(M, A, S)
    io = VertexIO(child_states=ch, child_mask=child_mask.to(buf.dtype),
                  external=ext_rows, node_mask=node_mask.to(buf.dtype))
    out = fn.apply(params, io)
    state = (out.state * io.node_mask[:, None]).to(buf.dtype).contiguous()
    return kops.scatter_rows(buf, out_ids, state)


# ---------------------------------------------------------------------------
# Serial reference policy (the dynamic-declaration baseline)
# ---------------------------------------------------------------------------

def execute_serial(fn, params: Params, graphs: Sequence[InputGraph],
                   inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Per-vertex, per-sample execution -- the DyNet-style baseline the
    paper compares against (no cross-sample batching, a few small
    launches per vertex; Fig. 8's serial-vs-batched comparison).  Returns,
    per sample, a ``[num_nodes, S]`` float32 state matrix.

    Vertices run in the stable order of their levels, each through
    :func:`~repro_torch.core.vertex.apply_unbatched` with its own
    projection of its external row.  Tensors live on the params' device:
    on the card every vertex is its own launches (the gate kernel of a
    ``cell_impl="pallas"`` cell included), which is exactly the
    inefficiency the paper measures."""
    dev = next(iter(params.values())).device
    A = max(max(g.max_arity for g in graphs), 1,
            getattr(fn, "arity", 1))     # fixed-arity cells (e.g. Tree-FC)
    S = fn.state_dim
    results = []
    with torch.no_grad():
        for g, x in zip(graphs, inputs):
            x = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
            states = torch.zeros((g.num_nodes, S), device=dev)
            for v in np.argsort(g.levels(), kind="stable"):
                ch = g.children[v]
                cs = torch.zeros((A, S), device=dev)
                cm = torch.zeros((A,), device=dev)
                if ch:
                    cs[:len(ch)] = states[list(ch)]
                    cm[:len(ch)] = 1.0
                er = g.ext_row[v]
                ext = x[er] if er >= 0 else x.new_zeros(x.shape[1])
                if has_eager_projection(fn):
                    # One tiny projection per vertex (the serial baseline
                    # hoists nothing).
                    ext = fn.project_inputs(params, ext[None])[0]
                out = apply_unbatched(fn, params, cs, cm, ext)
                states[v] = out.state
            results.append(states.cpu().numpy())
    return results


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
