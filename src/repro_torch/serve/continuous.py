"""Continuous cross-request batching: ONE live frontier over all
in-flight graphs (port of ``repro.serve.continuous``).

``StructureServeEngine`` batches at request granularity: it scores whole
batches, so frontier lanes idle whenever graphs finish at different
depths, and a request arriving mid-batch waits for the next flush.
:class:`ContinuousBatchEngine` is the LLM-style fix, DyNet's
agenda-based autobatching executed through the fused megastep:

  - **one agenda** — every in-flight graph's vertices live in a shared
    arena ``[num_rows + 1, S]`` on the device (last row = zero
    sentinel); a request is admitted by allocating arena rows from a free
    list and translating its cached per-topology plan into arena
    coordinates — pure host-side data.  Its eagerly projected pulled
    rows go once, at admission, into a pulled-row arena ``[num_rows + 1,
    G]`` at the same rows;
  - **union-frontier ticks** — each tick is ONE batching task
    (``core.scheduler.frontier_step``) over the ready vertices of ALL
    in-flight graphs, each lane at its own depth, writing to its own
    arena row.  On the card a fused tick is one launch: the level
    megastep of the cell's kind stores each lane's state at its arena
    row (``ops.frontier_megastep``).  Up to
    ``AdmissionPolicy.max_window`` ticks are planned host-side and run
    as one window (a Python loop where the reference has a
    ``lax.scan``), bounded by the first retirement so finished roots
    free rows promptly;
  - **mid-flight admission** — new requests enter whenever rows free
    up, FIFO with head-of-line blocking (a big graph never starves);
    :class:`~repro_torch.serve.robustness.RequestLifecycle` supplies
    backpressure, TTL deadlines and the exactly-one-terminal-status
    invariant;
  - **deadline-aware flushing** — ``step()`` defers firing a sparse
    frontier only while no live deadline is within ``ttl_slack_s`` and
    at most ``max_defer_ticks`` times; near a deadline the window
    shrinks to single ticks;
  - **immediate retirement into readout heads** — finished roots are
    read out of the arena the window they complete (one K6a
    ``ops.gather_rows`` launch, the root ids carried in the launch, each
    row stored to the card and into a pinned host buffer; one sync a
    window), non-finite roots fail alone, and the
    rest go through ``models/readout.py``: batched classification
    logits, and optionally the sampled-feedback
    :class:`~repro_torch.models.readout.TokenReadout` loop keyed by
    ``(seed, request_id)`` — tokens do not depend on how requests
    interleave.

Every request's root state is what scoring it ALONE through
``StructureServeEngine`` gives, to the 1e-4 bar: the per-lane math of
``frontier_step`` is the level scan's on the matching fusion leg, and
inputs are projected at admission over the same padded ``[N + 1, X]``
matrix solo scoring projects.  (The reference claims bit-identity; here
it rests on the kernels' per-row arithmetic not depending on the width
of the level, which ``chip_smoke.py`` reports without relying on it.)

On CPU tensors a failed fused window degrades to the op-by-op window
(counted, with a circuit breaker).  On the card there is no such ladder:
a failed window fails its in-flight requests.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import frontier_step, resolve_fusion
from repro_torch.core.structure import InputGraph, LevelSchedule
from repro_torch.core.vertex import has_eager_projection
from repro_torch.dist.fault import chaos_corrupt_ext
from repro_torch.kernels import gather_scatter as gsc
from repro_torch.kernels import ops as kops
from repro_torch.models.readout import ClassificationHead, TokenReadout
from repro_torch.obs import trace
from repro_torch.pipeline import BucketPolicy, ScheduleCache
from repro_torch.serve.engine import _EngineBase
from repro_torch.serve.robustness import (ACTIVE, CircuitBreaker,
                                          RequestLifecycle,
                                          validate_structure)

Params = Any


@dataclasses.dataclass
class ContinuousRequest:
    """One structure to score continuously: topology ``G`` + per-node
    inputs ``[num_nodes, X_raw]``.  The engine fills ``root_state``
    (always), ``logits``/``label`` (when it has a head) and ``tokens``
    (when it has a token readout)."""

    request_id: int
    graph: InputGraph
    inputs: np.ndarray
    ttl: Optional[float] = None      # seconds from submit to deadline
    # -- filled by the engine ------------------------------------------
    root_state: Optional[np.ndarray] = None
    logits: Optional[np.ndarray] = None
    label: Optional[int] = None
    tokens: Optional[List[int]] = None
    done: bool = False
    status: str = "new"              # lifecycle: serve/robustness.py
    error: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The latency-vs-occupancy knobs of :meth:`ContinuousBatchEngine.step`.

    ``min_occupancy`` — fire immediately once the next tick's frontier
    is at least this full; below it the engine may *defer* (skip the
    tick, letting arrivals accumulate) up to ``max_defer_ticks``
    consecutive times.  ``ttl_slack_s`` — once any live request's
    deadline is within this slack, never defer AND shrink the window to
    single ticks.  ``max_window`` — most ticks planned host-side and run
    as one window (windows also stop at the first retirement).
    """

    min_occupancy: float = 0.5
    ttl_slack_s: float = 0.05
    max_defer_ticks: int = 4
    max_window: int = 8


@dataclasses.dataclass
class _Plan:
    """Frontier plan of one topology in SOLO-slot space (cached per
    fingerprint): per real level, the occupied slots, their child ids /
    mask, and their external-row ids."""

    levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    root_slot: int
    num_rows: int                    # real vertices = arena rows needed
    sentinel_slot: int               # T*M (solo buffer sentinel)
    n_pad: int                       # padded node count N (ext is [N+1, X])


@dataclasses.dataclass(frozen=True)
class _ExtShim:
    """What ``chaos_corrupt_ext`` hooks read off a schedule: the padded
    per-sample node count (K=1 on the admission path)."""

    N: int


class _Active:
    """One in-flight request: its arena-space plan plus the frontier
    cursor (level index + lane offset within the level — partial levels
    split across ticks when the frontier is full)."""

    __slots__ = ("req", "levels", "level_idx", "lane_idx", "root_row",
                 "rows")

    def __init__(self, req: ContinuousRequest,
                 levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 root_row: int, rows: np.ndarray):
        self.req = req
        self.levels = levels          # per level: (dest, cids, cmask)
        self.level_idx = 0
        self.lane_idx = 0
        self.root_row = root_row
        self.rows = rows

    @property
    def finished(self) -> bool:
        return self.level_idx >= len(self.levels)


def _plan_from_schedule(sched: LevelSchedule) -> _Plan:
    """Project a solo (K=1) packed schedule down to its real lanes."""
    T, M = sched.T, sched.M
    levels = []
    total = 0
    for t in range(T):
        lanes = np.nonzero(sched.node_mask[t] > 0)[0]
        if lanes.size == 0:
            continue                  # bucket-padded empty level
        levels.append(((t * M + lanes).astype(np.int64),
                       sched.child_ids[t][lanes].astype(np.int64),
                       sched.child_mask[t][lanes].astype(np.float32),
                       sched.ext_ids[t][lanes].astype(np.int64)))
        total += int(lanes.size)
    return _Plan(levels=levels, root_slot=int(sched.root_slots[0]),
                 num_rows=total, sentinel_slot=T * M,
                 n_pad=int(sched.N))


def _frontier_window(fn, spec, params: Params, buf: torch.Tensor,
                     child_ids: torch.Tensor, child_mask: torch.Tensor,
                     ext_rows: torch.Tensor, node_mask: torch.Tensor,
                     out_ids: torch.Tensor,
                     ext_ids: torch.Tensor) -> torch.Tensor:
    """``k`` union-frontier ticks, in place on ``buf``: a Python loop
    over the window's ticks (``child_ids`` ``[k, M, A]``, ``child_mask``
    ``[k, M, A]``, ``node_mask``/``out_ids``/``ext_ids`` ``[k, M]``; the
    lanes pull rows ``ext_ids[t]`` of the pulled-row arena
    ``ext_rows``)."""
    with torch.no_grad():
        for t in range(child_ids.shape[0]):
            frontier_step(fn, params, buf, child_ids[t], child_mask[t],
                          ext_rows, node_mask[t], out_ids[t], spec=spec,
                          ext_ids=ext_ids[t])
    return buf


class ContinuousBatchEngine(_EngineBase):
    """Continuous cross-request batching over one live frontier agenda,
    on ``device`` (default the card; params must live there).

    ``num_rows`` — arena capacity (total co-resident vertices across all
    in-flight graphs); ``frontier_width`` — lanes per tick (the ``M`` of
    every tick).  ``head`` / ``token_readout`` attach retirement-time
    readouts (pass their params alongside); ``seed`` keys the token
    draws (step ``t`` of request ``r`` samples under ``(seed, r, t)``).
    Everything else mirrors the other engines: bounded queue, TTLs, a
    fused → op-by-op ladder with a circuit breaker on CPU tensors, a
    non-finite root guard.
    """

    #: Rows of the retirement's host buffer at the start.
    HOST_ROWS = 16

    def __init__(self, fn, params: Params, *, num_rows: int = 256,
                 frontier_width: int = 32, fusion_mode: str = "auto",
                 policy: AdmissionPolicy = AdmissionPolicy(),
                 head: Optional[ClassificationHead] = None,
                 head_params: Optional[Params] = None,
                 token_readout: Optional[TokenReadout] = None,
                 token_params: Optional[Params] = None,
                 max_new_tokens: int = 16,
                 seed: int = 0,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 breaker_threshold: int = 3,
                 guard_nonfinite: bool = True,
                 cache: Optional[ScheduleCache] = None,
                 device="cuda"):
        if num_rows < 1 or frontier_width < 1:
            raise ValueError("num_rows and frontier_width must be >= 1")
        self.fn = fn
        self.params = params
        self.num_rows = num_rows
        self.frontier_width = frontier_width
        self.policy = policy
        self.device = torch.device(device)
        self.A = max(1, getattr(fn, "arity", 1))
        self.spec = resolve_fusion(fn, fusion_mode, sched_arity=self.A)
        self.head = head
        self.head_params = head_params
        self.token_readout = token_readout
        self.token_params = token_params
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.guard_nonfinite = guard_nonfinite
        self.lifecycle = RequestLifecycle(max_queue=max_queue, clock=clock)
        self._breaker = CircuitBreaker(breaker_threshold)
        self.last_degradation: Optional[str] = None
        # Per-request schedule reuse: solo schedules come from the
        # ScheduleCache's per-GRAPH tier — a recurring topology admits
        # with ZERO packing work — and the derived frontier plan is
        # memoized in the graph-tier entry's ``extras``.
        self.cache = cache if cache is not None else ScheduleCache()
        self._buckets = BucketPolicy(mode="pow2")
        self.plan_hits = 0
        self.plan_misses = 0
        # Arena: rows [0, num_rows) are allocatable; row num_rows is the
        # zero sentinel absent children gather (never written: pad lanes
        # scatter out of range and are dropped).
        self._buf = torch.zeros((num_rows + 1, fn.state_dim),
                                dtype=torch.float32, device=self.device)
        # Pulled-row arena: row r holds the pulled (projected) row of the
        # vertex at arena row r; row num_rows stays zero for pad lanes.
        self._ext = torch.zeros((num_rows + 1, fn.ext_dim),
                                dtype=torch.float32, device=self.device)
        self._free: List[int] = list(range(num_rows - 1, -1, -1))
        self._active: List[_Active] = []
        self._window = functools.partial(_frontier_window, fn, self.spec)
        self._window_oracle = functools.partial(_frontier_window, fn, None)
        self.ticks = 0
        self.windows = 0
        self.deferred = 0
        #: live lanes over all ticks run (occupancy = lanes / ticks / M)
        self.lanes = 0
        #: windows whose finished roots were read out of the arena
        self.readbacks = 0
        # The retired roots' host rows (K6a stores them there on the card
        # through the buffer's mapped address): page-locked on the card,
        # grown to the next power of two when a window retires more.
        self._grow_host(self.HOST_ROWS)
        self._defer_run = 0

    # -- ingress ------------------------------------------------------------
    @property
    def fused(self) -> bool:
        """True while windows run the fused frontier megastep (False once
        the circuit breaker has pinned the op-by-op window)."""
        return self.spec is not None and not self._breaker.open

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def free_rows(self) -> int:
        return len(self._free)

    def submit(self, req: ContinuousRequest) -> bool:
        """Validate + enqueue; returns False (and routes ``req`` to the
        ``rejected`` terminal) on a malformed structure, non-finite
        inputs, a structure exceeding the arena capacity or the engine's
        gather arity, a full queue, or a double-submitted request."""
        err = validate_structure(req.graph, req.inputs, self.fn.input_dim)
        if err is None and req.graph.num_nodes > self.num_rows:
            err = (f"structure needs {req.graph.num_nodes} arena rows > "
                   f"engine num_rows={self.num_rows}")
        if err is None and req.graph.max_arity > self.A:
            err = (f"structure arity {req.graph.max_arity} > engine "
                   f"gather arity {self.A}")
        if err is not None:
            err = f"request {req.request_id}: {err}"
        return self.lifecycle.submit(req, err)

    # -- one engine step -----------------------------------------------------
    def step(self) -> int:
        """Admit waiting requests into free rows, then either run one
        window over the union frontier or (policy permitting) defer to
        let the frontier fill.  Returns live requests (active + queued)
        after the step."""
        with trace.span("cb.tick", active=self.num_active,
                        queued=len(self.queue)):
            return self._step()

    def _step(self) -> int:
        self.lifecycle.sweep_deadlines()
        self._retire_expired()
        self._admit()
        if not self._active:
            self._defer_run = 0
            return len(self.queue)

        now = self.lifecycle.clock()
        urgent = self._min_slack(now) <= self.policy.ttl_slack_s
        occ = self._next_tick_lanes() / float(self.frontier_width)
        if (occ < self.policy.min_occupancy and not urgent
                and self._defer_run < self.policy.max_defer_ticks):
            # Partial frontier and no deadline pressure: hold the tick so
            # arrivals between steps can fill it (bounded).
            self._defer_run += 1
            self.deferred += 1
            return len(self._active) + len(self.queue)
        self._defer_run = 0

        window = 1 if urgent else self.policy.max_window
        with trace.span("cb.plan"):
            ticks, done = self._plan_window(window)
        if ticks:
            with trace.span("cb.stack", ticks=len(ticks)):
                args = self._stack_window(ticks)
            try:
                with trace.span("cb.window", ticks=len(ticks),
                                fused=self.fused):
                    self._run_window(args)
            except Exception as e:       # noqa: BLE001 — the window is lost
                # Every in-flight request reaches the ``failed`` terminal
                # (its rows are zeroed and freed); queued requests are
                # untouched and admit next step.
                self._fail_inflight(f"frontier window failed: {e}")
                return len(self._active) + len(self.queue)
            self.ticks += len(ticks)
            self.windows += 1
            self.lanes += sum(len(p[0]) for parts in ticks for p in parts)
        if done:
            with trace.span("cb.retire", count=len(done)):
                self._retire(done)
        return len(self._active) + len(self.queue)

    def run(self, max_steps: int = 100_000) -> List[ContinuousRequest]:
        """Drain the queue; returns finished requests."""
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return self.finished

    # -- admission -----------------------------------------------------------
    def _admit(self) -> int:
        """FIFO admission into free arena rows.  Head-of-line blocking is
        deliberate: a wide graph waits for rows rather than being
        overtaken forever by small ones (no starvation)."""
        admitted = 0
        while self.queue:
            req = self.queue[0]
            try:
                plan = self._plan_for(req.graph)
            except Exception as e:       # noqa: BLE001 — pack fault
                # A poisoned topology fails ALONE at admission.
                self.queue.pop(0)
                self.lifecycle.finish_failed(req, f"schedule pack "
                                                  f"failed: {e}")
                continue
            if plan.num_rows > len(self._free):
                break
            self.queue.pop(0)
            try:
                with trace.correlate(request=req.request_id), \
                        trace.span("cb.admit", rows=plan.num_rows):
                    self._activate(req, plan)
            except Exception as e:       # noqa: BLE001 — ext/projection
                self.lifecycle.finish_failed(req, f"admission failed: {e}")
                continue
            admitted += 1
        return admitted

    def _plan_for(self, graph: InputGraph) -> _Plan:
        pads = self._buckets.bucket([graph])._replace(arity=self.A)
        sched, extras = self.cache.get_or_pack_graph(
            graph, tuple(pads), with_runs=False, with_extras=True)
        plan = extras.get("frontier_plan")
        if plan is not None:
            self.plan_hits += 1
            return plan
        self.plan_misses += 1
        plan = _plan_from_schedule(sched)
        extras["frontier_plan"] = plan
        return plan

    def _activate(self, req: ContinuousRequest, plan: _Plan) -> None:
        """Allocate arena rows and translate the solo-slot plan into
        arena coordinates; project the request's external rows once and
        put each vertex's pulled row at its arena row of the pulled-row
        arena."""
        ext = self._ext_matrix(req, plan)
        rows = np.asarray([self._free.pop() for _ in range(plan.num_rows)],
                          np.int64)
        arena_of = np.full(plan.sentinel_slot + 1, self.num_rows, np.int64)
        arena_of[np.concatenate([lv[0] for lv in plan.levels])] = rows
        eids = np.concatenate([lv[3] for lv in plan.levels])
        idx = torch.from_numpy(np.stack([rows, eids])).to(self.device)
        self._ext.index_copy_(0, idx[0], ext.index_select(0, idx[1]))
        levels = [(arena_of[slots], arena_of[cids], cmask)
                  for slots, cids, cmask, _ in plan.levels]
        req.status = ACTIVE
        self._active.append(_Active(req, levels,
                                    int(arena_of[plan.root_slot]), rows))

    def _ext_matrix(self, req: ContinuousRequest,
                    plan: _Plan) -> torch.Tensor:
        """The request's packed ``[N + 1, X]`` external matrix on the
        device, eagerly projected when the cell declares a projection —
        the SAME padded shape and the same one-matmul hoist solo scoring
        performs, so every pulled row is what solo scoring pulls."""
        raw = np.zeros((plan.n_pad + 1, self.fn.input_dim), np.float32)
        x = np.asarray(req.inputs, np.float32)
        raw[: x.shape[0]] = x
        raw = torch.from_numpy(
            chaos_corrupt_ext(raw, _ExtShim(plan.n_pad))).to(self.device)
        if has_eager_projection(self.fn):
            with torch.no_grad():
                return self.fn.project_inputs(self.params, raw)
        return raw

    # -- window planning ------------------------------------------------------
    def _next_tick_lanes(self) -> int:
        avail = 0
        for a in self._active:
            if not a.finished:
                avail += len(a.levels[a.level_idx][0]) - a.lane_idx
                if avail >= self.frontier_width:
                    return self.frontier_width
        return avail

    def _min_slack(self, now: float) -> float:
        slack = float("inf")
        for a in self._active:
            d = getattr(a.req, "_deadline", None)
            if d is not None:
                slack = min(slack, d - now)
        return slack

    def _plan_window(self, max_ticks: int):
        """Simulate up to ``max_ticks`` union-frontier ticks host-side.
        Each tick takes lanes from every active request's CURRENT level
        (levels never merge within a tick — a vertex's children must be
        written by an earlier tick), splitting a level across ticks when
        the frontier is full.  Stops at the first tick that completes a
        request, so retirement (and row reuse) is prompt.  Returns
        ``(ticks, done)``: per-tick lane arrays and the actives that
        finished."""
        M = self.frontier_width
        cursor = {id(a): (a.level_idx, a.lane_idx) for a in self._active}
        ticks = []
        done: List[_Active] = []
        for _ in range(max_ticks):
            parts = []
            used = 0
            advanced = []
            for a in self._active:
                li, lo = cursor[id(a)]
                if li >= len(a.levels):
                    continue
                dest, cids, cmask = a.levels[li]
                take = min(len(dest) - lo, M - used)
                if take <= 0:
                    continue
                parts.append((dest[lo: lo + take], cids[lo: lo + take],
                              cmask[lo: lo + take]))
                used += take
                if lo + take >= len(dest):
                    cursor[id(a)] = (li + 1, 0)
                else:
                    cursor[id(a)] = (li, lo + take)
                advanced.append(a)
                if used >= M:
                    break
            if not parts:
                break
            ticks.append(parts)
            finished = [a for a in advanced
                        if cursor[id(a)][0] >= len(a.levels)]
            if finished:
                done.extend(finished)
                break
        # Commit the simulated cursors for the ticks actually planned.
        for a in self._active:
            a.level_idx, a.lane_idx = cursor[id(a)]
        return ticks, done

    def _stack_window(self, ticks) -> Tuple:
        """Pad each planned tick to the fixed frontier shape and stack the
        window: two host buffers (ints, floats), two copies to the device,
        viewed as ``child_ids``/``out_ids``/``ext_ids`` and
        ``child_mask``/``node_mask``.  Pad lanes gather the sentinel,
        pull the zero row, scatter out of range (unique ids past the
        arena — dropped) and carry node_mask 0."""
        M, A, R = self.frontier_width, self.A, self.num_rows
        k = len(ticks)
        ints = np.empty((k, M * (A + 2)), np.int32)
        child_ids = ints[:, :M * A].reshape(k, M, A)
        out_ids = ints[:, M * A:M * (A + 1)]
        ext_ids = ints[:, M * (A + 1):]
        child_ids[:] = R
        out_ids[:] = R + 1 + np.arange(M, dtype=np.int32)
        ext_ids[:] = R
        floats = np.zeros((k, M * (A + 1)), np.float32)
        child_mask = floats[:, :M * A].reshape(k, M, A)
        node_mask = floats[:, M * A:]
        for t, parts in enumerate(ticks):
            o = 0
            for dest, cids, cmask in parts:
                n = len(dest)
                out_ids[t, o: o + n] = dest
                ext_ids[t, o: o + n] = dest
                child_ids[t, o: o + n] = cids
                child_mask[t, o: o + n] = cmask
                node_mask[t, o: o + n] = 1.0
                o += n
        di = torch.from_numpy(ints).to(self.device)
        df = torch.from_numpy(floats).to(self.device)
        return (self.params, self._buf, di[:, :M * A].view(k, M, A),
                df[:, :M * A].view(k, M, A), self._ext, df[:, M * A:],
                di[:, M * A:M * (A + 1)], di[:, M * (A + 1):])

    def _run_window(self, args: Tuple) -> None:
        """One window through :meth:`_EngineBase._ladder`."""
        self._ladder(lambda: self._window(*args),
                     lambda: self._window_oracle(*args), self._buf.is_cuda,
                     self.device)

    # -- retirement -----------------------------------------------------------
    def _retire_expired(self) -> None:
        """Retire in-flight requests whose deadline passed; their arena
        rows return to the free list ZEROED."""
        expired = [a for a in self._active
                   if self.lifecycle.expired(a.req)]
        if not expired:
            return
        for a in expired:
            self.lifecycle.finish_timeout(a.req)
        self._release(expired)

    def _fail_inflight(self, reason: str) -> None:
        for a in self._active:
            self.lifecycle.finish_failed(a.req, reason)
        self._release(self._active)

    def _release(self, acts: List[_Active]) -> None:
        """Free (and zero, in place) the arena rows of retired requests:
        a dead request's states never linger in the arena."""
        rows = np.concatenate([a.rows for a in acts]) if acts else None
        gone = set(id(a) for a in acts)
        self._active = [a for a in self._active if id(a) not in gone]
        if rows is not None and rows.size:
            self._buf.index_fill_(0, torch.from_numpy(rows).to(self.device),
                                  0.0)
            self._free.extend(int(r) for r in rows)

    def _readback(self, done: List[_Active]):
        """The finished roots, out of the arena: one K6a launch on the card
        takes their rows by value and stores them to the device, for the
        heads, and into the pinned host buffer; the head runs over the
        device rows; then ONE sync (the logits' read, else the stream's)
        covers both.  Returns ``(roots on the host, roots on the device,
        logits or None)``; the host rows are a view of the buffer, valid
        until the next window."""
        n = len(done)
        if n > self._host.shape[0]:
            self._grow_host(1 << (n - 1).bit_length())
        ids = np.fromiter((a.root_row for a in done), np.int32, n)
        roots_dev = kops.gather_rows(self._buf, ids, host_out=self._host)
        logits = None
        if self.head is not None:
            with torch.no_grad():
                logits = self.head.logits(self.head_params, roots_dev) \
                    .cpu().numpy()
        elif roots_dev.is_cuda:
            torch.cuda.current_stream(roots_dev.device).synchronize()
        return self._host_np[:n], roots_dev, logits

    def _grow_host(self, rows: int) -> None:
        """(Re)allocate the retired roots' host buffer (page-locked on the
        card) at ``rows`` rows, and its numpy view."""
        self._host = gsc.host_rows(rows, self.fn.state_dim, torch.float32,
                                   self._buf.is_cuda)
        self._host_np = self._host.numpy()

    def _retire(self, done: List[_Active]) -> None:
        """Read the finished roots out of the arena (:meth:`_readback`, one
        sync) and route them through the readout heads — the lazy ``push``
        made immediate."""
        self.readbacks += 1
        with trace.span("cb.readback", count=len(done)):
            roots, roots_dev, logits = self._readback(done)
        ok: List[Tuple[int, ContinuousRequest]] = []
        for i, (a, root) in enumerate(zip(done, roots)):
            req = a.req
            if self.lifecycle.expired(req):
                self.lifecycle.finish_timeout(req)
                status = "timeout"
            elif self.guard_nonfinite and not np.isfinite(root).all():
                self.lifecycle.finish_failed(req, "non-finite root state")
                status = "failed"
            else:
                req.root_state = root.copy()
                ok.append((i, req))
                status = "ok"
            trace.instant("cb.retired", request=req.request_id,
                          status=status)
        self._release(done)
        if logits is not None:
            # One batched head call over every retired root; the rows of
            # requests that did not finish ok are dropped.
            for i, req in ok:
                req.logits = logits[i].copy()
                req.label = int(np.argmax(logits[i]))
        if ok and self.token_readout is not None:
            for i, req in ok:
                req.tokens = self.token_readout.generate(
                    self.token_params, self.params, roots_dev[i],
                    (self.seed, req.request_id),
                    max_tokens=self.max_new_tokens)
        for _, req in ok:
            self.lifecycle.finish_ok(req)

    # -- health ---------------------------------------------------------------
    def _health_extra(self) -> Dict[str, Any]:
        return {"active_requests": self.num_active,
                "free_rows": self.free_rows,
                "num_rows": self.num_rows,
                "frontier_width": self.frontier_width,
                "ticks": self.ticks, "windows": self.windows,
                "deferred": self.deferred, "lanes": self.lanes,
                "readbacks": self.readbacks,
                "plan_hits": self.plan_hits,
                "plan_misses": self.plan_misses,
                "breaker_open": self._breaker.open,
                "breaker_trips": self._breaker.trips}
