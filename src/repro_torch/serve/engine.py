"""Whole-structure serving: :class:`StructureServeEngine`, the port of
the request/response engine of ``repro.serve.engine``.

Request/response serving of WHOLE structures (trees/DAGs, e.g. a
sentiment service scoring parsed sentences), routed through the
schedule pipeline (``repro_torch.pipeline``): each dequeued batch is
fingerprinted, looked up in the schedule cache (repeated topologies skip
``pack_batch`` and the host→device copy), padded to bucket boundaries,
and executed as one fused batched forward — one hand-written megastep
launch per level on the card.

The engine shares the robustness layer (``serve/robustness.py``):
``submit`` validates at the door and REJECTS (terminal status, never an
exception) on garbage or a full queue; every request carries an optional
``ttl`` that becomes a hard deadline; every submitted request reaches
exactly one terminal status (``ok``/``timeout``/``rejected``/``failed``)
and lands in ``engine.finished``; ``engine.health()`` reports queue
depth, oldest wait, deadline misses, degradations and quarantines.  On
CPU tensors the fused forward degrades to the op-by-op oracle on
failure (a :class:`~repro_torch.serve.robustness.CircuitBreaker` pins
the oracle after ``breaker_threshold`` consecutive failures); every such
degradation is counted in ``health()["degradations"]`` and its cause
kept in ``last_degradation``.  On the card there is no such ladder: a
kernel that fails to build or launch fails the batch, so the plain
version never stands in for the kernel there.  Poisoned batches are quarantined by bisection so one bad
request never takes down its co-batched peers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.scheduler import execute, readout_roots
from repro_torch.core.structure import DeviceSchedule, InputGraph
from repro_torch.dist.fault import chaos_fire
from repro_torch.obs import trace
from repro_torch.pipeline import (BucketPolicy, SchedulePipeline,
                                  graph_fingerprint)
from repro_torch.serve.robustness import (ACTIVE, CircuitBreaker,
                                          RequestLifecycle,
                                          quarantine_bisect,
                                          validate_structure)

Params = Any


class _EngineBase:
    """Lifecycle plumbing: ``queue`` and ``finished`` are views onto the
    :class:`RequestLifecycle` (so the bounded-queue/terminal-status
    invariants cannot be bypassed), and ``health()`` is the lifecycle's
    counters plus engine extras, the pipeline's schedule-cache stats,
    and — when tracing is on — a summary of the most recent spans."""

    lifecycle: RequestLifecycle
    pipeline: SchedulePipeline

    @property
    def queue(self) -> List[Any]:
        return self.lifecycle.queue

    @queue.setter
    def queue(self, reqs: List[Any]) -> None:
        self.lifecycle.queue = list(reqs)

    @property
    def finished(self) -> List[Any]:
        return self.lifecycle.finished

    def health(self) -> Dict[str, Any]:
        h = self.lifecycle.health(**self._health_extra())
        h["schedule_cache"] = self.pipeline.stats()
        t = trace.get_tracer()
        if t is not None:
            h["recent_spans"] = t.summary(10)
        return h

    def _health_extra(self) -> Dict[str, Any]:
        return {}


@dataclasses.dataclass
class StructureRequest:
    """One structure to score: the topology ``G`` plus its per-node
    external inputs ``[num_nodes, X_raw]``.  The engine fills
    ``root_state`` (``[S]``) — the batched readout of the root vertex."""

    request_id: int
    graph: InputGraph
    inputs: np.ndarray
    ttl: Optional[float] = None      # seconds from submit to deadline
    # -- filled by the engine ------------------------------------------
    root_state: Optional[np.ndarray] = None
    done: bool = False
    status: str = "new"              # lifecycle: serve/robustness.py
    error: Optional[str] = None


class StructureServeEngine(_EngineBase):
    """Batch scoring of queued structures through the schedule pipeline.

    Each :meth:`step` dequeues up to ``batch_size`` requests and runs
    ONE batched fused forward over them on ``device`` (default the card;
    pass ``device="cpu"`` for the plain versions).  Params must live on
    that device.

    ``compose=True`` (default) anchors each batch on the oldest pending
    request (no starvation) and fills it with every queued request
    sharing its topology fingerprint first — the batch most likely to be
    a schedule-cache hit — then tops it up FIFO.
    """

    def __init__(self, fn, params: Params, *, batch_size: int = 16,
                 pipeline: Optional[SchedulePipeline] = None,
                 fusion_mode: str = "auto", compose: bool = True,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 breaker_threshold: int = 3,
                 guard_nonfinite: bool = True,
                 device="cuda"):
        self.fn = fn
        self.params = params
        self.batch_size = batch_size
        self.compose = compose
        self.device = torch.device(device)
        self.pipeline = pipeline if pipeline is not None else \
            SchedulePipeline(fn.input_dim,
                             bucket_policy=BucketPolicy(mode="pow2"),
                             # forward-only consumer: pack without the
                             # backward's sorted-run arrays
                             with_runs=False, device=self.device)
        self.lifecycle = RequestLifecycle(max_queue=max_queue, clock=clock)
        self._breaker = CircuitBreaker(breaker_threshold)
        #: a request whose finite inputs still produced a non-finite
        #: root state fails ALONE — NaNs are block-diagonal in the
        #: batched forward, so attribution is direct.
        self.guard_nonfinite = guard_nonfinite
        self._fusion = fusion_mode
        self.batches = 0
        #: repr of the exception behind the latest fused → oracle
        #: degradation (``None`` while there has been none).
        self.last_degradation: Optional[str] = None

    # -- ingress ------------------------------------------------------------
    def submit(self, req: StructureRequest) -> bool:
        """Validate + enqueue; returns False (and routes ``req`` to the
        ``rejected`` terminal) on a malformed structure, non-finite
        inputs, a full queue, or a double-submitted request object."""
        err = validate_structure(req.graph, req.inputs, self.fn.input_dim)
        if err is not None:
            err = f"request {req.request_id}: {err}"
        return self.lifecycle.submit(req, err)

    @property
    def fused(self) -> bool:
        """True while batches attempt the fused forward (False once the
        circuit breaker has pinned the op-by-op oracle, which only the
        CPU ladder does)."""
        return self._fusion != "none" and not self._breaker.open

    # -- one engine batch ----------------------------------------------------
    def step(self) -> int:
        """Score one batch of queued requests.  Returns requests still
        queued after the batch."""
        self.lifecycle.sweep_deadlines()
        if not self.queue:
            return 0
        with trace.span("serve.flush"):
            reqs = (self._compose_flush() if self.compose
                    else self.queue[: self.batch_size])
        taken = set(id(r) for r in reqs)   # by identity: requests hold
        self.queue = [r for r in self.queue  # ndarrays, so == is unusable
                      if id(r) not in taken]
        for r in reqs:
            r.status = ACTIVE

        poisoned = [False]

        def run_fn(batch_reqs):
            try:
                return self._run_batch(batch_reqs)
            except Exception:
                poisoned[0] = True
                raise

        def on_fail(req, exc):
            self.lifecycle.finish_failed(
                req, f"batch execution failed: {exc}")

        with trace.span("serve.batch", size=len(reqs)):
            pairs = quarantine_bisect(list(reqs), run_fn, on_fail)
        if poisoned[0]:
            self.lifecycle.quarantines += 1
        self.batches += 1
        for req, root in pairs:
            if self.guard_nonfinite and not np.isfinite(root).all():
                self.lifecycle.finish_failed(req, "non-finite root state")
                continue
            req.root_state = root.copy()
            self.lifecycle.finish_ok(req)
        return len(self.queue)

    def run(self, max_batches: int = 10_000) -> List[StructureRequest]:
        """Drain the queue; returns finished requests."""
        for _ in range(max_batches):
            if self.step() == 0:
                break
        return self.finished

    # -- internals ----------------------------------------------------------
    def _compose_flush(self) -> List[StructureRequest]:
        """The batch to flush: anchored on the OLDEST pending request,
        filled with same-fingerprint peers from anywhere in the queue,
        topped up FIFO when the group runs short."""
        anchor_fp = graph_fingerprint(self.queue[0].graph)
        batch = [r for r in self.queue
                 if graph_fingerprint(r.graph) == anchor_fp]
        batch = batch[: self.batch_size]
        if len(batch) < self.batch_size:
            chosen = set(id(r) for r in batch)
            for r in self.queue:
                if len(batch) >= self.batch_size:
                    break
                if id(r) not in chosen:
                    batch.append(r)
        return batch

    def _run_batch(self, reqs: List[StructureRequest]) -> List[np.ndarray]:
        """Pack + score one (sub-)batch; per-request root-state rows.
        Raises on pack or kernel failure — the quarantine bisect above
        narrows the blast radius to the poisoned request."""
        batch = self.pipeline.pack([r.graph for r in reqs],
                                   [np.asarray(r.inputs, np.float32)
                                    for r in reqs])
        with trace.span("serve.score", size=len(reqs), fused=self.fused):
            roots = self._score(batch.dev, batch.ext).cpu().numpy()
        return [roots[k] for k in range(len(reqs))]

    def _score(self, dev: DeviceSchedule, ext: torch.Tensor) -> torch.Tensor:
        """The fused forward.  On the card a failure propagates (the
        quarantine bisect then fails the batch).  On CPU tensors, the
        degradation ladder: on failure fall back to the op-by-op oracle
        for THIS batch (counted), and once the breaker trips, pin the
        oracle without re-trying the fused path."""
        if not self.fused:
            return _structure_batch(self.fn, "none", self.params, dev, ext)
        if ext.is_cuda:
            chaos_fire("kernel")
            out = _structure_batch(self.fn, self._fusion, self.params,
                                   dev, ext)
            # Surface an asynchronous kernel fault here, where it happened.
            torch.cuda.synchronize(out.device)
            return out
        try:
            chaos_fire("kernel")
            out = _structure_batch(self.fn, self._fusion, self.params,
                                   dev, ext)
            self._breaker.record_success()
            return out
        except Exception as e:           # noqa: BLE001 — degrade, counted
            self._breaker.record_failure()
            self.lifecycle.degradations += 1
            self.last_degradation = repr(e)
        return _structure_batch(self.fn, "none", self.params, dev, ext)

    def _health_extra(self) -> Dict[str, Any]:
        return {"batches": self.batches,
                "breaker_open": self._breaker.open,
                "breaker_trips": self._breaker.trips}


def _structure_batch(fn, fusion_mode: str, params: Params,
                     dev: DeviceSchedule, ext: torch.Tensor) -> torch.Tensor:
    """One batched forward over a packed request batch → ``[K, S]``
    root states."""
    with torch.inference_mode():
        buf = execute(fn, params, dev, ext, fusion_mode=fusion_mode).buf
        return readout_roots(buf, dev)
