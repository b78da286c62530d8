"""Request-lifecycle guards for the serve engines (the robustness layer),
a port of ``repro.serve.robustness`` (NumPy only).

Production serving means adversarial per-example structure: malformed
graphs, NaN payloads, unbounded queues, requests whose callers stopped
waiting.  The Cavs batching machinery (§4) presumes the scheduler
survives all of it — this module is the layer that makes that true for
the engines in ``serve/engine.py``:

  - **status lifecycle** — every request moves ``new → pending →
    active → {ok | timeout | rejected | failed}``; the terminal states
    are the engine's contract: *every submitted request reaches exactly
    one terminal status* (the chaos suite's invariant).  Rejected and
    timed-out requests land in ``engine.finished`` like completed ones,
    so no caller ever polls a request that silently vanished;
  - **bounded admission** — :class:`RequestLifecycle` owns a bounded
    queue; ``submit`` past ``max_queue`` REJECTS with explicit
    backpressure instead of growing without bound, and submit-time
    validation (finite inputs, in-range child ids, acyclic topology)
    turns garbage into a ``rejected`` terminal before it can reach a
    kernel;
  - **deadlines** — a per-request ``ttl`` becomes an absolute deadline
    at submit; expired queued requests are swept to ``timeout`` before
    each batch, and in-flight requests are retired at the first tick
    past their deadline;
  - **poison quarantine** — :func:`quarantine_bisect` re-runs a failing
    batch by bisection so the offending request fails ALONE while its
    co-batched peers complete (states bit-identical to a fault-free
    run, since per-sample computation is independent of co-tenants);
  - **degradation ladder** — :class:`CircuitBreaker` counts consecutive
    fused-kernel failures and pins the op-by-op oracle after ``K`` of
    them, so a persistently broken fast path degrades to a slow correct
    one instead of failing every batch twice.  The engine climbs it on
    CPU tensors only: on the card a kernel fault fails the batch.

Everything here is host-side bookkeeping — the kernels are untouched
(the Cavs property: robustness is data too).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# -- the status lifecycle ----------------------------------------------------

#: Not yet submitted / waiting in the queue / taken into a batch or slot.
NEW, PENDING, ACTIVE = "new", "pending", "active"
#: Terminal statuses — exactly one per submitted request, ever.
OK, TIMEOUT, REJECTED, FAILED = "ok", "timeout", "rejected", "failed"
TERMINAL = frozenset((OK, TIMEOUT, REJECTED, FAILED))


class CircuitBreaker:
    """Trips open after ``threshold`` CONSECUTIVE failures; any success
    closes it again.  Open = "pin the fallback path" (for the serve
    engines: ``fusion_mode='none'``, the op-by-op oracle)."""

    def __init__(self, threshold: int = 3):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self.consecutive_failures = 0
        self.trips = 0                    # times the breaker opened

    @property
    def open(self) -> bool:
        return self.consecutive_failures >= self.threshold

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.consecutive_failures == self.threshold:
            self.trips += 1

    def record_success(self) -> None:
        self.consecutive_failures = 0


class RequestLifecycle:
    """Shared lifecycle bookkeeping for a serve engine: the bounded
    queue, terminal routing, deadline sweeps and health counters.

    The engine owns request semantics (what "run" means); this class
    owns the invariant that every submitted request ends in exactly one
    terminal status and is observable in ``finished``.
    """

    def __init__(self, *, max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        self.max_queue = max_queue
        self.clock = clock
        self.queue: List[Any] = []
        self.finished: List[Any] = []
        self.rejected = 0
        self.timeouts = 0                 # deadline misses
        self.failures = 0
        self.completed = 0
        self.degradations = 0             # fused → oracle fallbacks
        self.quarantines = 0              # batches that entered bisection

    # -- admission --------------------------------------------------------
    def submit(self, req: Any, error: Optional[str] = None) -> bool:
        """Admit ``req`` to the queue, or reject it terminally.

        ``error`` carries a validation failure detected by the engine;
        a full queue rejects with explicit backpressure.  Returns True
        iff the request was queued.  Double-submission of a live or
        finished request object is itself a rejection (the engines fill
        requests in place — one object, one lifecycle).
        """
        if getattr(req, "status", NEW) != NEW:
            # Re-submitting a queued/in-flight/terminal object would
            # give it two lifecycles; refuse WITHOUT disturbing the
            # first one (the object keeps its current status) — counted
            # as a rejection, but not terminally routed again.
            self.rejected += 1
            return False
        if error is None and self.max_queue is not None \
                and len(self.queue) >= self.max_queue:
            error = (f"queue full ({len(self.queue)}/{self.max_queue}): "
                     f"backpressure — retry later")
        if error is not None:
            self._finish(req, REJECTED, error)
            self.rejected += 1
            return False
        req.status = PENDING
        req.error = None
        req._enqueued_at = self.clock()
        ttl = getattr(req, "ttl", None)
        req._deadline = (req._enqueued_at + float(ttl)
                         if ttl is not None else None)
        self.queue.append(req)
        return True

    # -- deadlines --------------------------------------------------------
    def expired(self, req: Any) -> bool:
        d = getattr(req, "_deadline", None)
        return d is not None and self.clock() > d

    def sweep_deadlines(self) -> int:
        """Move deadline-expired QUEUED requests to the ``timeout``
        terminal; returns how many expired.  In-flight requests are the
        engine's to retire (it knows what partial output means)."""
        expired = [r for r in self.queue if self.expired(r)]
        if not expired:
            return 0
        self.queue = [r for r in self.queue if not self.expired(r)]
        for r in expired:
            self.finish_timeout(r)
        return len(expired)

    # -- terminal routing -------------------------------------------------
    def _finish(self, req: Any, status: str, error: Optional[str]) -> None:
        req.status = status
        req.error = error
        req.done = True
        req._finished_at = self.clock()   # latency = this - _enqueued_at
        self.finished.append(req)

    def finish_ok(self, req: Any) -> None:
        req.status = OK
        req.error = None
        req.done = True
        req._finished_at = self.clock()
        self.completed += 1
        self.finished.append(req)

    def finish_failed(self, req: Any, reason: str) -> None:
        self._finish(req, FAILED, reason)
        self.failures += 1

    def finish_timeout(self, req: Any) -> None:
        self._finish(req, TIMEOUT,
                     "deadline exceeded (ttl=%.6gs)" % req.ttl)
        self.timeouts += 1

    # -- health -----------------------------------------------------------
    def oldest_wait(self) -> float:
        """Seconds the oldest queued request has been waiting (0.0 when
        the queue is empty) — the backpressure early-warning metric."""
        if not self.queue:
            return 0.0
        now = self.clock()
        return max(now - getattr(r, "_enqueued_at", now)
                   for r in self.queue)

    def health(self, **extra: Any) -> Dict[str, Any]:
        h = {
            "queue_depth": len(self.queue),
            "oldest_wait_s": self.oldest_wait(),
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failures,
            "deadline_misses": self.timeouts,
            "degradations": self.degradations,
            "quarantines": self.quarantines,
        }
        h.update(extra)
        return h


# -- submit-time validation --------------------------------------------------

def validate_finite(x: np.ndarray, what: str = "inputs") -> Optional[str]:
    """Reject non-finite payloads at the door — NaN/Inf must never reach
    a kernel through the front door (chaos can still inject them past
    admission; the non-finite OUTPUT guard catches those)."""
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.number):
        return f"{what} must be numeric, got dtype {x.dtype}"
    if np.issubdtype(x.dtype, np.floating) and not np.isfinite(x).all():
        bad = int(np.size(x) - np.isfinite(x).sum())
        return f"{what} contain {bad} non-finite value(s)"
    return None


def validate_structure(graph, inputs: np.ndarray,
                       input_dim: Optional[int] = None) -> Optional[str]:
    """Submit-time validation of a whole-structure request: non-empty,
    input rows match nodes, in-range child ids, acyclic (topo-orderable)
    topology, finite payload.  Returns a reason string, or None."""
    if graph.num_nodes < 1:
        return "empty structure"
    inputs = np.asarray(inputs)
    if inputs.ndim != 2:
        return f"inputs must be [num_nodes, X], got shape {inputs.shape}"
    if inputs.shape[0] != graph.num_nodes:
        return (f"{inputs.shape[0]} input rows for "
                f"{graph.num_nodes} nodes")
    if input_dim is not None and inputs.shape[1] != input_dim:
        return (f"input dim {inputs.shape[1]} != vertex input_dim "
                f"{input_dim}")
    n = graph.num_nodes
    for v, ch in enumerate(graph.children):
        for c in ch:
            if not (0 <= c < n):
                return f"node {v} has out-of-range child {c}"
    try:
        graph.levels()                   # raises on cycles
    except ValueError as e:
        return str(e)
    return validate_finite(inputs)


def validate_sequence(inputs: np.ndarray,
                      input_dim: Optional[int] = None) -> Optional[str]:
    """Submit-time validation of a streaming-sequence request: ``[L >= 1,
    X]`` rows of the cell's input width, finite."""
    inputs = np.asarray(inputs)
    if inputs.ndim != 2 or inputs.shape[0] < 1:
        return f"inputs must be [L >= 1, X], got shape {inputs.shape}"
    if input_dim is not None and inputs.shape[1] != input_dim:
        return (f"input dim {inputs.shape[1]} != vertex input_dim "
                f"{input_dim}")
    return validate_finite(inputs)


def validate_prompt(prompt: np.ndarray, max_len: int,
                    max_new_tokens: int) -> Optional[str]:
    """Submit-time validation of a token-prompt request."""
    prompt = np.asarray(prompt)
    if prompt.ndim != 1 or prompt.shape[0] < 1:
        return f"prompt must be a non-empty 1-D token array, got " \
               f"shape {prompt.shape}"
    if not np.issubdtype(prompt.dtype, np.integer):
        return f"prompt must be integer tokens, got dtype {prompt.dtype}"
    if (prompt < 0).any():
        return "prompt contains negative token ids"
    if prompt.shape[0] >= max_len:
        return (f"prompt length {prompt.shape[0]} >= engine max_len "
                f"{max_len}")
    if max_new_tokens < 1:
        return f"max_new_tokens must be >= 1, got {max_new_tokens}"
    return None


# -- poison quarantine -------------------------------------------------------

def quarantine_bisect(reqs: Sequence[Any],
                      run_fn: Callable[[Sequence[Any]], Sequence[Any]],
                      on_fail: Callable[[Any, BaseException], None],
                      ) -> List[Tuple[Any, Any]]:
    """Run ``run_fn`` over ``reqs``; on failure, bisect until the poison
    is isolated.  Returns ``(request, result)`` pairs for every request
    that completed; each failing SINGLETON gets ``on_fail(req, exc)``
    instead — so one poisoned request costs ``O(log B)`` extra batch
    runs and takes down nobody else.

    ``run_fn`` must be per-request independent (true of the batched
    forward: each graph's vertices occupy disjoint slots), so a
    successful half's results are identical to a fault-free run's.
    """
    try:
        results = run_fn(reqs)
        return list(zip(reqs, results))
    except Exception as e:               # noqa: BLE001 — quarantine all
        if len(reqs) == 1:
            on_fail(reqs[0], e)
            return []
        mid = len(reqs) // 2
        out = quarantine_bisect(reqs[:mid], run_fn, on_fail)
        out += quarantine_bisect(reqs[mid:], run_fn, on_fail)
        return out
