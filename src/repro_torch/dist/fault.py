"""Fault tolerance primitives (port of ``repro.dist.fault``): injection
(so tests exercise the trainer's recovery path), restart backoff
budgeting, heartbeat liveness tracking, and the pluggable
:class:`ChaosHook` the chaos tests drive.

The chaos machinery is process-global (``install_chaos`` context
manager + ``chaos_fire`` at each instrumented site): fault injection is
test machinery, and the sites it instruments span several modules whose
signatures should not all grow a ``chaos=`` parameter.  With no hook
installed every site is a single ``is None`` check.

Instrumented sites in this package:

  - ``"pack"``   — inside the schedule cache, right before a cold
    ``pack_batch`` (``pipeline/cache.py``);
  - ``"prefetch"`` — before each pack on the async packer's thread
    (``pipeline/prefetch.py``; retried in place);
  - ``"persist_load"`` / ``"persist_store"`` — the on-disk schedule
    store's read and write (``pipeline/persist.py``; a quiet miss or a
    counted store error);
  - ``"kernel"`` — right before a serve engine's fused batch
    (``serve/engine.py``; triggers the degradation ladder);
  - ``"ext"``    — via :meth:`ChaosHook.corrupt_ext`, which may overwrite
    per-sample external rows with NaN (exercises the non-finite output
    guard).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Set)

import numpy as np

from repro_torch.obs import trace


class SimulatedFailure(RuntimeError):
    """Raised by :class:`FaultInjector` / :class:`ChaosHook` to emulate
    a transient failure (node crash, kernel launch error, I/O fault).
    Retry-able by construction: the operation would succeed if re-run."""


class FaultInjector:
    """Raises :class:`SimulatedFailure` at the configured steps (once
    each).  ``failures`` records the steps that actually fired."""

    def __init__(self, fail_at_steps: Iterable[int]):
        self._pending = set(int(s) for s in fail_at_steps)
        self.failures: List[int] = []

    def tick(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            self.failures.append(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class RestartPolicy:
    """Exponential-backoff restart budget; ``record_success`` resets it.

    ``next_delay()`` returns the seconds to wait before the next restart
    attempt, or ``None`` once ``max_restarts`` attempts have been spent
    since the last success.
    """

    max_restarts: int = 3
    base_delay: float = 1.0
    max_delay: float = 60.0
    _attempts: int = 0

    def next_delay(self) -> Optional[float]:
        if self._attempts >= self.max_restarts:
            return None
        d = min(self.base_delay * (2.0 ** self._attempts), self.max_delay)
        self._attempts += 1
        return d

    def record_success(self) -> None:
        self._attempts = 0


class HeartbeatMonitor:
    """Tracks worker liveness by last-heartbeat age.

    ``sweep()`` moves workers whose last beat is older than ``timeout``
    to ``dead`` and returns the newly-dead ids.  A dead worker cannot
    silently ``beat`` its way back — it must ``rejoin``."""

    def __init__(self, workers: Sequence[str], timeout: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.alive: List[str] = list(workers)
        self.dead: set = set()
        self._last = {w: clock() for w in workers}

    def beat(self, worker: str) -> bool:
        if worker in self.dead or worker not in self._last:
            return False
        self._last[worker] = self.clock()
        return True

    def sweep(self) -> List[str]:
        now = self.clock()
        newly = [w for w in self.alive
                 if now - self._last[w] > self.timeout]
        for w in newly:
            self.alive.remove(w)
            self.dead.add(w)
        return newly

    def rejoin(self, worker: str) -> None:
        self.dead.discard(worker)
        if worker not in self.alive:
            self.alive.append(worker)
        self._last[worker] = self.clock()


# ---------------------------------------------------------------------------
# Chaos injection (the pluggable hook behind the chaos tests)
# ---------------------------------------------------------------------------

class ChaosHook:
    """Base chaos hook: a no-op at every site.  Subclass and override
    :meth:`fire` (raise :class:`SimulatedFailure` to inject a fault at
    an instrumented site) and/or :meth:`corrupt_ext` (return a poisoned
    external-input matrix to inject NaN batches)."""

    def fire(self, site: str) -> None:         # pragma: no cover - no-op
        """Called at each instrumented site; raise to inject a fault."""

    def corrupt_ext(self, ext: np.ndarray, sched) -> np.ndarray:
        """Called with every packed external matrix (``[K*N + 1, X]``)
        and its schedule; return a (possibly poisoned) matrix."""
        return ext


class ScriptedChaos(ChaosHook):
    """Deterministic chaos: fail the n-th call at a site.

    ``fail`` maps site name → 0-based call indices that raise
    :class:`SimulatedFailure`; ``nan_ext`` maps the 0-based index of a
    ``corrupt_ext`` call → the sample indices whose external rows are
    overwritten with NaN in that batch.  ``calls`` counts invocations
    per site and ``fired`` records which injections actually happened,
    so tests can assert the fault path was really exercised.
    """

    def __init__(self, fail: Optional[Dict[str, Iterable[int]]] = None,
                 nan_ext: Optional[Dict[int, Sequence[int]]] = None):
        self.fail: Dict[str, Set[int]] = {
            site: set(int(i) for i in idxs)
            for site, idxs in (fail or {}).items()}
        self.nan_ext = {int(c): tuple(int(k) for k in ks)
                        for c, ks in (nan_ext or {}).items()}
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, List[int]] = {}

    def _count(self, site: str) -> int:
        n = self.calls.get(site, 0)
        self.calls[site] = n + 1
        return n

    def fire(self, site: str) -> None:
        n = self._count(site)
        if n in self.fail.get(site, ()):
            self.fired.setdefault(site, []).append(n)
            raise SimulatedFailure(
                f"chaos: injected {site} failure (call {n})")

    def corrupt_ext(self, ext: np.ndarray, sched) -> np.ndarray:
        n = self._count("ext")
        samples = self.nan_ext.get(n)
        if not samples:
            return ext
        self.fired.setdefault("ext", []).append(n)
        ext = np.array(ext, copy=True)
        N = sched.N
        for k in samples:
            # Poison sample k's whole external block; NaN flows only
            # into sample k's vertices (blocks are per-sample, §3.3).
            ext[k * N: (k + 1) * N] = np.nan
        return ext


_CHAOS: Optional[ChaosHook] = None


def get_chaos() -> Optional[ChaosHook]:
    """The currently installed chaos hook (``None`` outside the suite)."""
    return _CHAOS


@contextlib.contextmanager
def install_chaos(hook: ChaosHook):
    """Install ``hook`` process-wide for the duration of the block
    (nested installs restore the previous hook on exit)."""
    global _CHAOS
    prev = _CHAOS
    _CHAOS = hook
    try:
        yield hook
    finally:
        _CHAOS = prev


def chaos_fire(site: str) -> None:
    """Instrumentation call sites use this: no hook → free; a hook may
    raise :class:`SimulatedFailure` to inject a fault.  An injection
    that actually fires is also emitted as a ``chaos.fired`` trace
    instant, so chaos runs show up on the span timeline at the exact
    point in the pipeline they hit."""
    if _CHAOS is not None:
        try:
            _CHAOS.fire(site)
        except SimulatedFailure:
            trace.instant("chaos.fired", site=site)
            raise


def chaos_corrupt_ext(ext: np.ndarray, sched) -> np.ndarray:
    """Give the installed hook a chance to poison a packed external
    matrix (NaN-batch injection); identity when no hook is installed.
    A batch the hook actually rewrote is marked with a
    ``chaos.ext_poisoned`` trace instant."""
    if _CHAOS is None:
        return ext
    out = _CHAOS.corrupt_ext(ext, sched)
    if out is not ext:
        trace.instant("chaos.ext_poisoned", site="ext")
    return out
