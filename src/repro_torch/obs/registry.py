"""One metrics surface (port of ``repro.obs.registry``): labelled
counters (``inc``), last-written gauges (``set_gauge``, e.g. the batch
composer's stats), windowed histograms (``observe``, with
count/mean/p50/max stats; the trainer's ``MetricLogger`` writes its
scalars here) and live stats providers (``register_provider``), read
together by ``snapshot()``.

Providers are held via ``weakref.WeakMethod`` when possible, so
registering a pipeline or an engine never extends its lifetime.

The process-global instance (:func:`get_registry`) is what the kernel
dispatch, the pipelines and the trainer write to; tests swap a fresh one
in with :func:`fresh_registry` (or :func:`set_registry`, restoring the
old one after).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["MetricsRegistry", "get_registry", "set_registry",
           "fresh_registry"]


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe counters, gauges and windowed histograms + weakly held
    providers."""

    def __init__(self, hist_window: int = 1024) -> None:
        self.hist_window = hist_window
        self._lock = threading.Lock()
        self._counters: collections.Counter = collections.Counter()
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, collections.deque] = {}
        self._hist_counts: collections.Counter = collections.Counter()
        self._providers: Dict[str, Callable[[], Any]] = {}

    def inc(self, name: str, n: int = 1, **labels: Any) -> None:
        with self._lock:
            self._counters[_key(name, labels)] += n

    def counter(self, name: str, **labels: Any) -> int:
        with self._lock:
            return self._counters.get(_key(name, labels), 0)

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def gauge(self, name: str, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def observe(self, name: str, value: float, **labels: Any) -> None:
        """Append ``value`` to the histogram ``name`` (the last
        ``hist_window`` values are kept; the count is of all)."""
        k = _key(name, labels)
        with self._lock:
            d = self._hists.get(k)
            if d is None:
                d = self._hists[k] = collections.deque(
                    maxlen=self.hist_window)
            d.append(float(value))
            self._hist_counts[k] += 1

    def hist_stats(self, name: str, **labels: Any
                   ) -> Optional[Dict[str, float]]:
        """``count`` (every observation), and ``window``/``mean``/
        ``p50``/``max``/``total`` over the kept window; ``None`` for a
        histogram never observed."""
        k = _key(name, labels)
        with self._lock:
            d = self._hists.get(k)
            if not d:
                return None
            arr = np.asarray(d, np.float64)
            count = self._hist_counts[k]
        return {"count": int(count),
                "window": int(arr.size),
                "mean": float(arr.mean()),
                "p50": float(np.median(arr)),
                "max": float(arr.max()),
                "total": float(arr.sum())}

    def register_provider(self, name: str, fn: Callable[[], Any]) -> str:
        """Register a zero-arg stats callable under ``name``; bound
        methods are held weakly (a dead owner auto-unregisters).  On a
        live-name collision the name is suffixed ``#2``, ``#3``, … —
        the actual name used is returned."""
        ref: Callable[[], Any]
        if hasattr(fn, "__self__"):
            ref = weakref.WeakMethod(fn)
        else:
            ref = lambda f=fn: f  # noqa: E731 - strong ref, same shape
        with self._lock:
            base, n = name, 1
            while name in self._providers:
                if self._providers[name]() is None:  # dead — reuse slot
                    break
                n += 1
                name = f"{base}#{n}"
            self._providers[name] = ref
        return name

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    def snapshot(self) -> Dict[str, Any]:
        """``counters``, ``gauges``, ``histograms`` (stats per key) and
        ``providers`` (each live provider's own stats dict; dead
        providers are pruned)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hist_keys = list(self._hists)
            providers = list(self._providers.items())
        hists = {}
        for k in hist_keys:
            s = self.hist_stats(k)
            if s is not None:
                hists[k] = s
        out: Dict[str, Any] = {"counters": counters, "gauges": gauges,
                               "histograms": hists, "providers": {}}
        dead = []
        for name, ref in providers:
            fn = ref()
            if fn is None:
                dead.append(name)
                continue
            try:
                out["providers"][name] = fn()
            except Exception as e:  # noqa: BLE001 - one bad provider
                out["providers"][name] = {"error": repr(e)}
        if dead:
            with self._lock:
                for name in dead:
                    self._providers.pop(name, None)
        return out

    def reset(self) -> None:
        """Zero counters/gauges/histograms (providers stay registered)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._hist_counts.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry."""
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Make ``registry`` the process-global one (the caller restores the
    previous one; :func:`fresh_registry` does both)."""
    global _REGISTRY
    _REGISTRY = registry
    return registry


@contextlib.contextmanager
def fresh_registry(hist_window: int = 1024):
    """Swap a fresh global registry in for the duration of the block."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = MetricsRegistry(hist_window=hist_window)
    try:
        yield _REGISTRY
    finally:
        _REGISTRY = prev
