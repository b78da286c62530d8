"""One metrics surface (the part of ``repro.obs.registry`` the serving
and pipeline paths use): labelled counters (``inc``), last-written
gauges (``set_gauge``, e.g. the batch composer's stats) and live stats
providers (``register_provider``), read together by ``snapshot()``.

Providers are held via ``weakref.WeakMethod`` when possible, so
registering a pipeline or an engine never extends its lifetime.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, Callable, Dict, Optional

__all__ = ["MetricsRegistry", "get_registry"]


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe counters and gauges + weakly held providers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: collections.Counter = collections.Counter()
        self._gauges: Dict[str, float] = {}
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

    def snapshot(self) -> Dict[str, Any]:
        """``counters``, ``gauges`` and ``providers`` (each live
        provider's own stats dict; dead providers are pruned)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            providers = list(self._providers.items())
        out: Dict[str, Any] = {"counters": counters, "gauges": gauges,
                               "providers": {}}
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
        """Zero the counters and gauges (providers stay registered)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry."""
    return _REGISTRY
