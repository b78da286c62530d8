"""Process-global tracing: nested spans, correlation ids, near-zero
cost when disabled (the part of ``repro.obs.trace`` the serving path
uses; Chrome-trace export and ``REPRO_TRACE`` activation are not ported
yet).

With no tracer installed every call site is one global load plus an
``is None`` check.  ``install_tracer(Tracer())`` turns spans on; then
:func:`maybe_block` synchronises the card so a span measures execution
rather than the enqueue.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = ["Span", "Tracer", "span", "instant", "correlate",
           "maybe_block", "get_tracer", "install_tracer"]


class Span:
    """One finished trace event: ``ts``/``dur`` in perf_counter
    nanoseconds; ``ph`` is "X" (complete) or "i" (instant)."""

    __slots__ = ("name", "ts", "dur", "tid", "cid", "attrs", "ph")

    def __init__(self, name: str, ts: int, dur: int, tid: int,
                 cid: Optional[Dict[str, Any]],
                 attrs: Optional[Dict[str, Any]], ph: str = "X"):
        self.name = name
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.cid = cid
        self.attrs = attrs
        self.ph = ph

    @property
    def dur_ms(self) -> float:
        return self.dur / 1e6

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "ms": round(self.dur_ms, 4)}
        if self.cid:
            d.update(self.cid)
        return d


class _Tls(threading.local):
    def __init__(self):
        self.cid: Dict[str, Any] = {}


class Tracer:
    """Collects spans into a bounded deque."""

    def __init__(self, max_spans: int = 100_000):
        self.spans: "collections.deque[Span]" = collections.deque(
            maxlen=max_spans)
        self._lock = threading.Lock()
        self._tls = _Tls()

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        cid = self._tls.cid
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            sp = Span(name, t0, time.perf_counter_ns() - t0,
                      threading.get_ident(), dict(cid) if cid else None,
                      attrs or None)
            with self._lock:
                self.spans.append(sp)

    def instant(self, name: str, **attrs: Any) -> None:
        cid = self._tls.cid
        sp = Span(name, time.perf_counter_ns(), 0, threading.get_ident(),
                  dict(cid) if cid else None, attrs or None, ph="i")
        with self._lock:
            self.spans.append(sp)

    @contextlib.contextmanager
    def correlate(self, **ids: Any):
        tls = self._tls
        prev = tls.cid
        tls.cid = {**prev, **{k: v for k, v in ids.items()
                              if v is not None}}
        try:
            yield
        finally:
            tls.cid = prev

    def summary(self, last_n: int = 10) -> List[Dict[str, Any]]:
        """The last ``last_n`` spans, newest last (``health()``)."""
        with self._lock:
            tail = list(self.spans)[-last_n:]
        return [sp.as_dict() for sp in tail]

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.spans)


_TRACER: Optional[Tracer] = None


class _NullCtx:
    """Reusable no-op context manager: the disabled-span fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def get_tracer() -> Optional[Tracer]:
    return _TRACER


@contextlib.contextmanager
def install_tracer(tracer: Optional[Tracer]):
    """Install ``tracer`` process-wide for the duration of the block."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    try:
        yield tracer
    finally:
        _TRACER = prev


def span(name: str, **attrs: Any):
    """A (possibly no-op) context manager timing the block as ``name``."""
    t = _TRACER
    if t is None:
        return _NULL
    return t.span(name, **attrs)


def instant(name: str, **attrs: Any) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, **attrs)


def correlate(**ids: Any):
    """Stamp spans begun inside the block (this thread) with ``ids``."""
    t = _TRACER
    if t is None:
        return _NULL
    return t.correlate(**ids)


def maybe_block(x: torch.Tensor) -> torch.Tensor:
    """``torch.cuda.synchronize()`` ONLY while a tracer is installed and
    ``x`` lies on the card — brackets device work so a span measures
    execution, not the enqueue, without serialising untraced runs.
    Returns ``x``."""
    if _TRACER is not None and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x
