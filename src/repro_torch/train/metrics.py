"""Scalar metric accounting for the training loop (port of
``repro.train.metrics``).

:class:`MetricLogger` is a thin view over the metrics registry
(``repro_torch.obs.registry``): every windowed metric is mirrored as a
``train.<key>`` histogram observation, every monotone counter as a
``train.<key>`` registry counter, and the logger registers itself as a
``metrics`` snapshot provider, so one ``get_registry().snapshot()`` sees
training scalars next to cache stats, composition stats and kernel
dispatches.  The logger keeps its own small windows for cheap local
reads (``mean``/``history``).

Metric values may be 0-d tensors on the card: :meth:`step` reads each
with one ``float()`` (a device sync), and the trainer calls it only at
its log cadence, not every step.

Two throughput buckets, deliberately distinct:

  - ``sec_per_step``       — mean wall time BETWEEN ``step()`` calls:
    everything the loop does (checkpointing and logging included);
  - ``train_sec_per_step`` — mean of the explicit per-step train-work
    measurements fed via :meth:`train_tick` (the trainer's step from
    the batch on the device to the optimizer update).

``history`` is a bounded deque (``history_cap`` rows, default 1024); the
registry's windowed histograms are the durable aggregate view.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.obs.registry import get_registry


class MetricLogger:
    """Running windows of scalar metrics + throughput accounting,
    write-through to the metrics registry."""

    def __init__(self, window: int = 50, tokens_per_step: int = 0,
                 log_fn=print, history_cap: int = 1024):
        self.window = window
        self.tokens_per_step = tokens_per_step
        self.log_fn = log_fn
        self._hist: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._t_last: Optional[float] = None
        self._step_times: collections.deque = collections.deque(maxlen=window)
        self._train_times: collections.deque = collections.deque(
            maxlen=window)
        #: Bounded recent-row window (aggregates live in the registry's
        #: histograms).
        self.history: collections.deque = collections.deque(
            maxlen=history_cap)
        #: monotone event counters (e.g. the trainer's
        #: ``nonfinite_skips``) — health surface, not windowed stats.
        self.counters: collections.Counter = collections.Counter()
        self._registry = get_registry()
        self._registry.register_provider("metrics", self.snapshot)

    def count(self, key: str, n: int = 1) -> int:
        """Bump (and return) the monotone counter ``key`` (mirrored as
        the registry counter ``train.<key>``)."""
        self.counters[key] += n
        self._registry.inc(f"train.{key}", n)
        return self.counters[key]

    def train_tick(self, sec: float) -> None:
        """Record one step's measured train work — feeds
        ``train_sec_per_step``, which excludes checkpoint and log time by
        construction (the ``sec_per_step`` inter-call gap includes it)."""
        self._train_times.append(float(sec))
        self._registry.observe("train.train_sec_per_step", float(sec))

    def step(self, step: int, metrics: Dict[str, Any]) -> Dict[str, float]:
        now = time.perf_counter()
        if self._t_last is not None:
            self._step_times.append(now - self._t_last)
        self._t_last = now
        row = {"step": float(step)}
        for k, v in metrics.items():
            val = float(v)
            self._hist[k].append(val)
            self._registry.observe(f"train.{k}", val)
            row[k] = val
        if self._step_times:
            dt = float(np.mean(self._step_times))
            row["sec_per_step"] = dt
            self._registry.observe("train.sec_per_step",
                                   float(self._step_times[-1]))
            if self.tokens_per_step:
                row["tokens_per_sec"] = self.tokens_per_step / dt
        if self._train_times:
            row["train_sec_per_step"] = float(np.mean(self._train_times))
        self.history.append(row)
        return row

    def mean(self, key: str) -> float:
        if key == "train_sec_per_step":
            h = self._train_times
        else:
            h = self._hist.get(key)
        return float(np.mean(h)) if h else float("nan")

    def snapshot(self) -> Dict[str, Any]:
        """The registry-provider view: window means, counters, and the
        two throughput buckets."""
        out: Dict[str, Any] = {k: float(np.mean(h))
                               for k, h in self._hist.items() if h}
        if self._step_times:
            out["sec_per_step"] = float(np.mean(self._step_times))
        if self._train_times:
            out["train_sec_per_step"] = float(np.mean(self._train_times))
        out["counters"] = dict(self.counters)
        out["rows"] = len(self.history)
        return out

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = self.step(step, metrics)
        parts = [f"step {step}"]
        for k, v in row.items():
            if k != "step":
                parts.append(f"{k}={v:.4g}")
        self.log_fn("  ".join(parts))
