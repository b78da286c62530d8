"""The schedule cache (stage 2 of the schedule pipeline), the batch-LRU
memory tier of ``repro.pipeline.cache``.

Repeated topologies are the common case in real corpora — short
sentences are all the same chain, balanced trees recur at every power
of two — and ``pack_batch`` is a pure function of (topologies, pads),
so its output is memoizable: an LRU keyed by the batch topology
fingerprint returns the previously packed :class:`LevelSchedule` (and
its device-resident twin, skipping the host→device copy too).

Hit accounting counts LOGICAL lookups: ``get_or_pack`` immediately
followed by ``get_or_pack_device`` on the same key is one lookup whose
device twin is attached after the fact, not two hits — and the pair
stays a single ``pack_batch`` even with the cache disabled.

Cached schedules are returned BY REFERENCE: every consumer treats the
schedule as read-only data (the paper's per-sample input ``G``).

A second, per-GRAPH tier (:meth:`ScheduleCache.get_or_pack_graph`)
keeps one graph's solo schedule per ``(topology, pads)``: the continuous
serving engine admits a recurring topology with no packing work, and
memoizes its frontier plan in the entry's ``extras``.  A miss packs the
graph alone.

Set ``REPRO_SCHED_CACHE=0`` to disable caching (every lookup
cold-packs).  The JAX package's splice (a solo schedule re-padded or
harvested from a batch pack) and its on-disk persist tier are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.structure import (DeviceSchedule, InputGraph,
                                        LevelSchedule, attach_sorted_runs,
                                        pack_batch)
from repro_torch.dist.fault import chaos_fire
from repro_torch.obs import trace
from repro_torch.pipeline.fingerprint import (batch_fingerprint,
                                              graph_schedule_key)

Pads = Tuple[Optional[int], Optional[int], Optional[int], Optional[int]]

_TIGHT_PADS: Pads = (None, None, None, None)


def cache_enabled_default() -> bool:
    """The ``REPRO_SCHED_CACHE`` env gate (unset / "1" = on)."""
    return os.environ.get("REPRO_SCHED_CACHE", "1") != "0"


@dataclasses.dataclass
class _Entry:
    sched: LevelSchedule
    dev: Optional[DeviceSchedule] = None


@dataclasses.dataclass
class _GraphEntry:
    """Graph-tier entry: one graph's solo schedule at some pads, plus
    derived artifacts consumers memoize against the entry's lifetime
    (the continuous engine's frontier plan)."""
    sched: LevelSchedule
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _on(dev: DeviceSchedule, device: torch.device) -> bool:
    have = dev.device
    return have.type == device.type and (device.index is None
                                         or have.index == device.index)


class ScheduleCache:
    """Batch-LRU cache over packed schedules, keyed by batch topology
    fingerprint, plus the per-graph LRU tier of solo schedules
    (``graph_capacity`` entries).

    ``enabled=None`` (default) reads ``REPRO_SCHED_CACHE`` at
    construction; ``False`` forces every lookup to cold-pack (stats
    still count misses, so instrumented code behaves identically).
    """

    def __init__(self, capacity: int = 128,
                 enabled: Optional[bool] = None,
                 graph_capacity: int = 1024) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if graph_capacity < 1:
            raise ValueError("graph_capacity must be >= 1")
        self.capacity = capacity
        self.graph_capacity = graph_capacity
        self.enabled = (cache_enabled_default()
                        if enabled is None else bool(enabled))
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        # An immediately preceding get_or_pack whose entry a
        # get_or_pack_device may still be completing (device-twin
        # attach) — that pair is ONE logical lookup, counted once.
        # Holds (key-or-None, graphs, pads, entry): the ENTRY reference
        # pins it against eviction, and the (graphs, pads) identity
        # match keeps the pairing sound when the cache is disabled.
        self._pending: Optional[Tuple[Optional[bytes],
                                      Tuple[InputGraph, ...], Pads,
                                      _Entry]] = None
        self.hits = 0
        self.misses = 0
        self.packs = 0          # pack_batch executions
        self.evictions = 0
        self._graphs: "OrderedDict[bytes, _GraphEntry]" = OrderedDict()
        self.graph_hits = 0     # graph-tier memory hits
        self.graph_misses = 0   # graph-tier memory misses
        self.graph_packs = 0    # solo pack_batch executions
        self.graph_evictions = 0

    # -- lookup -----------------------------------------------------------
    def get_or_pack(self, graphs: Sequence[InputGraph],
                    pads: Optional[Pads] = None, *,
                    with_runs: bool = True) -> LevelSchedule:
        """The schedule for ``graphs`` under ``pads`` — cached when the
        batch topology (and pads) have been packed before.

        ``with_runs=False`` (forward-only consumers) packs without the
        backward's sorted-run arrays; a later ``with_runs=True`` lookup
        of the same key upgrades the cached entry in place."""
        e, key = self._lookup(graphs, pads, with_runs)
        p = tuple(pads) if pads is not None else _TIGHT_PADS
        self._pending = (key, tuple(graphs), p, e)
        return e.sched

    def get_or_pack_device(self, graphs: Sequence[InputGraph],
                           pads: Optional[Pads] = None, *,
                           with_runs: bool = True, device="cuda"
                           ) -> Tuple[LevelSchedule, DeviceSchedule]:
        """Like :meth:`get_or_pack` but also returns (and caches) the
        schedule on ``device`` — a hit skips ``pack_batch`` AND the
        host→device copy.  Called right after :meth:`get_or_pack` on the
        same key, it completes that same logical lookup rather than
        counting a second hit."""
        device = torch.device(device)
        pending = self._pending
        self._pending = None
        p = tuple(pads) if pads is not None else _TIGHT_PADS
        if pending is not None:
            pkey, pgraphs, ppads, pe = pending
            same = (ppads == p and len(pgraphs) == len(graphs)
                    and all(a is b for a, b in zip(pgraphs, graphs)))
            if not same and pkey is not None and self.enabled:
                # Equal-but-distinct graph objects still pair up.
                same = pkey == batch_fingerprint(graphs, p)
            if same:                        # attach, don't recount
                if (self.enabled and pkey is not None
                        and pkey not in self._entries):
                    # Re-pin an entry evicted between the two calls.
                    self._entries[pkey] = pe
                    while len(self._entries) > self.capacity:
                        self._entries.popitem(last=False)
                        self.evictions += 1
                elif self.enabled and pkey is not None:
                    self._entries.move_to_end(pkey)
                self._upgrade(pe, with_runs)
                self._attach(pe, device)
                return pe.sched, pe.dev
        e, _ = self._lookup(graphs, pads, with_runs)
        self._attach(e, device)
        return e.sched, e.dev

    @staticmethod
    def _attach(e: _Entry, device: torch.device) -> None:
        if e.dev is None or not _on(e.dev, device):
            with trace.span("h2d.sched"):
                e.dev = e.sched.to_device(device)

    @staticmethod
    def _upgrade(e: _Entry, with_runs: bool) -> None:
        """Attach sorted runs to a runs-less cached entry when a
        training-path lookup needs them (invalidates the device twin)."""
        if with_runs and e.sched.sort_perm is None:
            e.sched = attach_sorted_runs(e.sched)
            e.dev = None

    def _lookup(self, graphs: Sequence[InputGraph], pads: Optional[Pads],
                with_runs: bool = True) -> Tuple[_Entry, Optional[bytes]]:
        self._pending = None
        p = tuple(pads) if pads is not None else _TIGHT_PADS
        if not self.enabled:
            chaos_fire("pack")
            self.misses += 1
            self.packs += 1
            with trace.span("sched.pack_batch", graphs=len(graphs)):
                return _Entry(sched=pack_batch(graphs, *p,
                                               with_runs=with_runs)), None
        with trace.span("sched.fingerprint", graphs=len(graphs)):
            key = batch_fingerprint(graphs, p)
        e = self._entries.get(key)
        if e is not None:
            self.hits += 1
            trace.instant("sched.cache_hit", tier="memory")
            self._entries.move_to_end(key)
            self._upgrade(e, with_runs)
            return e, key
        self.misses += 1
        chaos_fire("pack")
        with trace.span("sched.pack_batch", graphs=len(graphs)):
            sched = pack_batch(graphs, *p, with_runs=with_runs)
        self.packs += 1
        e = _Entry(sched=sched)
        self._entries[key] = e
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return e, key

    # -- graph tier -------------------------------------------------------
    def get_or_pack_graph(self, g: InputGraph,
                          pads: Optional[Pads] = None, *,
                          with_runs: bool = False,
                          with_extras: bool = False):
        """One graph's solo schedule at ``pads``, via the per-graph tier
        (memory, then a solo ``pack_batch``) — the serving admission
        path: a topology seen once never pays its solo pack again.

        ``with_extras=True`` also returns the entry's mutable ``extras``
        dict, which lives exactly as long as the cached entry: consumers
        memoize derived artifacts there (the continuous engine keeps its
        frontier plan in ``extras["frontier_plan"]``), so artifact
        lifetime tracks schedule lifetime with no second LRU to tune."""
        e = self._graph_lookup(g, pads, with_runs=with_runs)
        return (e.sched, e.extras) if with_extras else e.sched

    def _graph_lookup(self, g: InputGraph, pads: Optional[Pads], *,
                      with_runs: bool) -> _GraphEntry:
        p = tuple(pads) if pads is not None else _TIGHT_PADS
        if not self.enabled:
            chaos_fire("pack")
            self.graph_misses += 1
            self.graph_packs += 1
            with trace.span("sched.pack_batch", graphs=1):
                return _GraphEntry(sched=pack_batch([g], *p,
                                                    with_runs=with_runs))
        key = graph_schedule_key(g, p)
        e = self._graphs.get(key)
        if e is not None:
            self.graph_hits += 1
            trace.instant("sched.cache_hit", tier="graph")
            self._graphs.move_to_end(key)
            if with_runs and e.sched.sort_perm is None:
                e.sched = attach_sorted_runs(e.sched)
            return e
        self.graph_misses += 1
        chaos_fire("pack")
        with trace.span("sched.pack_batch", graphs=1):
            sched = pack_batch([g], *p, with_runs=with_runs)
        self.graph_packs += 1
        e = _GraphEntry(sched=sched)
        self._graph_insert(key, e)
        return e

    def _graph_insert(self, key: bytes, e: _GraphEntry) -> None:
        self._graphs[key] = e
        while len(self._graphs) > self.graph_capacity:
            self._graphs.popitem(last=False)
            self.graph_evictions += 1

    # -- accounting -------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self),
                "hit_rate": self.hit_rate, "packs": self.packs,
                "graph_hits": self.graph_hits,
                "graph_misses": self.graph_misses,
                "graph_packs": self.graph_packs,
                "graph_evictions": self.graph_evictions,
                "graph_entries": len(self._graphs)}
