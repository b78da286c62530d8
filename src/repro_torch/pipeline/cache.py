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

Set ``REPRO_SCHED_CACHE=0`` to disable caching (every lookup
cold-packs).  The JAX package's per-graph splice tier and on-disk
persist tier are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.structure import (DeviceSchedule, InputGraph,
                                        LevelSchedule, attach_sorted_runs,
                                        pack_batch)
from repro_torch.dist.fault import chaos_fire
from repro_torch.obs import trace
from repro_torch.pipeline.fingerprint import batch_fingerprint

Pads = Tuple[Optional[int], Optional[int], Optional[int], Optional[int]]

_TIGHT_PADS: Pads = (None, None, None, None)


def cache_enabled_default() -> bool:
    """The ``REPRO_SCHED_CACHE`` env gate (unset / "1" = on)."""
    return os.environ.get("REPRO_SCHED_CACHE", "1") != "0"


@dataclasses.dataclass
class _Entry:
    sched: LevelSchedule
    dev: Optional[DeviceSchedule] = None


def _on(dev: DeviceSchedule, device: torch.device) -> bool:
    have = dev.device
    return have.type == device.type and (device.index is None
                                         or have.index == device.index)


class ScheduleCache:
    """Batch-LRU cache over packed schedules, keyed by batch topology
    fingerprint.

    ``enabled=None`` (default) reads ``REPRO_SCHED_CACHE`` at
    construction; ``False`` forces every lookup to cold-pack (stats
    still count misses, so instrumented code behaves identically).
    """

    def __init__(self, capacity: int = 128,
                 enabled: Optional[bool] = None) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
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
                "hit_rate": self.hit_rate, "packs": self.packs}
