"""The schedule cache (stage 2 of the schedule pipeline), the port of
``repro.pipeline.cache``.

Repeated topologies are the common case in real corpora — short
sentences are all the same chain, balanced trees recur at every power
of two — and ``pack_batch`` is a pure function of (topologies, pads),
so its output is memoizable: an LRU keyed by the batch topology
fingerprint returns the previously packed :class:`LevelSchedule`
(and its device-resident twin, skipping the host→device transfer too).

The cache has three tiers.  The in-memory BATCH LRU is process-local
and bounded (default 128 entries ≈ a few MB for typical schedules).
Below it sits the per-GRAPH tier: every cold batch pack harvests its
members' tight solo schedules (:func:`~repro_torch.pipeline.splice.
extract_solo`), and a batch-fingerprint miss whose members have ALL
been seen individually is served by SPLICING those solos into the
batch schedule host-side (:func:`~repro_torch.pipeline.splice.
splice_schedules`) — byte-identical to the cold pack, but without the
O(batch) topology walk.  Real traffic is heavy-tailed per graph, not
per batch combination, so this is the tier that survives production
(the ROADMAP's per-graph partial-schedule splicing).  Below both sits
an optional on-disk store (:class:`~repro_torch.pipeline.persist.
SchedulePersist`, enabled by ``REPRO_SCHED_PERSIST=<dir>`` or an
explicit ``persist=`` argument): a memory miss consults the store
before splicing or cold-packing, cold packs AND harvested solos are
written back — so serving restarts and repeat training runs start
warm, and a warm RESTART can splice never-seen combinations straight
from per-graph disk entries.  ``stats()`` separates the tiers:
``hits`` (batch memory), ``disk_hits`` (batch store), ``splices``
(batches assembled from the graph tier), ``graph_hits`` /
``graph_disk_hits`` (graph-tier lookups served from memory / disk),
and ``packs`` / ``graph_packs`` (actual ``pack_batch`` executions — a
fully warm restart shows both == 0).

Hit accounting counts LOGICAL lookups: ``get_or_pack`` immediately
followed by ``get_or_pack_device`` on the same key is one lookup whose
device twin is attached after the fact, not two hits.  The pending
attach holds the ENTRY, not just the key, so capacity-pressure
eviction between the two calls can never turn one logical lookup into
two counted ones — and the pair stays a single ``pack_batch`` even
with the cache disabled.

Soundness: cached schedules are returned BY REFERENCE.  That is safe
because every consumer treats the schedule as read-only data (it is the
paper's per-sample input ``G``, "read through I/O"); nothing in the
scheduler, the kernels or the readouts writes to it.  Splice soundness
rests on the pack-order invariant documented in
:mod:`repro.pipeline.splice` and on frozen topologies
(:func:`~repro_torch.pipeline.fingerprint.graph_fingerprint` freezes a graph
at first fingerprint, so a graph-tier key can never go stale).

Set ``REPRO_SCHED_CACHE=0`` to disable caching globally (every lookup
cold-packs and the disk and graph tiers are bypassed — the
ablation/debug setting).  Set ``REPRO_SCHED_SPLICE=0`` to keep the
batch/disk tiers but disable the graph tier (the splice ablation).

A spliced or disk-loaded entry gets its device twin through
:meth:`LevelSchedule.to_device` like a cold pack's, so it carries the
same scatter-add plans, live counts and reverse-megastep plans: they are
functions of the schedule's bytes, which are equal.  The store's files
are the JAX package's format, so one store serves both packages.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.structure import (DeviceSchedule, InputGraph,
                                        LevelSchedule, attach_sorted_runs,
                                        pack_batch)
from repro_torch.dist.fault import chaos_fire
from repro_torch.obs import trace
from repro_torch.pipeline.fingerprint import (batch_fingerprint,
                                              graph_schedule_key)
from repro_torch.pipeline.persist import SchedulePersist, persist_dir_default
from repro_torch.pipeline.splice import extract_solo, splice_schedules

Pads = Tuple[Optional[int], Optional[int], Optional[int], Optional[int]]

_TIGHT_PADS: Pads = (None, None, None, None)


def cache_enabled_default() -> bool:
    """The ``REPRO_SCHED_CACHE`` env gate (unset / "1" = on)."""
    return os.environ.get("REPRO_SCHED_CACHE", "1") != "0"


def splice_enabled_default() -> bool:
    """The ``REPRO_SCHED_SPLICE`` env gate (unset / "1" = on)."""
    return os.environ.get("REPRO_SCHED_SPLICE", "1") != "0"


@dataclasses.dataclass
class _Entry:
    sched: LevelSchedule
    dev: Optional[DeviceSchedule] = None


@dataclasses.dataclass
class _GraphEntry:
    """Graph-tier entry: one graph's solo schedule at some pads, plus
    derived artifacts consumers memoize against the entry's lifetime
    (e.g. the continuous engine's frontier plan)."""
    sched: LevelSchedule
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _on(dev: DeviceSchedule, device: torch.device) -> bool:
    have = dev.device
    return have.type == device.type and (device.index is None
                                         or have.index == device.index)


class ScheduleCache:
    """Three-tier (batch LRU + per-graph tier + optional disk) cache
    over packed schedules, keyed by batch topology fingerprint.

    ``enabled=None`` (default) reads ``REPRO_SCHED_CACHE`` at
    construction; ``False`` forces every lookup to cold-pack (stats
    still count misses, so instrumented code behaves identically).

    ``splice=None`` (default) reads ``REPRO_SCHED_SPLICE`` at
    construction; ``False`` turns the per-graph tier off (no harvest,
    no splice, graph lookups still work but cold-pack through the
    graph counters).

    ``persist=None`` (default) reads ``REPRO_SCHED_PERSIST`` at
    construction; pass a directory path or a :class:`SchedulePersist`
    to pin a store explicitly, or ``False`` to force the disk tier off
    regardless of the environment.
    """

    def __init__(self, capacity: int = 128,
                 enabled: Optional[bool] = None,
                 persist: Union[SchedulePersist, str, Path, bool,
                                None] = None,
                 graph_capacity: int = 1024,
                 splice: Optional[bool] = None) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if graph_capacity < 1:
            raise ValueError("graph_capacity must be >= 1")
        self.capacity = capacity
        self.graph_capacity = graph_capacity
        self.enabled = (cache_enabled_default()
                        if enabled is None else bool(enabled))
        self.splice = (splice_enabled_default()
                       if splice is None else bool(splice))
        if persist is None or persist is True:
            # True = "enable from the environment" (same as the default)
            pdir = persist_dir_default()
            try:
                self.persist = SchedulePersist(pdir) if pdir else None
            except OSError:
                # An unusable REPRO_SCHED_PERSIST dir must not take the
                # process down — the disk tier is an optimization.  An
                # EXPLICIT persist= argument still raises (the caller
                # asked for that store specifically).
                self.persist = None
        elif persist is False:
            self.persist = None
        elif isinstance(persist, SchedulePersist):
            self.persist = persist
        else:
            self.persist = SchedulePersist(persist)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._graphs: "OrderedDict[bytes, _GraphEntry]" = OrderedDict()
        # An immediately preceding get_or_pack whose entry a
        # get_or_pack_device may still be completing (device-twin
        # attach) — that pair is ONE logical lookup, counted once.
        # Holds (key-or-None, graphs, pads, entry): the ENTRY reference
        # pins it against eviction, and the (graphs, pads) identity
        # match keeps the pairing sound when the cache is disabled
        # (key is None there — the old key-only pending never engaged,
        # so the ablation leg packed every pair twice).
        self._pending: Optional[Tuple[Optional[bytes],
                                      Tuple[InputGraph, ...], Pads,
                                      _Entry]] = None
        self.hits = 0           # batch memory-tier hits
        self.disk_hits = 0      # batch misses served from the store
        self.misses = 0         # batch memory misses (disk+splice+packs)
        self.packs = 0          # batch-level pack_batch executions
        self.evictions = 0
        self.splices = 0        # batch misses assembled from the graph tier
        self.harvests = 0       # solos extracted out of cold batch packs
        self.graph_hits = 0     # graph-tier memory hits
        self.graph_misses = 0   # graph-tier memory misses
        self.graph_disk_hits = 0  # graph misses served from the store
        self.graph_packs = 0    # solo pack_batch executions
        self.graph_evictions = 0

    # -- batch-tier lookup ------------------------------------------------
    def get_or_pack(self, graphs: Sequence[InputGraph],
                    pads: Optional[Pads] = None, *,
                    with_runs: bool = True) -> LevelSchedule:
        """The schedule for ``graphs`` under ``pads`` — cached when the
        batch topology (and pads) have been packed before, SPLICED from
        the per-graph tier when only its members have.

        ``with_runs=False`` (forward-only consumers) packs without the
        backward's sorted-run arrays — ~75% smaller entries in this LRU
        and in the persist store.  A later ``with_runs=True`` lookup of
        the same key upgrades the cached entry in place (one host-side
        argsort), so sharing a cache between serving and training stays
        sound."""
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
        same key, it completes that same logical lookup (attach the
        device twin) rather than counting a second hit — including with
        the cache disabled (one ``pack_batch`` per logical lookup) and
        when capacity pressure evicted the entry between the two calls
        (the pending tuple pins it)."""
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
                same = pkey == self._key(graphs, pads)
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

    def _key(self, graphs: Sequence[InputGraph],
             pads: Optional[Pads]) -> bytes:
        p = tuple(pads) if pads is not None else _TIGHT_PADS
        return batch_fingerprint(graphs, p)

    @staticmethod
    def _upgrade(e: _Entry, with_runs: bool) -> None:
        """Attach sorted runs to a runs-less cached entry when a
        training-path lookup needs them (invalidates the device twin,
        which must carry the runs too)."""
        if with_runs and e.sched.sort_perm is None:
            e.sched = attach_sorted_runs(e.sched)
            e.dev = None

    def _lookup(self, graphs: Sequence[InputGraph],
                pads: Optional[Pads],
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
        if self.persist is not None:
            with trace.span("sched.persist_load"):
                sched = self.persist.load(key)
        else:
            sched = None
        if sched is not None:
            self.disk_hits += 1
            trace.instant("sched.cache_hit", tier="disk")
            if with_runs:
                # A forward-only store entry reloaded by a training-path
                # lookup: upgrade on load (don't write back — the store
                # keeps its smaller forward-only entry).
                sched = attach_sorted_runs(sched)
        else:
            sched = self._try_splice(graphs, p, with_runs)
        if sched is None:
            chaos_fire("pack")
            with trace.span("sched.pack_batch", graphs=len(graphs)):
                sched = pack_batch(graphs, *p, with_runs=with_runs)
            self.packs += 1
            if self.persist is not None:
                with trace.span("sched.persist_store"):
                    self.persist.store(key, sched)
            self._harvest(graphs, sched)
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
        """One graph's solo schedule at ``pads``, via the per-graph
        tier (memory, then disk, then a solo ``pack_batch``).  The
        serving admission path: a topology seen once — at ANY time, in
        any batch that cold-packed, or in a previous process when a
        store is active — never pays its solo pack again.

        ``with_extras=True`` additionally returns the entry's mutable
        ``extras`` dict, which lives exactly as long as the cached
        entry: consumers memoize derived artifacts there (the
        continuous engine keeps its frontier plan in
        ``extras["frontier_plan"]``), so artifact lifetime tracks
        schedule lifetime with no second LRU to tune."""
        e = self._graph_lookup(g, pads, with_runs=with_runs,
                               pack_on_miss=True)
        return (e.sched, e.extras) if with_extras else e.sched

    def _graph_lookup(self, g: InputGraph, pads: Optional[Pads], *,
                      with_runs: bool,
                      pack_on_miss: bool) -> Optional[_GraphEntry]:
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
        sched = None
        if self.persist is not None:
            with trace.span("sched.persist_load"):
                sched = self.persist.load(key)
        if sched is not None:
            self.graph_disk_hits += 1
            trace.instant("sched.cache_hit", tier="graph-disk")
            if with_runs:
                sched = attach_sorted_runs(sched)
        elif pack_on_miss:
            sched = self._solo_from_tight(g, p, with_runs)
            if sched is None:
                chaos_fire("pack")
                with trace.span("sched.pack_batch", graphs=1):
                    sched = pack_batch([g], *p, with_runs=with_runs)
                self.graph_packs += 1
                if self.persist is not None:
                    with trace.span("sched.persist_store"):
                        self.persist.store(key, sched)
        else:
            return None
        e = _GraphEntry(sched=sched)
        self._graph_insert(key, e)
        return e

    def _graph_insert(self, key: bytes, e: _GraphEntry) -> None:
        self._graphs[key] = e
        while len(self._graphs) > self.graph_capacity:
            self._graphs.popitem(last=False)
            self.graph_evictions += 1

    def _solo_from_tight(self, g: InputGraph, p: Pads,
                         with_runs: bool) -> Optional[LevelSchedule]:
        """Re-pad a PADDED solo miss from the graph's TIGHT tier entry
        (a K=1 splice) — so a topology seen in ANY cold batch pack (the
        harvest stores tight solos) admits through e.g. the continuous
        engine's pow2 buckets without a topology walk."""
        if not (self.splice and self.enabled) or p == _TIGHT_PADS:
            return None
        e = self._graph_lookup(g, None, with_runs=False,
                               pack_on_miss=False)
        if e is None:
            return None
        try:
            with trace.span("sched.splice", graphs=1):
                sched = splice_schedules([g], [e.sched], p,
                                         with_runs=with_runs)
        except ValueError:
            return None
        self.splices += 1
        trace.instant("sched.cache_hit", tier="splice")
        return sched

    def _try_splice(self, graphs: Sequence[InputGraph], p: Pads,
                    with_runs: bool) -> Optional[LevelSchedule]:
        """Assemble a batch miss from TIGHT graph-tier solos, when
        every member is available (memory or disk).  Any failure —
        a member missing, a non-tight tier entry — is a plain miss;
        the caller cold-packs, and soundness never depends on this
        path (byte-identity is asserted by the splice suite)."""
        if not (self.splice and self.enabled):
            return None
        solos = []
        for g in graphs:
            e = self._graph_lookup(g, None, with_runs=False,
                                   pack_on_miss=False)
            if e is None:
                return None
            solos.append(e.sched)
        try:
            with trace.span("sched.splice", graphs=len(graphs)):
                sched = splice_schedules(graphs, solos, p,
                                         with_runs=with_runs)
        except ValueError:
            return None
        self.splices += 1
        trace.instant("sched.cache_hit", tier="splice")
        return sched

    def _harvest(self, graphs: Sequence[InputGraph],
                 sched: LevelSchedule) -> None:
        """Seed the graph tier from a cold batch pack: every member's
        tight solo schedule is a cheap projection of the batch arrays
        (:func:`extract_solo`), so after one epoch of cold packs any
        NOVEL COMBINATION of seen graphs splices instead of packing."""
        if not (self.splice and self.enabled):
            return
        with trace.span("sched.harvest", graphs=len(graphs)):
            for k, g in enumerate(graphs):
                key = graph_schedule_key(g, _TIGHT_PADS)
                if key in self._graphs:
                    continue                # duplicates in one batch too
                try:
                    solo = extract_solo(sched, k)
                except ValueError:
                    continue
                self._graph_insert(key, _GraphEntry(sched=solo))
                self.harvests += 1
                # Unconditional store: like the batch tier's cold-pack
                # write-back, this REPLACES a poisoned on-disk entry.
                if self.persist is not None:
                    with trace.span("sched.persist_store"):
                        self.persist.store(key, solo)

    # -- accounting -------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._entries)

    def reset_stats(self) -> None:
        """Zero all counters, INCLUDING the disk tier's (note: a
        ``SchedulePersist`` shared between caches loses the other
        caches' disk accounting too — give each cache its own store
        instance when per-cache disk stats matter)."""
        self.hits = self.misses = self.evictions = 0
        self.disk_hits = self.packs = 0
        self.splices = self.harvests = 0
        self.graph_hits = self.graph_misses = self.graph_disk_hits = 0
        self.graph_packs = self.graph_evictions = 0
        if self.persist is not None:
            self.persist.reset()

    def stats(self) -> Dict[str, float]:
        s = {"hits": self.hits, "misses": self.misses,
             "evictions": self.evictions, "entries": len(self),
             "hit_rate": self.hit_rate,
             "disk_hits": self.disk_hits, "packs": self.packs,
             "splices": self.splices, "harvests": self.harvests,
             "graph_hits": self.graph_hits,
             "graph_misses": self.graph_misses,
             "graph_disk_hits": self.graph_disk_hits,
             "graph_packs": self.graph_packs,
             "graph_evictions": self.graph_evictions,
             "graph_entries": len(self._graphs)}
        if self.persist is not None:
            s.update(self.persist.stats())
        return s
