"""On-disk persistence of packed schedules (the cache's disk tier).

The in-memory :class:`~repro_torch.pipeline.cache.ScheduleCache` dies with
the process, so a serving restart or a repeat training run re-packs
every topology from scratch.  ``pack_batch`` is a pure function of
(topologies, pads), so its output can outlive the process: this module
serializes packed :class:`LevelSchedule`\\ s — every field, including
the sorted-run arrays the fused backward consumes — to one file per
batch fingerprint under a store directory.  Point
``REPRO_SCHED_PERSIST=<dir>`` at a store and every ``ScheduleCache``
falls back memory → disk → cold pack, writing back on cold packs; a
warm restart then executes ZERO ``pack_batch`` calls (asserted via
pipeline stats in ``tests/test_torch_persist.py``).

Durability discipline:

  * writes are atomic (temp file + ``os.replace``), so a crash
    mid-write never leaves a half-entry under the real key;
  * every file carries a versioned header (magic + schema version +
    payload length + BLAKE2b digest of the payload); truncation,
    corruption and version skew are each detected on load and treated
    as quiet MISSES (counted in :attr:`SchedulePersist.stats`), never
    as errors — a poisoned store can only cost re-packing.

The store is bounded when asked: ``max_bytes`` / ``max_entries`` /
``max_age_s`` caps (also settable via ``REPRO_SCHED_PERSIST_MAX_MB`` /
``_MAX_ENTRIES`` / ``_MAX_AGE_S``) trigger LRU-by-mtime pruning after
each write — every successful load/store touches the entry's mtime, so
the hot tail of a heavy-tailed corpus survives and cold entries age
out.  Entries are safe to delete at any time — `rm` the directory (or
any subset of files) to reclaim space; every removal just becomes a
cold pack.  A store that starts failing writes (full disk, permissions)
keeps degrading gracefully to cold packs, but now also emits a ONE-TIME
``warnings.warn`` the first time ``store_errors`` climbs — previously a
full disk disabled persistence silently.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import tempfile
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from repro_torch.core.structure import LevelSchedule
from repro_torch.dist.fault import SimulatedFailure, chaos_fire

#: File layout: MAGIC | uint64 version | uint64 payload_len |
#: 16-byte BLAKE2b(payload) | payload (an .npz of the schedule fields).
MAGIC = b"REPROSCHED\x00"
SCHEMA_VERSION = 1
_HEADER_LEN = len(MAGIC) + 8 + 8 + 16

#: Every LevelSchedule field serializes (all are arrays; optional ones
#: — the sorted-run trio on hand-built schedules — record presence
#: per-field in the payload).  Derived from the dataclass so a future
#: field can never be silently dropped on round-trip.
_FIELDS = tuple(f.name for f in dataclasses.fields(LevelSchedule))


def persist_dir_default() -> Optional[str]:
    """The ``REPRO_SCHED_PERSIST`` env gate: a store directory, or
    ``None``/empty for no disk tier."""
    return os.environ.get("REPRO_SCHED_PERSIST") or None


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _encode(sched: LevelSchedule) -> bytes:
    buf = io.BytesIO()
    arrays = {f: getattr(sched, f) for f in _FIELDS
              if getattr(sched, f) is not None}
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    head = (MAGIC
            + np.uint64(SCHEMA_VERSION).tobytes()
            + np.uint64(len(payload)).tobytes()
            + hashlib.blake2b(payload, digest_size=16).digest())
    return head + payload


class StoreMiss(Exception):
    """Internal: the entry is unusable (absent, corrupt, or stale)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _decode(blob: bytes) -> LevelSchedule:
    if len(blob) < _HEADER_LEN:
        raise StoreMiss("corrupt")          # truncated inside the header
    off = len(MAGIC)
    if blob[:off] != MAGIC:
        raise StoreMiss("corrupt")
    version = int(np.frombuffer(blob[off: off + 8], np.uint64)[0])
    if version != SCHEMA_VERSION:
        raise StoreMiss("version")
    plen = int(np.frombuffer(blob[off + 8: off + 16], np.uint64)[0])
    digest = blob[off + 16: off + 32]
    payload = blob[_HEADER_LEN:]
    if len(payload) != plen:
        raise StoreMiss("corrupt")          # truncated / trailing junk
    if hashlib.blake2b(payload, digest_size=16).digest() != digest:
        raise StoreMiss("corrupt")
    try:
        with np.load(io.BytesIO(payload)) as z:
            fields = {f: np.asarray(z[f]) for f in _FIELDS if f in z.files}
        return LevelSchedule(**fields)
    except Exception:                       # noqa: BLE001 — any bad payload
        raise StoreMiss("corrupt")


class SchedulePersist:
    """A directory of packed schedules keyed by batch fingerprint.

    One file per key (``<fingerprint-hex>.sched``).  All failure modes
    on :meth:`load` — missing file, truncated/corrupt bytes, schema
    version mismatch — return ``None`` and bump the matching counter;
    :meth:`store` failures (full disk, read-only store) are likewise
    swallowed and counted, because persistence is an optimization, not
    a correctness dependency.  The first swallowed store failure emits
    a one-time ``warnings.warn`` so operators learn the disk tier went
    write-dead before the next restart re-packs the world.

    ``max_bytes`` / ``max_entries`` / ``max_age_s`` bound the store:
    after each successful write, entries are pruned LRU-by-mtime (and
    by age) until the caps hold.  Loads and stores both touch mtime, so
    "recently useful" survives.  Unset caps fall back to the
    ``REPRO_SCHED_PERSIST_MAX_MB`` / ``REPRO_SCHED_PERSIST_MAX_ENTRIES``
    / ``REPRO_SCHED_PERSIST_MAX_AGE_S`` environment knobs; all-``None``
    keeps the store unbounded (the pre-GC behavior).
    """

    def __init__(self, root: Union[str, Path], *,
                 max_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None,
                 max_age_s: Optional[float] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        if max_bytes is None:
            mb = _env_float("REPRO_SCHED_PERSIST_MAX_MB")
            max_bytes = int(mb * 1024 * 1024) if mb is not None else None
        if max_entries is None:
            me = _env_float("REPRO_SCHED_PERSIST_MAX_ENTRIES")
            max_entries = int(me) if me is not None else None
        if max_age_s is None:
            max_age_s = _env_float("REPRO_SCHED_PERSIST_MAX_AGE_S")
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self.max_age_s = max_age_s
        self._warned_store_errors = False
        self.reset()

    def reset(self) -> None:
        """Zero the counters (owned here so callers — e.g.
        ``ScheduleCache.reset_stats`` — never have to enumerate them)."""
        self.loads = 0          # successful disk reads
        self.load_misses = 0    # absent entries
        self.corrupt = 0        # truncated/garbled entries skipped
        self.stale = 0          # version-header mismatches skipped
        self.stores = 0         # successful writes
        self.store_errors = 0   # swallowed write failures
        self.gc_removed = 0     # entries pruned by the GC

    def path_for(self, key: bytes) -> Path:
        return self.root / f"{key.hex()}.sched"

    def load(self, key: bytes) -> Optional[LevelSchedule]:
        path = self.path_for(key)
        try:
            chaos_fire("persist_load")
            blob = path.read_bytes()
        except (OSError, SimulatedFailure):
            self.load_misses += 1
            return None
        try:
            sched = _decode(blob)
        except StoreMiss as m:
            if m.reason == "version":
                self.stale += 1
            else:
                self.corrupt += 1
            return None
        self.loads += 1
        try:
            os.utime(path)              # LRU touch: loads keep entries hot
        except OSError:
            pass
        return sched

    def store(self, key: bytes, sched: LevelSchedule) -> bool:
        blob = _encode(sched)
        path = self.path_for(key)
        try:
            chaos_fire("persist_store")
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)       # atomic publish
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except (OSError, SimulatedFailure) as e:
            self.store_errors += 1
            if not self._warned_store_errors:
                self._warned_store_errors = True
                warnings.warn(
                    f"SchedulePersist: store write to {self.root} failed "
                    f"({e!r}); persistence is degrading to cold packs "
                    f"(this warning fires once; see "
                    f"stats()['disk_store_errors'])",
                    RuntimeWarning, stacklevel=2)
            return False
        self.stores += 1
        self.gc()
        return True

    # -- garbage collection ----------------------------------------------
    def gc(self, now: Optional[float] = None) -> int:
        """Prune until the caps hold: age-expired entries first, then
        LRU-by-mtime until both the entry-count and byte-size caps are
        satisfied.  Returns the number of files removed.  A no-op when
        no cap is configured."""
        if (self.max_bytes is None and self.max_entries is None
                and self.max_age_s is None):
            return 0
        entries = []
        for p in self.root.glob("*.sched"):
            try:
                st = p.stat()
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, p))
        entries.sort()                      # oldest mtime first
        now = time.time() if now is None else now
        total = sum(size for _, size, _ in entries)
        removed = 0
        for mtime, size, p in entries:
            stale = (self.max_age_s is not None
                     and now - mtime > self.max_age_s)
            over_count = (self.max_entries is not None
                          and len(entries) - removed > self.max_entries)
            over_bytes = (self.max_bytes is not None
                          and total > self.max_bytes)
            if not (stale or over_count or over_bytes):
                break                       # sorted: the rest are newer
            try:
                p.unlink()
            except OSError:
                continue
            total -= size
            removed += 1
        self.gc_removed += removed
        return removed

    def size_bytes(self) -> int:
        """Total bytes of all stored entries (the quantity ``max_bytes``
        caps)."""
        total = 0
        for p in self.root.glob("*.sched"):
            try:
                total += p.stat().st_size
            except OSError:
                pass
        return total

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.sched"))

    def __contains__(self, key: bytes) -> bool:
        return self.path_for(key).exists()

    def stats(self) -> Dict[str, int]:
        return {"disk_loads": self.loads, "disk_load_misses": self.load_misses,
                "disk_corrupt": self.corrupt, "disk_stale": self.stale,
                "disk_stores": self.stores,
                "disk_store_errors": self.store_errors,
                "disk_gc_removed": self.gc_removed}
