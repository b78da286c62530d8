"""Canonical topology fingerprints (stage 1 of the schedule pipeline),
a port of ``repro.pipeline.fingerprint`` whose digests are byte-for-byte
those of the JAX package.

``pack_batch`` is a pure function of (topologies, pad dims): two
minibatches whose graphs have identical children lists, external-row
maps and arities pack to byte-identical :class:`LevelSchedule`\\ s.  Real
corpora repeat topologies constantly — every 7-token sentence is the
same chain, balanced trees recur at each power of two — so a content
hash of the topology is the natural cache key for skipping ``pack_batch``
(and the host→device transfer of its output) entirely.

The fingerprint covers exactly what ``pack_batch`` reads:

  * the per-vertex children lists (ragged ints, length-prefixed so
    ``[[1],[2]]`` and ``[[1,2],[]]`` cannot collide),
  * the ``ext_row`` map (which external row each vertex pulls),

and the batch-level key additionally covers the graph ORDER (packing is
order-sensitive: slot assignment walks graphs in sequence) and the four
``pad_*`` dims (a tight pack and a bucketed pack of the same graphs are
different schedules).

Hashes are 16-byte BLAKE2b digests; per-graph digests are memoized on
the ``InputGraph`` instance, and the first fingerprint FREEZES the
topology (``children``/``ext_row`` become tuples, and rebinding either
attribute afterwards makes the next fingerprint raise) — a mutated
graph must never be served under its stale key, least of all by the
per-graph schedule tier, where a stale key splices a wrong schedule.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.structure import InputGraph

#: Cached-digest attribute stashed on InputGraph instances.
_FP_ATTR = "_topology_fp"
#: Identity guard for the memo: the exact (children, ext_row) objects
#: that were hashed.  Rebinding either attribute invalidates the memo
#: LOUDLY (ValueError) instead of silently serving the stale digest.
_FP_GUARD_ATTR = "_topology_fp_guard"


def graph_fingerprint(g: InputGraph) -> bytes:
    """16-byte canonical digest of one graph's topology ``G``.

    The first call freezes the topology: ``children`` and ``ext_row``
    are converted to (nested) tuples, so in-place mutation raises
    ``AttributeError``/``TypeError``, and the memo records the exact
    objects hashed — rebinding either attribute afterwards makes the
    next call raise ``ValueError`` rather than return a stale key."""
    cached = getattr(g, _FP_ATTR, None)
    if cached is not None:
        guard = getattr(g, _FP_GUARD_ATTR, None)
        if guard is not None and (guard[0] is not g.children
                                  or guard[1] is not g.ext_row):
            raise ValueError(
                "InputGraph topology was replaced after its first "
                "fingerprint; topologies are frozen once fingerprinted "
                "— build a new InputGraph instead of mutating this one")
        return cached
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(g.num_nodes).tobytes())
    lens = np.asarray([len(c) for c in g.children], np.int64)
    h.update(lens.tobytes())
    flat = np.asarray([c for ch in g.children for c in ch], np.int64)
    h.update(flat.tobytes())
    h.update(np.asarray(g.ext_row, np.int64).tobytes())
    fp = h.digest()
    try:
        # Freeze BEFORE memoizing: tuples reject in-place mutation, and
        # the guard catches rebinds.  Copies (deepcopy/pickle) preserve
        # the shared identities, so they stay valid.
        g.children = tuple(tuple(int(c) for c in ch) for ch in g.children)
        g.ext_row = tuple(int(r) for r in g.ext_row)
        setattr(g, _FP_ATTR, fp)
        setattr(g, _FP_GUARD_ATTR, (g.children, g.ext_row))
    except (AttributeError, TypeError):
        pass                    # exotic graph types: recompute each call
    return fp


def batch_fingerprint(graphs: Sequence[InputGraph],
                      pads: Optional[Tuple[Optional[int], Optional[int],
                                           Optional[int], Optional[int]]]
                      = None) -> bytes:
    """16-byte key for one (ordered) minibatch of graphs + pad dims —
    the :class:`~repro_torch.pipeline.cache.ScheduleCache` key."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(len(graphs)).tobytes())
    for g in graphs:
        h.update(graph_fingerprint(g))
    pads = tuple(pads) if pads is not None else (None, None, None, None)
    h.update(np.asarray([-1 if p is None else int(p) for p in pads],
                        np.int64).tobytes())
    return h.digest()


def graph_schedule_key(g: InputGraph,
                       pads: Optional[Tuple[Optional[int], Optional[int],
                                            Optional[int], Optional[int]]]
                       = None) -> bytes:
    """16-byte key for ONE graph's solo schedule at ``pads`` — the
    per-graph tier's cache/persist key.  Namespaced so a graph-tier
    entry can never collide with a K=1 batch entry in a shared
    persist store (the two
    schedules are byte-identical for TIGHT pads, but graph-tier
    entries carry an extra invariant — splice inputs must be TIGHT
    solo packs — that batch entries don't)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b"graph-sched\x00")
    h.update(graph_fingerprint(g))
    pads = tuple(pads) if pads is not None else (None, None, None, None)
    h.update(np.asarray([-1 if p is None else int(p) for p in pads],
                        np.int64).tobytes())
    return h.digest()
