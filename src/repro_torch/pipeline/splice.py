"""Per-graph partial-schedule splicing (the graph tier's workhorse).

``pack_batch`` walks graphs IN SEQUENCE with one global per-level lane
cursor, and within a graph processes vertices in level-major, node-id
order (``np.argsort(lvl, kind="stable")``).  Two consequences make
per-graph schedules composable:

  * graph ``k``'s level-``t`` vertices occupy CONTIGUOUS lanes
    ``[off_kt, off_kt + w_kt)`` where ``off_kt`` is the summed level-``t``
    widths of graphs ``0..k-1``, and
  * within that lane run, vertices appear in exactly the order a SOLO
    tight pack of graph ``k`` assigns them — batch lane = lane offset +
    solo lane, level by level.

So a batch :class:`LevelSchedule` is a pure function of its members'
TIGHT solo schedules plus the pad dims: :func:`splice_schedules`
rebuilds it by offsetting each solo's slot/lane/external ids under the
batch pads — no topology walk, no ``levels()`` recursion, just a few
vectorized gathers per graph.  The contract (enforced by the splice
byte-identity suite in ``tests/test_torch_splice.py``) is that the spliced
schedule — sorted-run arrays included — is BYTE-IDENTICAL to the
monolithic ``pack_batch(graphs, *pads)`` output, so losses, gradients
and served states cannot depend on which path produced a schedule.

:func:`extract_solo` is the inverse projection: it harvests one graph's
tight solo schedule OUT of a cold-packed batch (byte-identical to
``pack_batch([g], with_runs=False)``), so every cold pack seeds the
graph tier for free — after one epoch of cold packs, any novel
COMBINATION of previously seen graphs splices.

Splice inputs must be TIGHT, runs-less, ``K == 1`` schedules —
:func:`splice_schedules` raises ``ValueError`` on anything else, and
the cache treats any splice failure as a plain miss (falls back to the
cold pack).  :func:`extract_solo` by contrast is PAD-TOLERANT: the
contiguous-lane invariant survives padding, so harvesting works from
bucketed cold packs too (the solo it recovers is always tight).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.structure import (InputGraph, LevelSchedule,
                                        attach_sorted_runs)

Pads = Tuple[Optional[int], Optional[int], Optional[int], Optional[int]]


def _solo_level_widths(solo: LevelSchedule) -> np.ndarray:
    """Per-level real-vertex counts ``[T_k]`` of a solo schedule."""
    return solo.node_mask.sum(axis=1).astype(np.int64)


def _check_tight_solo(solo: LevelSchedule, g: InputGraph, k: int
                      ) -> np.ndarray:
    """Validate the graph-tier invariant (tight K=1 pack of ``g``);
    returns the per-level widths.  Raising here makes the cache fall
    back to a cold pack instead of splicing garbage."""
    if solo.K != 1:
        raise ValueError(f"splice: solo {k} has K={solo.K}, want 1")
    n = int(solo.num_nodes[0])
    if n != g.num_nodes or solo.N != n:
        raise ValueError(f"splice: solo {k} is not a tight pack of its "
                         f"graph (N={solo.N}, num_nodes={n}, "
                         f"graph has {g.num_nodes})")
    w = _solo_level_widths(solo)
    if not (w > 0).all() or int(w.max()) != solo.M:
        raise ValueError(f"splice: solo {k} is not tight in M")
    # Tight in A ⇔ some row's child mask is full (measured off the solo
    # itself: g.max_arity re-walks every child list, and hot Zipf
    # members would pay that per occurrence).
    amax = int(solo.child_mask.sum(axis=-1).max()) if solo.child_mask.size \
        else 0
    if solo.A != max(amax, 1):
        raise ValueError(f"splice: solo {k} is not tight in A "
                         f"(A={solo.A}, widest child row {amax})")
    return w


def extract_solo(sched: LevelSchedule, k: int) -> LevelSchedule:
    """Project graph ``k``'s TIGHT solo schedule out of a packed batch.

    Byte-identical to ``pack_batch([graphs[k]], with_runs=False)`` —
    the inverse of the contiguous-lane invariant: graph ``k``'s lanes at
    each level are a contiguous run in solo-lane order, so subtracting
    the per-level lane offset and remapping slot ids recovers the solo
    pack exactly.  Harvested on every cold batch pack to seed the
    per-graph tier."""
    if not (0 <= k < sched.K):
        raise ValueError(f"graph index {k} out of range for K={sched.K}")
    n = int(sched.num_nodes[k])
    if n < 1:
        raise ValueError(f"graph {k} has no nodes")
    M = sched.M
    slots = sched.slot_of[k, :n].astype(np.int64)
    t = slots // M
    lane = slots % M
    T_k = int(t.max()) + 1
    w = np.bincount(t, minlength=T_k)
    off = np.full(T_k, np.iinfo(np.int64).max)
    np.minimum.at(off, t, lane)
    M_k = int(w.max())
    m = lane - off[t]
    s_solo = (t * M_k + m).astype(np.int32)

    # Tight arity: the widest real child row of any of graph k's nodes.
    arity = sched.child_mask[t, lane].sum(axis=-1).astype(np.int64)
    A_k = max(int(arity.max()), 1)

    sentinel = T_k * M_k
    inv = np.full(sched.T * M + 1, sentinel, np.int32)
    inv[slots] = s_solo

    child_ids = np.full((T_k, M_k, A_k), sentinel, np.int32)
    child_mask = np.zeros((T_k, M_k, A_k), np.float32)
    ext_ids = np.full((T_k, M_k), n, np.int32)      # ext sentinel = 1*n
    node_mask = np.zeros((T_k, M_k), np.float32)
    slot_of = np.full((1, n), sentinel, np.int32)
    node_valid = np.ones((1, n), np.float32)

    child_ids[t, m] = inv[sched.child_ids[t, lane, :A_k]]
    child_mask[t, m] = sched.child_mask[t, lane, :A_k]
    ev = sched.ext_ids[t, lane].astype(np.int64)
    ext_ids[t, m] = np.where(ev == sched.num_ext_rows, n,
                             ev - k * sched.N).astype(np.int32)
    node_mask[t, m] = 1.0
    slot_of[0] = s_solo

    return LevelSchedule(
        child_ids=child_ids, child_mask=child_mask, ext_ids=ext_ids,
        node_mask=node_mask, slot_of=slot_of, node_valid=node_valid,
        root_slots=np.asarray([inv[sched.root_slots[k]]], np.int32),
        num_nodes=np.asarray([n], np.int32),
    )


def splice_schedules(graphs: Sequence[InputGraph],
                     solos: Sequence[LevelSchedule],
                     pads: Optional[Pads] = None, *,
                     with_runs: bool = True) -> LevelSchedule:
    """Splice TIGHT solo schedules into the batch schedule for
    ``graphs`` under ``pads`` — byte-identical to
    ``pack_batch(graphs, *pads, with_runs=with_runs)`` but without the
    O(nodes) topology walk: per graph it is a handful of vectorized
    gathers over arrays the tier already holds.

    The sorted-run arrays are rebuilt from the spliced ``child_ids``
    with the exact routine ``pack_batch`` uses, so training-path
    entries match bit for bit too."""
    K = len(graphs)
    if K == 0:
        raise ValueError("empty batch")
    if len(solos) != K:
        raise ValueError(f"{K} graphs but {len(solos)} solo schedules")
    # Duplicate members (hot topologies under Zipf traffic) validate once.
    checked = {}
    widths = []
    for k, (s, g) in enumerate(zip(solos, graphs)):
        w = checked.get((id(s), id(g)))
        if w is None:
            w = checked[(id(s), id(g))] = _check_tight_solo(s, g, k)
        widths.append(w)

    # Tight batch dims from the solos (equal to tight_dims(graphs)).
    T = max(s.T for s in solos)
    A = max(s.A for s in solos)
    N = max(s.N for s in solos)
    counts = np.zeros(T, np.int64)
    for s, w in zip(solos, widths):
        counts[:s.T] += w
    M = int(counts.max())

    p = tuple(pads) if pads is not None else (None, None, None, None)
    pad_levels, pad_width, pad_arity, pad_nodes = p
    for name, pad, tight in (("pad_levels", pad_levels, T),
                             ("pad_width", pad_width, M),
                             ("pad_arity", pad_arity, A),
                             ("pad_nodes", pad_nodes, N)):
        if pad is not None and pad < tight:
            raise ValueError(f"{name}={pad} < required {tight}")
    T = pad_levels if pad_levels is not None else T
    M = pad_width if pad_width is not None else M
    A = pad_arity if pad_arity is not None else A
    N = pad_nodes if pad_nodes is not None else N

    sentinel = T * M
    ext_sentinel = K * N

    child_ids = np.full((T, M, A), sentinel, np.int32)
    child_mask = np.zeros((T, M, A), np.float32)
    ext_ids = np.full((T, M), ext_sentinel, np.int32)
    node_mask = np.zeros((T, M), np.float32)
    slot_of = np.full((K, N), sentinel, np.int32)
    node_valid = np.zeros((K, N), np.float32)
    root_slots = np.zeros(K, np.int32)
    num_nodes = np.asarray([int(s.num_nodes[0]) for s in solos], np.int32)

    # Solo-derived gather arrays are pure functions of the solo — memo
    # them per call so duplicate members (the common case under Zipf
    # traffic) pay the derivation once.
    derived = {}

    def _derive(solo):
        d = derived.get(id(solo))
        if d is None:
            s_solo = solo.slot_of[0].astype(np.int64)
            t = s_solo // solo.M
            flat = solo.child_ids.reshape(-1, solo.A)[s_solo]
            cmask = solo.child_mask.reshape(-1, solo.A)[s_solo]
            ev = solo.ext_ids.reshape(-1)[s_solo].astype(np.int64)
            d = derived[id(solo)] = (s_solo, t, s_solo - t * solo.M,
                                     flat, cmask, ev)
        return d

    cursor = np.zeros(T, np.int64)  # next free lane per level
    for k, (solo, w) in enumerate(zip(solos, widths)):
        n = int(solo.num_nodes[0])
        s_solo, t, m, child_src, mask_src, ev = _derive(solo)
        lane = cursor[t] + m
        dest = (t * M + lane).astype(np.int32)

        # Solo slot id -> batch slot id (the solo sentinel row maps to
        # the batch sentinel, so padded child columns carry over).
        rowmap = np.full(solo.T * solo.M + 1, sentinel, np.int32)
        rowmap[s_solo] = dest

        flat2 = t * M + lane
        child_ids.reshape(-1, A)[flat2, :solo.A] = rowmap[child_src]
        child_mask.reshape(-1, A)[flat2, :solo.A] = mask_src
        ext_ids.reshape(-1)[flat2] = np.where(
            ev == n, ext_sentinel, k * N + ev).astype(np.int32)
        node_mask.reshape(-1)[flat2] = 1.0
        slot_of[k, :n] = dest
        node_valid[k, :n] = 1.0
        root_slots[k] = rowmap[solo.root_slots[0]]
        cursor[:solo.T] += w

    sched = LevelSchedule(
        child_ids=child_ids, child_mask=child_mask, ext_ids=ext_ids,
        node_mask=node_mask, slot_of=slot_of, node_valid=node_valid,
        root_slots=root_slots, num_nodes=num_nodes,
    )
    return attach_sorted_runs(sched) if with_runs else sched
