"""Input graphs ``G`` and their packing into level schedules (Cavs §3.2).

The *input graph* is per-example data, not program: it is read "through
I/O" (paper §3) and never triggers recompilation.  Host-side, pure-NumPy
code turns a minibatch of graphs into a :class:`LevelSchedule` — dense
integer tensors encoding the paper's batching tasks ``V_t``:

  level 0 = all leaves of all K graphs, level t = all vertices whose
  children were all evaluated by level t-1 (breadth-first wavefronts).

One step over the schedule is one batching task: it evaluates ``F``
once, batched over the ``M`` slots of that level.  Because the schedule
is *data*, the same kernels serve every minibatch — the Cavs property
that buys static-graph optimization on dynamic models.

This is the PyTorch port of ``repro.core.structure``: the host side is
the same NumPy code (``pack_batch`` is byte-identical), and
:class:`DeviceSchedule` holds torch tensors.

Slot layout (the dynamic-tensor view, §3.3): the node-state buffer has
``T*M + 1`` rows; the vertex at level ``t``, lane ``m`` owns row
``t*M + m`` — i.e. task ``V_t`` writes the contiguous block
``[t*M, (t+1)*M)``, this package's rendering of the paper's monotonically
advancing ``offset``.  Row ``T*M`` is the zero *sentinel*: absent
children and padding point at it, so gathers never need bounds branches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Per-sample input graphs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InputGraph:
    """One example's structure ``G``: a DAG given as child lists.

    ``children[v]`` lists the vertex ids ``v`` gathers from (its inputs);
    ``ext_row[v]`` is the row of this sample's external-input matrix the
    vertex pulls (or -1 to pull the zero row).  Vertices may appear in any
    order; levels are derived here.
    """

    children: List[List[int]]
    ext_row: Optional[List[int]] = None

    def __post_init__(self) -> None:
        n = len(self.children)
        if self.ext_row is None:
            self.ext_row = list(range(n))
        if len(self.ext_row) != n:
            raise ValueError("ext_row length != num nodes")
        for v, ch in enumerate(self.children):
            for c in ch:
                if not (0 <= c < n):
                    raise ValueError(f"node {v} has out-of-range child {c}")

    @property
    def num_nodes(self) -> int:
        return len(self.children)

    def levels(self) -> np.ndarray:
        """Topological level of each vertex (leaves = 0). Raises on cycles.

        Memoized: the schedule pipeline derives levels once for
        bucketing and once for packing, and topologies are immutable
        once they enter a batch.  (Mutating ``children`` after the first
        call is unsupported — rebuild the graph instead.)
        """
        cached = getattr(self, "_levels_cache", None)
        if cached is not None:
            return cached
        lvl = self._levels_uncached()
        self._levels_cache = lvl
        return lvl

    def _levels_uncached(self) -> np.ndarray:
        n = self.num_nodes
        lvl = np.full(n, -1, np.int64)
        # Kahn-style: process in waves.
        indeg_children_done = [0] * n
        remaining = n
        pending = list(range(n))
        while remaining:
            progressed = False
            nxt = []
            for v in pending:
                ch = self.children[v]
                if all(lvl[c] >= 0 for c in ch):
                    lvl[v] = 0 if not ch else 1 + max(lvl[c] for c in ch)
                    remaining -= 1
                    progressed = True
                else:
                    nxt.append(v)
            pending = nxt
            if not progressed and remaining:
                raise ValueError("input graph has a cycle")
        return lvl

    def roots(self) -> List[int]:
        """Vertices no other vertex gathers from (outputs of the structure)."""
        has_parent = np.zeros(self.num_nodes, bool)
        for ch in self.children:
            for c in ch:
                has_parent[c] = True
        return [v for v in range(self.num_nodes) if not has_parent[v]]

    @property
    def max_arity(self) -> int:
        return max((len(c) for c in self.children), default=0)


def chain(n: int) -> InputGraph:
    """A sequence RNN structure: vertex t gathers from t-1 (Fig. 2b)."""
    return InputGraph(children=[[] if t == 0 else [t - 1] for t in range(n)])


def balanced_binary_tree(num_leaves: int) -> InputGraph:
    """Complete binary tree with ``num_leaves`` leaves (Tree-FC benchmark).

    Requires a power of two, mirroring the paper's synthetic generator
    (256 leaves -> 511 vertices).
    """
    if num_leaves < 1 or (num_leaves & (num_leaves - 1)):
        raise ValueError("num_leaves must be a positive power of two")
    children: List[List[int]] = [[] for _ in range(num_leaves)]
    frontier = list(range(num_leaves))
    while len(frontier) > 1:
        nxt = []
        for i in range(0, len(frontier), 2):
            children.append([frontier[i], frontier[i + 1]])
            nxt.append(len(children) - 1)
        frontier = nxt
    return InputGraph(children=children)


def random_binary_tree(num_leaves: int, rng: np.random.Generator) -> InputGraph:
    """Random binary bracketing over ``num_leaves`` leaves (SST-like)."""
    if num_leaves < 1:
        raise ValueError("need >= 1 leaf")
    children: List[List[int]] = [[] for _ in range(num_leaves)]
    frontier = list(range(num_leaves))
    while len(frontier) > 1:
        i = int(rng.integers(0, len(frontier) - 1))
        children.append([frontier[i], frontier[i + 1]])
        frontier[i : i + 2] = [len(children) - 1]
    return InputGraph(children=children)


def random_dag(num_nodes: int, rng: np.random.Generator,
               max_arity: int = 3) -> InputGraph:
    """Random DAG with multi-parent fan-out (paper Fig. 2d: general
    graph-structured RNNs).  Node v gathers from 1..max_arity random
    earlier nodes; a node may feed several parents."""
    if num_nodes < 1:
        raise ValueError("need >= 1 node")
    children: List[List[int]] = [[]]
    for v in range(1, num_nodes):
        k = int(rng.integers(1, min(max_arity, v) + 1))
        ch = sorted(rng.choice(v, size=k, replace=False).tolist())
        children.append([int(c) for c in ch])
    return InputGraph(children=children)


def from_parent_pointers(parents: Sequence[int]) -> InputGraph:
    """Build a tree from parent pointers (-1 = root), treebank style."""
    n = len(parents)
    children: List[List[int]] = [[] for _ in range(n)]
    for v, p in enumerate(parents):
        if p >= 0:
            children[p].append(v)
    return InputGraph(children=children)


# ---------------------------------------------------------------------------
# Level schedule (packed batch of graphs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelSchedule:
    """Dense encoding of the batching tasks for K graphs (host, NumPy).

    Shapes: ``T`` levels, ``M`` slots per level, ``A`` max arity,
    ``K`` samples, ``N`` max nodes per sample, ``R = K*N`` external rows.
    The sentinel buffer row is ``T*M``; the sentinel external row is ``R``.
    """

    child_ids: np.ndarray   # [T, M, A] int32 -> buffer rows (sentinel T*M)
    child_mask: np.ndarray  # [T, M, A] float32
    ext_ids: np.ndarray     # [T, M] int32 -> external rows (sentinel R)
    node_mask: np.ndarray   # [T, M] float32
    slot_of: np.ndarray     # [K, N] int32: buffer row of node n of sample k
    node_valid: np.ndarray  # [K, N] float32
    root_slots: np.ndarray  # [K] int32 (first root per sample)
    num_nodes: np.ndarray   # [K] int32
    # Sorted-run precompute for the fused backward (∂gather = scatter-add
    # under the sorted-run discipline): per level, the stable argsort of
    # the flat [M*A] child_ids, the ids in sorted order, and the run
    # boundaries (1 where a new destination run starts).  Host-side data
    # like the rest of the schedule — carrying it here removes the T
    # per-level XLA sorts from every grad step's reverse scan.
    sort_perm: Optional[np.ndarray] = None        # [T, M*A] int32
    sorted_child_ids: Optional[np.ndarray] = None  # [T, M*A] int32
    run_head: Optional[np.ndarray] = None          # [T, M*A] int32 (0/1)

    @property
    def T(self) -> int:
        return self.child_ids.shape[0]

    @property
    def M(self) -> int:
        return self.child_ids.shape[1]

    @property
    def A(self) -> int:
        return self.child_ids.shape[2]

    @property
    def K(self) -> int:
        return self.slot_of.shape[0]

    @property
    def N(self) -> int:
        return self.slot_of.shape[1]

    @property
    def num_slots(self) -> int:
        """Buffer rows excluding the sentinel."""
        return self.T * self.M

    @property
    def sentinel_slot(self) -> int:
        return self.T * self.M

    @property
    def num_ext_rows(self) -> int:
        return self.K * self.N

    @property
    def occupancy(self) -> float:
        """Fraction of slots holding real vertices (padding efficiency)."""
        return float(self.node_mask.sum()) / max(1, self.num_slots)

    def scatter_plans(self, device="cuda"
                      ) -> Tuple["ScatterPlan", Tuple["ScatterPlan", ...]]:
        """The backward's scatter-add plans on ``device``: one for the
        pulled rows (``ext_ids.reshape(T*M)``, ∂pull) and one per level
        for the child rows (``child_ids[t].reshape(M*A)``, the op-by-op
        ∂gather), the latter ordered by this schedule's sorted runs.
        Needs the sorted runs (``pack_batch(with_runs=True)``)."""
        if self.sort_perm is None:
            raise ValueError("scatter plans need the sorted runs: pack "
                             "with pack_batch(with_runs=True)")
        ext_plan, = scatter_plans(self.ext_ids.reshape(1, -1), device)
        child_plans = scatter_plans(self.child_ids.reshape(self.T, -1),
                                    device, order=self.sort_perm)
        return ext_plan, tuple(child_plans)

    def to_device(self, device="cuda") -> "DeviceSchedule":
        """Copy the schedule to ``device`` (index tensors stay int32,
        the width the kernels take), with each level's live slot count
        (:func:`level_live`, host values).  A schedule with the backward's
        sorted runs also gets its scatter-add plans
        (:meth:`scatter_plans`) and the reverse megastep's plans
        (:meth:`bwd_plans`), built once here for every step that reuses
        the device schedule."""
        def _t(x):
            return None if x is None else torch.from_numpy(
                np.ascontiguousarray(x)).to(device)

        ext_plan, child_plans = (None, None) if self.sort_perm is None \
            else self.scatter_plans(device)
        single = heads = None
        if self.sort_perm is not None:
            plans = self.bwd_plans()
            single = tuple(p[1] for p in plans)
            heads = _on_device([p[2] for p in plans], device)
        return DeviceSchedule(
            child_ids=_t(self.child_ids),
            child_mask=_t(self.child_mask),
            ext_ids=_t(self.ext_ids),
            node_mask=_t(self.node_mask),
            slot_of=_t(self.slot_of),
            node_valid=_t(self.node_valid),
            root_slots=_t(self.root_slots),
            sort_perm=_t(self.sort_perm),
            sorted_child_ids=_t(self.sorted_child_ids),
            run_head=_t(self.run_head),
            ext_plan=ext_plan,
            child_plans=child_plans,
            live=tuple(int(n) for n in level_live(self.child_ids,
                                                  self.sentinel_slot)),
            bwd_single=single,
            bwd_heads=heads,
        )

    def bwd_plans(self) -> List[Tuple[int, bool, Optional[np.ndarray]]]:
        """Each level's :func:`level_bwd_plan`, from its child ids and
        sorted runs (``pack_batch(with_runs=True)``)."""
        if self.sorted_child_ids is None:
            raise ValueError("the reverse megastep's plans need the sorted "
                             "runs: pack with pack_batch(with_runs=True)")
        return [level_bwd_plan(self.child_ids[t], self.sentinel_slot,
                               self.sorted_child_ids[t])
                for t in range(self.T)]


@dataclasses.dataclass(frozen=True)
class DeviceSchedule:
    """Device-resident view of a :class:`LevelSchedule` (torch tensors)."""

    child_ids: torch.Tensor
    child_mask: torch.Tensor
    ext_ids: torch.Tensor
    node_mask: torch.Tensor
    slot_of: torch.Tensor
    node_valid: torch.Tensor
    root_slots: torch.Tensor
    # Precomputed sorted runs for the fused backward (see LevelSchedule);
    # ``None`` on forward-only schedules.
    sort_perm: Optional[torch.Tensor] = None
    sorted_child_ids: Optional[torch.Tensor] = None
    run_head: Optional[torch.Tensor] = None
    # The backward's scatter-add plans (LevelSchedule.scatter_plans):
    # ∂pull over ext_ids.reshape(T*M), and ∂gather per level; ``None``
    # on schedules without the sorted runs.
    ext_plan: Optional["ScatterPlan"] = None
    child_plans: Optional[Tuple["ScatterPlan", ...]] = None
    # Each level's live slot count (level_live) as host values: the grid
    # of the forward megastep's product (K1) and of the reverse megastep
    # (K2).  ``to_device`` sets it on every schedule.
    live: Optional[Tuple[int, ...]] = None
    # The rest of the reverse megastep's per-level plans
    # (LevelSchedule.bwd_plans): the one-contribution flag as host values,
    # and the run heads of a level with several contributions to a row
    # (``None`` elsewhere); ``None`` on schedules without the sorted runs.
    bwd_single: Optional[Tuple[bool, ...]] = None
    bwd_heads: Optional[Tuple[Optional[torch.Tensor], ...]] = None

    @property
    def T(self) -> int:
        return self.child_ids.shape[0]

    @property
    def M(self) -> int:
        return self.child_ids.shape[1]

    @property
    def A(self) -> int:
        return self.child_ids.shape[2]

    @property
    def num_slots(self) -> int:
        return self.T * self.M

    @property
    def device(self) -> torch.device:
        return self.child_ids.device


def _tight_stats(graphs: Sequence[InputGraph]):
    """Per-graph stats behind the tight dims: (levels, depths, per-level
    width counts across the batch, arities, sizes).  Shared by
    ``pack_batch`` and :func:`tight_dims` so the bucket policy can never
    drift from what packing actually requires."""
    levels = [g.levels() for g in graphs]
    depths = [int(l.max()) + 1 for l in levels]
    counts = np.zeros(max(depths), np.int64)
    for l in levels:
        for t, c in zip(*np.unique(l, return_counts=True)):
            counts[t] += c
    arities = [max(g.max_arity, 1) for g in graphs]
    sizes = [g.num_nodes for g in graphs]
    return levels, depths, counts, arities, sizes


def tight_dims(graphs: Sequence[InputGraph]) -> Tuple[int, int, int, int]:
    """The ``(T, M, A, N)`` a tight ``pack_batch`` of ``graphs`` yields
    (the dims the pipeline's bucket policy quantizes up)."""
    if not graphs:
        raise ValueError("empty batch")
    _, depths, counts, arities, sizes = _tight_stats(graphs)
    return max(depths), int(counts.max()), max(arities), max(sizes)


def pack_batch(
    graphs: Sequence[InputGraph],
    pad_levels: Optional[int] = None,
    pad_width: Optional[int] = None,
    pad_arity: Optional[int] = None,
    pad_nodes: Optional[int] = None,
    *,
    with_runs: bool = True,
) -> LevelSchedule:
    """Pack K input graphs into one level schedule (the Cavs scheduler's
    breadth-first batching, Alg. 1, precomputed host-side).

    ``pad_*`` fix the padded dims (for bucketing — reusing one compiled
    program across minibatches); when omitted the tightest fit is used.

    ``with_runs=False`` skips the sorted-run precompute — the ~75% of
    schedule bytes only the fused BACKWARD reads.  Forward-only
    consumers (the serve engines) pack this way so their LRU/persist
    stores don't carry training-only data; a runs-less schedule that
    later reaches a backward falls back to the in-kernel argsort (or
    use :func:`attach_sorted_runs`).
    """
    K = len(graphs)
    if K == 0:
        raise ValueError("empty batch")
    levels, depths, counts, arities, sizes = _tight_stats(graphs)
    T = max(depths)
    A = max(arities)
    N = max(sizes)
    if pad_levels is not None:
        if pad_levels < T:
            k = int(np.argmax(depths))
            raise ValueError(
                f"pad_levels={pad_levels} < required T={T} "
                f"(graph {k} has {depths[k]} levels)")
        T = pad_levels
    if pad_arity is not None:
        if pad_arity < A:
            k = int(np.argmax(arities))
            raise ValueError(
                f"pad_arity={pad_arity} < required A={A} "
                f"(graph {k} has a vertex of arity {arities[k]})")
        A = pad_arity
    if pad_nodes is not None:
        if pad_nodes < N:
            k = int(np.argmax(sizes))
            raise ValueError(
                f"pad_nodes={pad_nodes} < required N={N} "
                f"(graph {k} has {sizes[k]} nodes)")
        N = pad_nodes

    M = int(counts.max())
    if pad_width is not None:
        if pad_width < M:
            t = int(np.argmax(counts))
            widths = [int(np.sum(l == t)) for l in levels]
            k = int(np.argmax(widths))
            raise ValueError(
                f"pad_width={pad_width} < required M={M} (level {t} is "
                f"widest; graph {k} alone contributes {widths[k]} of its "
                f"{M} slots)")
        M = pad_width

    sentinel = T * M
    ext_sentinel = K * N

    child_ids = np.full((T, M, A), sentinel, np.int32)
    child_mask = np.zeros((T, M, A), np.float32)
    ext_ids = np.full((T, M), ext_sentinel, np.int32)
    node_mask = np.zeros((T, M), np.float32)
    slot_of = np.full((K, N), sentinel, np.int32)
    node_valid = np.zeros((K, N), np.float32)
    root_slots = np.zeros(K, np.int32)
    num_nodes = np.asarray([g.num_nodes for g in graphs], np.int32)

    cursor = np.zeros(T, np.int64)  # next free lane per level
    for k, (g, lvl) in enumerate(zip(graphs, levels)):
        order = np.argsort(lvl, kind="stable")
        for v in order:
            t = int(lvl[v])
            m = int(cursor[t])
            cursor[t] += 1
            slot = t * M + m
            slot_of[k, v] = slot
            node_valid[k, v] = 1.0
            node_mask[t, m] = 1.0
            er = g.ext_row[v]
            ext_ids[t, m] = k * N + er if er >= 0 else ext_sentinel
            for a, c in enumerate(g.children[v]):
                child_ids[t, m, a] = slot_of[k, c]  # children are at lower levels
                child_mask[t, m, a] = 1.0
        r = g.roots()[0] if g.roots() else g.num_nodes - 1
        root_slots[k] = slot_of[k, r]

    sched = LevelSchedule(
        child_ids=child_ids, child_mask=child_mask, ext_ids=ext_ids,
        node_mask=node_mask, slot_of=slot_of, node_valid=node_valid,
        root_slots=root_slots, num_nodes=num_nodes,
    )
    return attach_sorted_runs(sched) if with_runs else sched


def attach_sorted_runs(sched: LevelSchedule) -> LevelSchedule:
    """Return ``sched`` with the backward's sorted-run arrays attached
    (idempotent; computes them from ``child_ids`` when absent).  The
    upgrade path for runs-less schedules — e.g. a forward-only persist
    entry reloaded by a training run."""
    if sched.sort_perm is not None and sched.sorted_child_ids is not None \
            and sched.run_head is not None:
        return sched
    sort_perm, sorted_cids, run_head = _sorted_runs(sched.child_ids)
    return dataclasses.replace(sched, sort_perm=sort_perm,
                               sorted_child_ids=sorted_cids,
                               run_head=run_head)


def _sorted_runs(child_ids: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-level sorted-run precompute for the fused backward.

    For each level the flat ``[M*A]`` child ids are stably argsorted so
    duplicate destinations become adjacent; ``run_head`` marks the first
    contribution of each destination run.  This is the preprocessing the
    reverse megastep previously did on device (one XLA sort per level,
    every grad step) — the schedule is data, so it belongs here.
    """
    T = child_ids.shape[0]
    flat = child_ids.reshape(T, -1).astype(np.int32)
    perm = np.argsort(flat, axis=1, kind="stable").astype(np.int32)
    scids = np.take_along_axis(flat, perm, axis=1)
    head = np.ones_like(scids)
    head[:, 1:] = (scids[:, 1:] != scids[:, :-1]).astype(np.int32)
    return perm, scids, head


def level_live(child_ids: np.ndarray, sentinel: int) -> np.ndarray:
    """One past the last slot with a child other than ``sentinel``, for
    each level of ``child_ids`` (``[..., M, A]``; 0 where no slot has
    one): the slots the megasteps' products cover."""
    has = (np.asarray(child_ids) != sentinel).any(axis=-1)
    last = has.shape[-1] - np.argmax(has[..., ::-1], axis=-1)
    return np.where(has.any(axis=-1), last, 0)


def level_bwd_plan(child_ids: np.ndarray, sentinel: int,
                   sorted_child_ids: Optional[np.ndarray] = None
                   ) -> Tuple[int, bool, Optional[np.ndarray]]:
    """The reverse megastep's plan of one level (``child_ids`` ``[M, A]``,
    absent children at ``sentinel``, the largest row), read from the data
    alone:

      - ``live``: :func:`level_live`; the kernel's grid covers
        ``[0, live)``;
      - ``single``: every destination row other than the sentinel
        receives one contribution (``run_head`` all ones up to the
        sentinel's run), so the kernel adds each child's cotangent into
        the gradient buffer itself;
      - ``heads``: else the sorted positions that start each destination
        run other than the sentinel's, then the end of the last (``[runs
        + 1]`` int32), the work list of the kernel's run pass; ``None``
        where ``single``.

    ``sorted_child_ids``: the level's flat child ids in stable sorted
    order (the schedule's), else sorted here."""
    cids = np.asarray(child_ids)
    live = int(level_live(cids, sentinel))
    scids = np.sort(cids.reshape(-1), kind="stable") \
        if sorted_child_ids is None else np.asarray(sorted_child_ids)
    n = int(np.count_nonzero(scids != sentinel))
    head = np.ones(n, bool)
    if n > 1:
        head[1:] = scids[1:n] != scids[:n - 1]
    if head.all():
        return live, True, None
    return live, False, np.append(np.flatnonzero(head), n).astype(np.int32)


def _on_device(arrays: Sequence[Optional[np.ndarray]], device
               ) -> Tuple[Optional[torch.Tensor], ...]:
    """The arrays on ``device`` in one copy, as views (``None`` kept)."""
    kept = [a for a in arrays if a is not None]
    if not kept:
        return tuple(None for _ in arrays)
    flat = torch.from_numpy(np.concatenate(kept)).to(device)
    out, at = [], 0
    for a in arrays:
        if a is None:
            out.append(None)
        else:
            out.append(flat[at:at + a.shape[0]])
            at += a.shape[0]
    return tuple(out)


# ---------------------------------------------------------------------------
# Scatter-add plans (the row scatter-add kernel's work list, per schedule)
# ---------------------------------------------------------------------------

#: Chunks hold at least this many contributions (``C`` is never smaller).
PLAN_MIN_CHUNK = 32
#: ...and ``C`` is large enough that the longest run splits into at most
#: this many chunks, which bounds the combine's partial sums.
PLAN_MAX_SPLIT = 512


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """How ``dst[idx[i]] += rows[i]`` is cut into work for the row
    scatter-add kernel (``kernels/csrc/scatter_add_rows.cu``), built once
    per index vector from the data alone.

    ``order`` ``[n]`` int32: the positions ``i`` grouped by destination
    row (ascending), in increasing ``i`` within a row — the stable argsort
    of ``idx``.  A row's positions form its *run*; a run is cut into
    chunks of at most ``chunk_rows`` positions.  ``chunks`` ``[nc, 4]``
    int32: per chunk its destination row, the range ``[begin, end)`` of
    ``order`` it sums and ``order[begin]``.  The chunks of runs cut into
    several (``split_chunks`` of them) come first, run by run in chunk
    order; then every run that is one chunk, by row.  ``run_start``
    ``[ns + 1]`` int32: split run ``s`` owns chunks ``[run_start[s],
    run_start[s+1])``.  ``rows``: one past the largest index (0 for an
    empty ``idx``)."""

    order: torch.Tensor
    chunks: torch.Tensor
    run_start: torch.Tensor
    split_chunks: int
    chunk_rows: int
    rows: int

    @property
    def n(self) -> int:
        return self.order.shape[0]

    @property
    def device(self) -> torch.device:
        return self.chunks.device

    @classmethod
    def build(cls, idx, device="cuda") -> "ScatterPlan":
        """The plan of ``idx`` (a host array, or a tensor on any device:
        one on the card is copied to the host, which waits for it) on
        ``device``."""
        if isinstance(idx, torch.Tensor):
            idx = idx.detach().cpu().numpy()
        return scatter_plans(np.reshape(idx, (1, -1)), device)[0]


def scatter_plans(idx: np.ndarray, device="cuda",
                  order: Optional[np.ndarray] = None) -> List[ScatterPlan]:
    """The :class:`ScatterPlan` of each row of ``idx`` (``[L, m]``, host
    int32), built in one vectorised pass on the host and copied to
    ``device`` in three copies (each plan holds views).

    ``order``: the rows' stable argsorts when the caller has them (a
    schedule's ``sort_perm``), else computed here.
    A row's ``C`` (``chunk_rows``) is ``PLAN_MIN_CHUNK``, or more where
    its longest run would otherwise be cut into more than
    ``PLAN_MAX_SPLIT`` chunks; a run of ``n`` positions becomes
    ``ceil(n / C)`` chunks, all of ``C`` but the last."""
    idx = np.asarray(idx).astype(np.int32, copy=False)
    L, m = idx.shape
    if m and int(idx.min()) < 0:
        raise ValueError(f"scatter plan: index {int(idx.min())} < 0")
    if order is None:
        order = np.argsort(idx, axis=1, kind="stable")
    order = np.asarray(order).astype(np.int32, copy=False).reshape(L, m)
    if m == 0:
        nc = ns = split = np.zeros(L, np.int64)
        C, rows = np.full(L, PLAN_MIN_CHUNK), np.zeros(L, np.int64)
        chunks, run_start = np.zeros((0, 4), np.int32), np.zeros(L, np.int32)
    else:
        sidx = np.take_along_axis(idx, order, axis=1).reshape(-1)
        head = np.ones(L * m, bool)
        head[1:] = sidx[1:] != sidx[:-1]
        head[::m] = True                          # a row starts a run
        head = np.flatnonzero(head)
        length = np.diff(np.r_[head, L * m])
        level = head // m
        first_run = np.searchsorted(head, np.arange(L) * m)
        C = np.maximum(PLAN_MIN_CHUNK, -(-np.maximum.reduceat(
            length, first_run) // PLAN_MAX_SPLIT))
        c_run = C[level]
        k = -(-length // c_run)                   # chunks a run
        run = np.repeat(np.arange(head.size), k)
        j = np.arange(run.size) - np.repeat(np.cumsum(k) - k, k)
        begin = head[run] + j * c_run[run]
        end = np.minimum(begin + c_run[run], head[run] + length[run])
        split_run = k > 1
        is_split = split_run[run]
        lv = level[run]
        # per row: its split runs' chunks (run by run), then its whole runs
        pick = np.argsort(2 * lv + ~is_split, kind="stable")
        lo = lv * m
        chunks = np.stack([sidx[begin], begin - lo, end - lo,
                           order.reshape(-1)[begin]], axis=1)[pick]
        chunks = chunks.astype(np.int32)
        nc = np.bincount(lv, minlength=L)
        split = np.bincount(lv[is_split], minlength=L)
        ns = np.bincount(level[split_run], minlength=L)
        # run_start: per row, 0 then the running chunk count of its
        # split runs
        cum = np.cumsum(k[split_run])
        within = cum - np.repeat(np.r_[0, cum][np.cumsum(ns) - ns], ns)
        run_start = np.zeros(L + int(ns.sum()), np.int32)
        later = np.ones(run_start.size, bool)
        later[np.cumsum(ns + 1) - (ns + 1)] = False
        run_start[later] = within
        rows = sidx.reshape(L, m)[:, -1].astype(np.int64) + 1

    def _on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    chunks_d, starts_d = _on(chunks.reshape(-1)), _on(run_start)
    order_d = _on(order.reshape(-1))
    out, c0, s0 = [], 0, 0
    for r in range(L):
        n_c, n_s = int(nc[r]), int(ns[r]) + 1
        out.append(ScatterPlan(
            order=order_d[r * m:(r + 1) * m],
            chunks=chunks_d[4 * c0:4 * (c0 + n_c)].view(n_c, 4),
            run_start=starts_d[s0:s0 + n_s], split_chunks=int(split[r]),
            chunk_rows=int(C[r]), rows=int(rows[r])))
        c0, s0 = c0 + n_c, s0 + n_s
    return out


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Fixed padded dims so distinct minibatches share one launch shape."""

    pad_levels: int
    pad_width: int
    pad_arity: int
    pad_nodes: int

    def pack(self, graphs: Sequence[InputGraph]) -> LevelSchedule:
        return pack_batch(graphs, self.pad_levels, self.pad_width,
                          self.pad_arity, self.pad_nodes)


def fit_bucket(graphs: Sequence[InputGraph], batch_size: int,
               round_levels: int = 8, round_width: int = 8,
               round_nodes: int = 8) -> BucketSpec:
    """Derive a bucket covering any ``batch_size``-subset of ``graphs``.

    Rounds dims up so near-miss batches still share one padded shape.
    """
    def _round(x: int, r: int) -> int:
        return ((x + r - 1) // r) * r

    depth = max(int(g.levels().max()) + 1 for g in graphs)
    arity = max(max(g.max_arity for g in graphs), 1)
    nodes = max(g.num_nodes for g in graphs)
    # Worst-case level width: the batch_size widest levels could coincide.
    per_graph_width = [int(np.bincount(g.levels()).max()) for g in graphs]
    width = sum(sorted(per_graph_width)[-batch_size:])
    return BucketSpec(
        pad_levels=_round(depth, round_levels),
        pad_width=_round(width, round_width),
        pad_arity=arity,
        pad_nodes=_round(nodes, round_nodes),
    )


def pack_external(inputs: Sequence[np.ndarray], schedule: LevelSchedule,
                  ext_dim: int) -> np.ndarray:
    """Pack per-sample external inputs ``[n_k, X]`` into ``[K*N + 1, X]``.

    The final row is the zero sentinel pulled by input-less vertices.
    """
    K, N = schedule.K, schedule.N
    out = np.zeros((K * N + 1, ext_dim), np.float32)
    for k, x in enumerate(inputs):
        if x.shape[0] > N:
            raise ValueError(f"sample {k} has {x.shape[0]} rows > pad_nodes={N}")
        out[k * N : k * N + x.shape[0], :] = x
    return out
