"""Pipeline-aware batch composition (the batcher in front of the cache).

The schedule cache only pays off when identical batch topologies recur,
and a FIFO batcher leaves that to luck: samples arrive interleaved, so
two batches almost never carry the same ordered digest sequence even
when the corpus is full of repeated topologies.  :class:`BatchComposer`
*manufactures* the recurrence (TensorFlow Fold's dynamic batching and
just-in-time dynamic batching make the same move): it groups
same-fingerprint samples into whole batches — every batch after the
first from a group is a guaranteed schedule-cache hit — and fills the
remainder greedily by depth/size so each bucket's padded slots are
maximally occupied.

Composition REORDERS samples, which is why it must be provably
lossless: the emitted batches are an exact permutation of the input
(no drop, no duplicate — held to the JAX package's plan in
``tests/test_torch_composer.py``),
every batch carries the original ``sample_ids`` so consumers can
realign results, and aux riders (labels, weights, request handles)
are permuted in lockstep with their samples.  Per-sample losses and
gradients are bit-identical to a FIFO epoch after realignment: slot
*assignment* moves with composition, per-sample *computation* does not.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.structure import InputGraph, tight_dims
from repro_torch.obs import trace
from repro_torch.obs.registry import get_registry
from repro_torch.pipeline.buckets import BucketPolicy, PadDims
from repro_torch.pipeline.fingerprint import (batch_fingerprint,
                                              graph_fingerprint)


def _publish_stats(prefix: str, stats) -> None:
    """Mirror a composition-stats summary into the global registry as
    ``<prefix>.<field>`` gauges (scalars only)."""
    reg = get_registry()
    for k, v in stats.summary().items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            reg.set_gauge(f"{prefix}.{k}", float(v))


@dataclasses.dataclass
class ComposedBatch:
    """One composed minibatch: the reordered samples plus the record of
    where they came from (``sample_ids`` indexes the original corpus)
    and the bucket the composer planned for them (``pads``; ``None``
    means tight)."""

    graphs: List[InputGraph]
    inputs: Optional[List[np.ndarray]]
    aux: Dict[str, List[Any]]
    sample_ids: np.ndarray                 # [K] int64 original indices
    pads: Optional[PadDims] = None

    def __len__(self) -> int:
        return len(self.graphs)

    def as_item(self) -> Tuple:
        """The ``(graphs, inputs, aux, pads)`` tuple
        ``SchedulePipeline.pack`` / ``.prefetch`` consume;
        ``sample_ids`` rides in ``aux`` so the consumer can realign
        per-sample outputs, and ``pads`` carries the composer's
        (possibly consolidated) bucket plan."""
        aux = dict(self.aux)
        aux["sample_ids"] = self.sample_ids
        return self.graphs, self.inputs, aux, self.pads


@dataclasses.dataclass
class ShardedStep:
    """One data-parallel train step: ``num_shards`` equal-cardinality
    sub-batches (one per replica) packed at shared ``pads`` so the
    per-replica ``DeviceSchedule`` pytrees stack into one ``[R, ...]``
    batch for ``shard_map``.  Ragged splits are topped up with filler
    samples (duplicated graphs, ``weight 0.0``, ``sample_id -1``) so
    every replica always carries the same graph count."""

    replicas: List[ComposedBatch]
    pads: Optional[PadDims] = None

    @property
    def num_shards(self) -> int:
        return len(self.replicas)

    def __len__(self) -> int:
        """Real (non-filler) samples in the step."""
        return sum(int(np.sum(r.sample_ids >= 0)) for r in self.replicas)


@dataclasses.dataclass(frozen=True)
class ShardedCompositionStats:
    """Per-epoch accounting for the sharded plan.

    ``base`` scores the pre-split union batches with the unsharded
    ruler; ``replica_nodes`` is each replica's total packed node count
    over the epoch (fillers included — they are real compute), and
    ``replica_hit_rate`` the *predicted* per-replica schedule-cache hit
    rate against an empty cache (same definition as
    :attr:`CompositionStats.hit_rate`)."""

    base: CompositionStats
    num_shards: int
    num_steps: int
    num_fillers: int
    replica_nodes: Tuple[int, ...]
    replica_hit_rate: Tuple[float, ...]

    @property
    def node_imbalance(self) -> float:
        """max/min per-replica total node count (1.0 = perfect)."""
        lo, hi = min(self.replica_nodes), max(self.replica_nodes)
        return hi / lo if lo else float("inf")

    def summary(self) -> Dict[str, Any]:
        s = self.base.summary()
        s.update(num_shards=self.num_shards, num_steps=self.num_steps,
                 num_fillers=self.num_fillers,
                 node_imbalance=self.node_imbalance,
                 replica_nodes=list(self.replica_nodes),
                 replica_hit_rate=list(self.replica_hit_rate))
        return s


@dataclasses.dataclass(frozen=True)
class CompositionStats:
    """Per-epoch accounting of what composition bought.

    ``hit_rate`` is the *predicted* schedule-cache hit rate of the
    composed epoch against an empty cache (1 − distinct batch
    fingerprints / batches); ``splice_rate`` is the predicted fraction
    of batches the cache's per-graph tier serves by SPLICING — batch
    fingerprint unseen, but every member graph seen earlier in the
    epoch (a cold pack harvests its members, so order matters);
    ``mean_occupancy`` is the mean fraction of padded ``T×M`` slots
    holding real vertices; ``compiled_shapes`` is the number of
    distinct padded shape tuples (= launch shapes of the megastep
    kernels) the epoch induces."""

    num_samples: int
    num_batches: int
    hit_rate: float
    mean_occupancy: float
    compiled_shapes: int
    num_groups: int                        # distinct topologies seen
    group_batches: int                     # whole same-fingerprint batches
    leftover_batches: int                  # mixed remainder batches
    splice_rate: float = 0.0               # predicted graph-tier splices

    def summary(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _batch_stats(graph_batches: Sequence[Sequence[InputGraph]],
                 pads_list: Sequence[Optional[PadDims]],
                 *, num_groups: int = 0, group_batches: int = 0,
                 leftover_batches: int = 0) -> CompositionStats:
    """Composition accounting for any batch plan (composed or FIFO —
    the bench uses this to score both sides with the same ruler)."""
    fps = set()
    seen_graphs = set()                    # graph fps harvested so far
    shapes = set()
    occ = []
    n = 0
    splice_batches = 0
    for graphs, pads in zip(graph_batches, pads_list):
        if pads is None:
            pads = PadDims(*tight_dims(graphs))
        fp = batch_fingerprint(graphs, pads)
        gfps = [graph_fingerprint(g) for g in graphs]
        if fp not in fps and all(g in seen_graphs for g in gfps):
            splice_batches += 1            # batch miss, all members seen
        fps.add(fp)
        seen_graphs.update(gfps)
        shapes.add(pads)
        total_nodes = sum(g.num_nodes for g in graphs)
        occ.append(total_nodes / max(1, pads.levels * pads.width))
        n += len(graphs)
    nb = len(graph_batches)
    return CompositionStats(
        num_samples=n, num_batches=nb,
        hit_rate=(nb - len(fps)) / nb if nb else 0.0,
        mean_occupancy=float(np.mean(occ)) if occ else 0.0,
        compiled_shapes=len(shapes),
        num_groups=num_groups, group_batches=group_batches,
        leftover_batches=leftover_batches,
        splice_rate=splice_batches / nb if nb else 0.0)


def fifo_stats(graphs: Sequence[InputGraph], batch_size: int,
               bucket_policy: Optional[BucketPolicy] = None
               ) -> CompositionStats:
    """The baseline ruler: score arrival-order slicing of ``graphs``
    with the same accounting :meth:`BatchComposer.compose` applies to
    its own plan (per-batch policy buckets, no epoch-level
    consolidation — FIFO has no epoch view)."""
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    batches = [list(graphs[i: i + batch_size])
               for i in range(0, len(graphs), batch_size)]
    pads = [bucket_policy.bucket(b) if bucket_policy is not None else None
            for b in batches]
    return _batch_stats(batches, pads)


class BatchComposer:
    """Compose minibatches from a corpus to maximize schedule-cache
    hits and bucket occupancy.

    The plan, per epoch:

      1. group samples by topology fingerprint (identical digests pack
         to byte-identical schedules);
      2. emit ⌊group/batch_size⌋ whole batches per group — identical
         ordered digest sequences, so every one after the first is a
         schedule-cache hit;
      3. pool the remainders, sort them by (depth, size, digest)
         descending, and slice greedily — deep samples batch with deep,
         so shallow batches quantize to small buckets instead of being
         padded up to the corpus worst case (occupancy), and the sort
         is deterministic, so repeat epochs re-emit identical leftover
         batches (cross-epoch hits);
      4. consolidate singleton buckets: a bucket only earns its own
         compiled program when ≥2 batches share it — batches alone in
         their bucket pad up to the epoch's cover bucket instead
         (arity stays per-batch: fixed-arity cells require it exact).
         This bounds the compile count the differentiation of step 3
         would otherwise inflate; hot buckets keep their occupancy win.

    ``bucket_policy`` must match the pipeline the batches feed (it
    determines the pads under which fingerprints — and therefore hits —
    are scored); ``None`` plans tight packing.  Consumers must pack at
    each batch's planned ``pads`` (``ComposedBatch.as_item()`` carries
    them; ``SchedulePipeline.pack`` honours them).
    """

    def __init__(self, batch_size: int, *,
                 bucket_policy: Optional[BucketPolicy] = BucketPolicy(),
                 shape_budget: Optional[int] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if shape_budget is not None and shape_budget < 1:
            raise ValueError("shape_budget must be >= 1")
        self.batch_size = batch_size
        self.bucket_policy = bucket_policy
        self.shape_budget = shape_budget

    # -- one epoch --------------------------------------------------------
    def compose(self, graphs: Sequence[InputGraph],
                inputs: Optional[Sequence[np.ndarray]] = None,
                aux: Optional[Dict[str, Sequence[Any]]] = None,
                ) -> Tuple[List[ComposedBatch], CompositionStats]:
        """Compose one epoch over the corpus.  ``inputs`` and every
        ``aux`` rider must align 1:1 with ``graphs``; they are permuted
        in lockstep and re-emitted per batch."""
        n = len(graphs)
        if n == 0:
            raise ValueError("empty corpus")
        if inputs is not None and len(inputs) != n:
            raise ValueError(f"{len(inputs)} inputs for {n} graphs")
        aux = dict(aux or {})
        for name, vals in aux.items():
            if name == "sample_ids":
                raise ValueError(
                    "aux rider name 'sample_ids' is reserved — "
                    "as_item() emits the composer's corpus indices "
                    "under that key")
            if len(vals) != n:
                raise ValueError(
                    f"aux rider {name!r} has {len(vals)} values for "
                    f"{n} graphs")

        with trace.span("compose.plan", corpus=n,
                        batch_size=self.batch_size):
            plan, num_groups, group_batches = self._plan(graphs)
            batches = [self._materialize(graphs, inputs, aux, idxs)
                       for idxs in plan]
            self._consolidate(batches)
        stats = _batch_stats(
            [b.graphs for b in batches], [b.pads for b in batches],
            num_groups=num_groups, group_batches=group_batches,
            leftover_batches=len(plan) - group_batches)
        _publish_stats("compose", stats)
        return batches, stats

    def compose_sharded(self, graphs: Sequence[InputGraph],
                        inputs: Optional[Sequence[np.ndarray]] = None,
                        aux: Optional[Dict[str, Sequence[Any]]] = None,
                        *, num_shards: int,
                        ) -> Tuple[List[ShardedStep], ShardedCompositionStats]:
        """Compose one epoch into data-parallel train steps.

        The epoch is planned exactly as :meth:`compose` (same groups,
        same leftover order — ``batch_size`` is the GLOBAL step size),
        then every planned batch is split into ``num_shards``
        equal-cardinality sub-batches balanced by total node count and
        depth, so no replica stalls the gradient sync on a heavier
        schedule.  The split is deterministic in the multiset of
        topology digests, so per-replica batch fingerprints are stable
        across epochs — every replica keeps hitting its own
        ``ScheduleCache``/persist tier, and same-fingerprint group
        batches still manufacture within-epoch hits per replica.

        Ragged batches (tail leftovers, corpora smaller than a step)
        are topped up with fillers: the batch's smallest graph is
        duplicated with ``weight 0.0`` and ``sample_id -1``, keeping
        replica cardinality equal while contributing exact zeros to the
        weighted loss.  Each step's replicas share one ``pads`` cover
        (bucket-quantized elementwise max over the union) so their
        packed schedules stack into a single ``[R, ...]`` pytree;
        singleton covers consolidate across steps exactly like
        :meth:`compose` batches.  Every replica batch carries a
        ``weights`` aux rider; user riders named ``weights`` are
        therefore rejected."""
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.batch_size % num_shards:
            raise ValueError(
                f"batch_size={self.batch_size} must be divisible by "
                f"num_shards={num_shards} so full batches split into "
                f"equal per-replica sub-batches")
        n = len(graphs)
        if n == 0:
            raise ValueError("empty corpus")
        if inputs is not None and len(inputs) != n:
            raise ValueError(f"{len(inputs)} inputs for {n} graphs")
        aux = dict(aux or {})
        for name, vals in aux.items():
            if name in ("sample_ids", "weights"):
                raise ValueError(
                    f"aux rider name {name!r} is reserved — sharded "
                    f"composition emits corpus indices and filler "
                    f"weights under those keys")
            if len(vals) != n:
                raise ValueError(
                    f"aux rider {name!r} has {len(vals)} values for "
                    f"{n} graphs")

        with trace.span("compose.plan_sharded", corpus=n,
                        num_shards=num_shards):
            plan, num_groups, group_batches = self._plan(graphs)
        steps: List[ShardedStep] = []
        num_fillers = 0
        for idxs in plan:
            ridxs, rweights = self._split_replicas(graphs, idxs, num_shards)
            reps = []
            for r in range(num_shards):
                wts = rweights[r]
                num_fillers += sum(1 for w in wts if w == 0.0)
                rep_aux = {name: [vals[i] for i in ridxs[r]]
                           for name, vals in aux.items()}
                rep_aux["weights"] = list(wts)
                reps.append(ComposedBatch(
                    graphs=[graphs[i] for i in ridxs[r]],
                    inputs=(None if inputs is None
                            else [inputs[i] for i in ridxs[r]]),
                    aux=rep_aux,
                    sample_ids=np.asarray(
                        [i if w > 0 else -1
                         for i, w in zip(ridxs[r], wts)], np.int64)))
            union = [g for rep in reps for g in rep.graphs]
            pads = (self.bucket_policy.bucket(union)
                    if self.bucket_policy is not None
                    else PadDims(*tight_dims(union)))
            steps.append(ShardedStep(replicas=reps, pads=pads))

        # Steps carry `.pads` exactly like batches, so the singleton-
        # bucket consolidation applies unchanged — one cover per step.
        self._consolidate(steps)
        for st in steps:
            for rep in st.replicas:
                rep.pads = st.pads

        base = _batch_stats(
            [[g for rep in st.replicas for g in rep.graphs]
             for st in steps],
            [st.pads for st in steps],
            num_groups=num_groups, group_batches=group_batches,
            leftover_batches=len(plan) - group_batches)
        replica_nodes = tuple(
            sum(g.num_nodes for st in steps
                for g in st.replicas[r].graphs)
            for r in range(num_shards))
        replica_hit_rate = []
        for r in range(num_shards):
            fps = [batch_fingerprint(st.replicas[r].graphs, st.pads)
                   for st in steps]
            replica_hit_rate.append(
                (len(fps) - len(set(fps))) / len(fps) if fps else 0.0)
        stats = ShardedCompositionStats(
            base=base, num_shards=num_shards, num_steps=len(steps),
            num_fillers=num_fillers, replica_nodes=replica_nodes,
            replica_hit_rate=tuple(replica_hit_rate))
        _publish_stats("compose_sharded", stats)
        return steps, stats

    def compose_iter(self, graphs: Sequence[InputGraph],
                     inputs: Optional[Sequence[np.ndarray]] = None,
                     aux: Optional[Dict[str, Sequence[Any]]] = None,
                     ) -> Iterator[Tuple]:
        """:meth:`compose` as a stream of ``(graphs, inputs, aux,
        pads)`` items — the shape ``SchedulePipeline.prefetch``
        consumes (see :meth:`ComposedBatch.as_item`)."""
        batches, _ = self.compose(graphs, inputs, aux)
        for b in batches:
            yield b.as_item()

    # -- internals --------------------------------------------------------
    def _plan(self, graphs: Sequence[InputGraph]
              ) -> Tuple[List[List[int]], int, int]:
        """The index plan: lists of corpus indices, one per batch."""
        bs = self.batch_size
        groups: Dict[bytes, List[int]] = {}
        depth: Dict[bytes, int] = {}
        size: Dict[bytes, int] = {}
        for i, g in enumerate(graphs):
            fp = graph_fingerprint(g)
            if fp not in groups:
                groups[fp] = []
                depth[fp] = int(g.levels().max()) + 1
                size[fp] = g.num_nodes
            groups[fp].append(i)

        # Deep/large topologies first: their whole batches come out
        # before the leftover pool, and the pool sort below keeps the
        # same key — deterministic for a given corpus order.
        order = sorted(groups, key=lambda fp: (-depth[fp], -size[fp], fp))
        plan: List[List[int]] = []
        leftovers: List[int] = []
        for fp in order:
            idxs = groups[fp]
            for i in range(0, len(idxs) - bs + 1, bs):
                plan.append(idxs[i: i + bs])
            leftovers.extend(idxs[len(idxs) - len(idxs) % bs:])
        group_batches = len(plan)

        leftovers.sort(key=lambda i: (-depth[graph_fingerprint(graphs[i])],
                                      -size[graph_fingerprint(graphs[i])],
                                      graph_fingerprint(graphs[i]), i))
        for i in range(0, len(leftovers), bs):
            plan.append(leftovers[i: i + bs])
        return plan, len(groups), group_batches

    def _split_replicas(self, graphs: Sequence[InputGraph],
                        idxs: List[int], num_shards: int
                        ) -> Tuple[List[List[int]], List[List[float]]]:
        """Split one planned batch into ``num_shards`` sub-batches of
        exactly ``ceil(len(idxs)/R)`` graphs each: LPT greedy under an
        equal-cardinality constraint — samples sorted by (node count,
        depth) descending go to the least-node-loaded replica with a
        free slot.  Ties break on topology digest before corpus index,
        so the per-replica digest multiset (hence batch fingerprint)
        depends only on the batch's topology content, not on arrival
        order — stable across epochs even under corpus shuffles.
        Short replicas are topped up with the batch's smallest graph as
        a weight-0.0 filler."""
        R = num_shards
        k = -(-len(idxs) // R)

        def key(i):
            g = graphs[i]
            return (-g.num_nodes, -(int(g.levels().max()) + 1),
                    graph_fingerprint(g), i)

        items = sorted(idxs, key=key)
        loads = [0] * R
        counts = [0] * R
        out: List[List[int]] = [[] for _ in range(R)]
        for i in items:
            free = [r for r in range(R) if counts[r] < k]
            r = min(free, key=lambda r: (loads[r], r))
            out[r].append(i)
            counts[r] += 1
            loads[r] += graphs[i].num_nodes
        filler = items[-1]                  # smallest graph in the batch
        weights: List[List[float]] = []
        for r in range(R):
            w = [1.0] * len(out[r])
            while counts[r] < k:
                out[r].append(filler)
                w.append(0.0)
                counts[r] += 1
            weights.append(w)
        return out, weights

    def _consolidate(self, batches: List[ComposedBatch]) -> None:
        """Bucket consolidation (step 4 of the plan).

        A compiled program is only worth its compile when reused, so
        (a) every singleton bucket merges into its smallest DOMINATING
        bucket (all dims ≥ — the merged batches stay packable), falling
        back to the epoch cover bucket (elementwise max — on the
        policy's bucket grid, since a max of grid points is a grid
        point), and (b) when :attr:`shape_budget` is set, the least-
        populated buckets keep merging the same way until at most that
        many distinct shapes remain.  Arity is left per-batch: fixed-
        arity cells require the packed ``A`` to equal ``spec.arity``
        exactly."""
        if self.bucket_policy is None or len(batches) < 2:
            return
        # Keys are full padded shapes; merging is only legal WITHIN an
        # arity class, so the reachable floor is one shape per distinct
        # arity (shape_budget below that is best-effort).
        key_of = lambda p: (p.arity, p.levels, p.width, p.nodes)  # noqa: E731
        counts: Dict[Tuple[int, int, int, int], int] = {}
        for b in batches:
            k = key_of(b.pads)
            counts[k] = counts.get(k, 0) + 1
        covers = {}                        # arity -> class cover key
        for k in counts:
            c = covers.get(k[0])
            covers[k[0]] = k if c is None else \
                (k[0],) + tuple(max(a, b) for a, b in zip(k[1:], c[1:]))
        volume = lambda k: k[1] * k[2] * k[3]            # noqa: E731
        remap: Dict[Tuple, Tuple] = {}

        def merge_smallest(candidates) -> None:
            src = min(candidates, key=lambda k: (counts[k], volume(k), k))
            doms = [d for d in counts
                    if d != src and d[0] == src[0]
                    and all(di >= si for di, si in zip(d[1:], src[1:]))]
            dst = (min(doms, key=lambda d: (volume(d), d)) if doms
                   else covers[src[0]])
            if dst not in counts:
                counts[dst] = 0
            counts[dst] += counts.pop(src)
            remap[src] = dst

        def mergeable():
            return [k for k in counts if k != covers[k[0]]]

        singles = [k for k, c in counts.items()
                   if c < 2 and k != covers[k[0]]]
        for _ in range(len(singles)):
            left = [k for k in singles if counts.get(k, 0) == 1]
            if not left:
                break
            merge_smallest(left)
        if self.shape_budget is not None:
            while len(counts) > self.shape_budget and mergeable():
                merge_smallest(mergeable())

        def resolve(k):
            while k in remap:
                k = remap[k]
            return k

        for b in batches:
            a, t, m, n = resolve(key_of(b.pads))
            b.pads = PadDims(t, m, a, n)

    def _materialize(self, graphs, inputs, aux,
                     idxs: List[int]) -> ComposedBatch:
        batch_graphs = [graphs[i] for i in idxs]
        pads = (self.bucket_policy.bucket(batch_graphs)
                if self.bucket_policy is not None else None)
        return ComposedBatch(
            graphs=batch_graphs,
            inputs=None if inputs is None else [inputs[i] for i in idxs],
            aux={name: [vals[i] for i in idxs]
                 for name, vals in aux.items()},
            sample_ids=np.asarray(idxs, np.int64),
            pads=pads)
