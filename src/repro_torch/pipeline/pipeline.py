"""The schedule-compilation pipeline: fingerprint → cache → bucket →
pack → (async) device copy (the port of ``repro.pipeline.pipeline``).

Cavs' claim is that a static vertex function ``F`` plus per-sample data
``G`` "bypasses expensive graph construction and preprocessing
overhead" — but a naive host path still re-runs ``pack_batch`` from
scratch every minibatch.  :class:`SchedulePipeline` is the subsystem
that wins that cost back:

  1. **fingerprint** (``fingerprint.py``) — canonical topology hash of
     the batch; repeated topologies (short sentences, balanced trees)
     become cache keys;
  2. **cache** (``cache.py``) — LRU from fingerprint to packed
     ``LevelSchedule`` + its device twin: a hit skips ``pack_batch``
     AND the host→device copy (``REPRO_SCHED_CACHE=0`` disables).
     Below the batch LRU sits the per-GRAPH tier (``splice.py``):
     cold packs harvest their members' solo schedules, and a batch
     miss whose members have all been seen is SPLICED host-side —
     byte-identical to the cold pack, no topology walk
     (``REPRO_SCHED_SPLICE=0`` disables just this tier);
  3. **bucket** (``buckets.py``) — pad dims quantized to bucket
     boundaries, so a handful of launch shapes serve many minibatches
     (``ShapeCensus`` counts them);
  4. **prefetch** (``prefetch.py``) — the whole chain runs on a
     background thread, overlapped with the card's compute; its device
     copies are synchronous and on the consumer's CUDA stream (see
     ``prefetch.py``).

Two stages bracket the chain.  In front, **compose** (``composer.py``)
reorders a corpus into batches that *manufacture* cache hits (group
same-fingerprint samples) and maximize bucket occupancy (greedy
depth/size fill) — a lossless permutation carrying aux riders and
``sample_ids`` for realignment.  Behind, **persist** (``persist.py``)
backs the cache with an on-disk store (``REPRO_SCHED_PERSIST=<dir>``):
memory miss → disk load → cold pack with write-back, so restarts and
repeat runs skip ``pack_batch`` entirely.

The packed schedule also carries the precomputed sorted runs
(``sort_perm`` / ``sorted_child_ids`` / ``run_head``) that the fused
backward consumes, and its device twin the kernels' plans built from
them — so a training step downstream of this pipeline executes zero
on-device sorts and zero host packing on the hot path.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterable, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core.structure import (DeviceSchedule, InputGraph,
                                        LevelSchedule, pack_external)
from repro_torch.dist.fault import chaos_corrupt_ext
from repro_torch.obs import trace
from repro_torch.obs.registry import get_registry
from repro_torch.pipeline.buckets import BucketPolicy, PadDims, ShapeCensus
from repro_torch.pipeline.cache import ScheduleCache
from repro_torch.pipeline.composer import (BatchComposer, CompositionStats,
                                           ShardedStep)
from repro_torch.pipeline.prefetch import AsyncPacker


@dataclasses.dataclass
class PackedBatch:
    """One pipeline output: the host schedule, its device twin, the
    packed external-input matrix, and any rider fields (labels, ids)."""

    sched: LevelSchedule
    dev: DeviceSchedule
    ext: torch.Tensor                     # [K*N + 1, X] on the device
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _on_consumer_stream(device: torch.device, fn: Callable[[Any], Any]
                        ) -> Callable[[Any], Any]:
    """``fn`` run under the CALLER's current CUDA stream on ``device``
    (captured now, on the consumer's thread), so copies a background
    thread makes for the consumer are allocated and ordered on the
    stream that will read them.  ``fn`` itself off the card."""
    if device.type != "cuda":
        return fn
    stream = torch.cuda.current_stream(device)

    def on_stream(item):
        with torch.cuda.stream(stream):
            return fn(item)
    return on_stream


class SchedulePipeline:
    """The path from raw ``(graphs, inputs)`` minibatches to
    device-ready schedules on ``device``.

    ``bucket_policy`` defaults to :class:`BucketPolicy`'s multiples-of-8
    ladder; pass ``bucket_policy=None`` for tight packing.  ``cache``
    defaults to a fresh :class:`ScheduleCache` honouring
    ``REPRO_SCHED_CACHE``, ``REPRO_SCHED_SPLICE`` and
    ``REPRO_SCHED_PERSIST``; ``splice`` pins the per-graph tier on/off
    for the default cache (ignored when ``cache`` is passed).
    """

    def __init__(self, ext_dim: int, *,
                 bucket_policy: Optional[BucketPolicy] = BucketPolicy(),
                 cache: Optional[ScheduleCache] = None,
                 cache_capacity: int = 128,
                 with_runs: bool = True,
                 splice: Optional[bool] = None,
                 device="cuda"):
        self.ext_dim = ext_dim
        self.bucket_policy = bucket_policy
        self.cache = cache if cache is not None \
            else ScheduleCache(capacity=cache_capacity, splice=splice)
        self.census = ShapeCensus()
        #: False for forward-only pipelines (serving): schedules are
        #: packed WITHOUT the backward's sorted-run arrays.
        self.with_runs = with_runs
        self.device = torch.device(device)
        #: Monotonic pack sequence number — the ``batch=`` correlation
        #: id every span under a :meth:`pack` call carries.
        self.pack_seq = 0
        get_registry().register_provider("pipeline", self.stats)

    # -- one batch --------------------------------------------------------
    def pads_for(self, graphs: Sequence[InputGraph]) -> Optional[PadDims]:
        if self.bucket_policy is None:
            return None
        return self.bucket_policy.bucket(graphs)

    def pack(self, graphs: Sequence[InputGraph],
             inputs: Sequence[np.ndarray],
             aux: Optional[Dict[str, Any]] = None,
             pads: Union[PadDims, None, str] = "policy") -> PackedBatch:
        """Fingerprint → cache lookup (or splice, disk load, cold pack)
        → external packing → device copy, for one minibatch.

        ``pads`` defaults to this pipeline's bucket policy; pass an
        explicit :class:`PadDims` to honour a composer's (possibly
        consolidated) plan, or ``None`` to force a tight pack."""
        if isinstance(pads, str):
            if pads != "policy":
                raise ValueError(
                    f"pads must be a PadDims, None (tight) or 'policy', "
                    f"got {pads!r}")
            pads = self.pads_for(graphs)
        seq = self.pack_seq
        self.pack_seq += 1
        with trace.correlate(batch=seq), \
                trace.span("pipeline.pack", graphs=len(graphs)):
            with trace.span("sched.lookup"):
                sched, dev = self.cache.get_or_pack_device(
                    graphs, pads, with_runs=self.with_runs,
                    device=self.device)
            self.census.record(sched)
            with trace.span("ext.pack"):
                ext_np = pack_external(inputs, sched, self.ext_dim)
            # Chaos NaN-batch injection point (identity without a hook):
            # poisons whole per-sample blocks, so a NaN can only reach
            # the sample it was injected into.
            ext_np = chaos_corrupt_ext(ext_np, sched)
            with trace.span("h2d.ext"):
                ext = trace.maybe_block(
                    torch.from_numpy(ext_np).to(self.device))
        return PackedBatch(sched=sched, dev=dev, ext=ext,
                           aux=dict(aux or {}))

    # -- batch composition (pipeline-aware batch formation) ---------------
    def composer(self, batch_size: int) -> BatchComposer:
        """A :class:`BatchComposer` sharing this pipeline's bucket
        policy — composed batches are scored for hits/occupancy under
        exactly the pads :meth:`pack` will use."""
        return BatchComposer(batch_size, bucket_policy=self.bucket_policy)

    def compose(self, graphs: Sequence[InputGraph],
                inputs: Optional[Sequence[np.ndarray]] = None,
                aux: Optional[Dict[str, Any]] = None, *,
                batch_size: int,
                ) -> Tuple[list, CompositionStats]:
        """Compose one epoch over a corpus: group same-fingerprint
        samples into whole batches (manufactured cache hits) and fill
        the remainder greedily by depth/size (occupancy).  Returns
        ``(composed_batches, CompositionStats)``; feed the batches to
        :meth:`pack`/:meth:`prefetch` via ``ComposedBatch.as_item()``
        — ``sample_ids`` rides in ``aux`` for realignment."""
        with trace.span("pipeline.compose", corpus=len(graphs),
                        batch_size=batch_size):
            return self.composer(batch_size).compose(graphs, inputs, aux)

    # -- a stream of batches ---------------------------------------------
    def prefetch(self, source: Iterable[Union[Tuple, "PackedBatch"]],
                 *, depth: int = 2) -> AsyncPacker:
        """Async stage over a stream of ``(graphs, inputs)``,
        ``(graphs, inputs, aux)`` or ``(graphs, inputs, aux, pads)``
        tuples (the 4-tuple is what composed sources yield — dropping
        the ``pads`` element would lose the composer's consolidated
        bucket plan): packing (and its cache bookkeeping) runs on a
        background thread, ``depth`` batches ahead of the consumer."""

        def pack_one(item):
            if isinstance(item, PackedBatch):
                return item
            return self.pack(*item)

        return AsyncPacker(source, _on_consumer_stream(self.device, pack_one),
                           depth=depth)

    # -- accounting -------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Distinct padded shapes produced so far (= launch shapes of the
        megastep kernels this pipeline has induced)."""
        return self.census.num_shapes

    def stats(self) -> Dict[str, float]:
        s = self.cache.stats()
        s.update(self.census.summary())
        s["compiled_shapes"] = self.census.num_shapes
        return s


class ShardedPipeline:
    """The data-parallel face of the schedule pipeline: one
    :class:`SchedulePipeline` (own :class:`ScheduleCache` tier) PER
    REPLICA, plus the step-stacking that turns a composer
    :class:`~repro_torch.pipeline.composer.ShardedStep` into a single
    stacked batch dict.

    Each replica packs its own sub-batch through its own pipeline — the
    per-replica fingerprint streams the sharded composer keeps stable
    land in per-replica caches, so no replica's hit rate is diluted by
    its neighbours' topologies.  All replicas in a step pack at the
    step's shared ``pads`` cover, so the per-replica
    ``DeviceSchedule`` tensors and external matrices stack into ``[R,
    ...]`` tensors on the device.  Its consumer, the data-parallel
    trainer (``Trainer(dp_shard=True)``), is not ported yet.
    """

    def __init__(self, ext_dim: int, num_shards: int, *,
                 bucket_policy: Optional[BucketPolicy] = BucketPolicy(),
                 cache_capacity: int = 128,
                 with_runs: bool = True,
                 splice: Optional[bool] = None,
                 device="cuda"):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.ext_dim = ext_dim
        self.num_shards = num_shards
        self.bucket_policy = bucket_policy
        self.device = torch.device(device)
        self.pipes = [SchedulePipeline(ext_dim, bucket_policy=bucket_policy,
                                       cache_capacity=cache_capacity,
                                       with_runs=with_runs, splice=splice,
                                       device=device)
                      for _ in range(num_shards)]
        get_registry().register_provider("sharded_pipeline", self.stats)

    def composer(self, batch_size: int) -> BatchComposer:
        """A :class:`BatchComposer` sharing this pipeline's bucket
        policy; ``batch_size`` is the GLOBAL step size (must divide by
        :attr:`num_shards` — ``compose_sharded`` enforces it)."""
        return BatchComposer(batch_size, bucket_policy=self.bucket_policy)

    # -- one train step ---------------------------------------------------
    def pack_step(self, step: ShardedStep) -> Dict[str, Any]:
        """Pack every replica's sub-batch (through its own cache) at
        the step's shared pads and stack the results: ``{"dev":
        DeviceSchedule[R, ...], "ext": [R, K*N+1, X], "weights":
        [R, K], "sample_ids": [R, K], **aux riders [R, K, ...]}``.

        Leading axis ``R`` is the replica axis.  Every tensor field of
        the replicas' ``DeviceSchedule`` is stacked with ``torch.stack``
        on the device; the fields that do not stack (the scatter-add
        plans, live counts and reverse-megastep plans, one set per
        schedule) are tuples by replica."""
        if step.num_shards != self.num_shards:
            raise ValueError(
                f"step has {step.num_shards} replicas for a "
                f"{self.num_shards}-shard pipeline")
        with trace.span("pipeline.pack_step", replicas=step.num_shards):
            packed = [self.pipes[r].pack(rep.graphs, rep.inputs,
                                         pads=step.pads)
                      for r, rep in enumerate(step.replicas)]
            with trace.span("pipeline.stack"):
                dev = _stack_devs([p.dev for p in packed])
                ext = torch.stack([p.ext for p in packed])
        batch: Dict[str, Any] = {
            "dev": dev, "ext": ext,
            "weights": torch.from_numpy(np.stack(
                [np.asarray(rep.aux.get("weights",
                                        [1.0] * len(rep.graphs)),
                            np.float32)
                 for rep in step.replicas])).to(self.device),
            "sample_ids": np.stack(
                [rep.sample_ids for rep in step.replicas]),
        }
        for name in step.replicas[0].aux:
            if name == "weights":
                continue
            batch[name] = np.stack(
                [np.asarray(rep.aux[name]) for rep in step.replicas])
        return batch

    # -- a stream of steps -------------------------------------------------
    def prefetch(self, source: Iterable[ShardedStep], *,
                 depth: int = 2) -> AsyncPacker:
        """Async stage over a stream of :class:`ShardedStep`: all R
        per-replica packs (and their cache bookkeeping) run on a
        background thread, ``depth`` steps ahead of the consumer."""
        return AsyncPacker(source,
                           _on_consumer_stream(self.device, self.pack_step),
                           depth=depth)

    # -- accounting -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Aggregated counters plus the full per-replica breakdown
        (``per_replica[r]`` is replica r's ``SchedulePipeline.stats()``
        — diff snapshots across epochs for measured hit rates)."""
        per = [p.stats() for p in self.pipes]
        out: Dict[str, Any] = {"per_replica": per}
        for key in ("hits", "misses", "disk_hits", "packs",
                    "splices", "graph_hits", "graph_packs"):
            if all(key in s for s in per):
                out[key] = sum(s[key] for s in per)
        return out


def _stack_devs(devs: Sequence[DeviceSchedule]) -> DeviceSchedule:
    """Replicas' device schedules (equal pads) as one: tensor fields
    stacked into ``[R, ...]``, the rest (plans, live counts) as tuples
    by replica; a field absent on the replicas stays ``None``."""
    fields = {}
    for f in dataclasses.fields(DeviceSchedule):
        vals = [getattr(d, f.name) for d in devs]
        if vals[0] is None:
            fields[f.name] = None
        elif isinstance(vals[0], torch.Tensor):
            fields[f.name] = torch.stack(vals)
        else:
            fields[f.name] = tuple(vals)
    return DeviceSchedule(**fields)
