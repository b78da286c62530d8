"""The schedule-compilation pipeline: fingerprint → cache → bucket →
pack → device copy (port of the single-batch path of
``repro.pipeline.pipeline``).

  1. **fingerprint** (``fingerprint.py``) — canonical topology hash of
     the batch; repeated topologies become cache keys;
  2. **cache** (``cache.py``) — LRU from fingerprint to packed
     ``LevelSchedule`` + its device twin: a hit skips ``pack_batch``
     AND the host→device copy (``REPRO_SCHED_CACHE=0`` disables);
  3. **bucket** (``buckets.py``) — pad dims quantized to bucket
     boundaries, so a handful of launch shapes serve many minibatches
     (``ShapeCensus`` counts them).

The JAX package's composer, async prefetch, persist and sharded stages
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.structure import (DeviceSchedule, InputGraph,
                                        LevelSchedule, pack_external)
from repro_torch.dist.fault import chaos_corrupt_ext
from repro_torch.obs import trace
from repro_torch.obs.registry import get_registry
from repro_torch.pipeline.buckets import BucketPolicy, PadDims, ShapeCensus
from repro_torch.pipeline.cache import ScheduleCache


@dataclasses.dataclass
class PackedBatch:
    """One pipeline output: the host schedule, its device twin and the
    packed external-input matrix."""

    sched: LevelSchedule
    dev: DeviceSchedule
    ext: torch.Tensor                     # [K*N + 1, X] on the device


class SchedulePipeline:
    """The path from raw ``(graphs, inputs)`` minibatches to
    device-ready schedules on ``device``.

    ``bucket_policy`` defaults to :class:`BucketPolicy`'s multiples-of-8
    ladder; pass ``bucket_policy=None`` for tight packing.  ``cache``
    defaults to a fresh :class:`ScheduleCache` honouring
    ``REPRO_SCHED_CACHE``.
    """

    def __init__(self, ext_dim: int, *,
                 bucket_policy: Optional[BucketPolicy] = BucketPolicy(),
                 cache: Optional[ScheduleCache] = None,
                 cache_capacity: int = 128,
                 with_runs: bool = True,
                 device="cuda"):
        self.ext_dim = ext_dim
        self.bucket_policy = bucket_policy
        self.cache = cache if cache is not None \
            else ScheduleCache(capacity=cache_capacity)
        self.census = ShapeCensus()
        #: False for forward-only pipelines (serving): schedules are
        #: packed WITHOUT the backward's sorted-run arrays.
        self.with_runs = with_runs
        self.device = torch.device(device)
        #: Monotonic pack sequence number — the ``batch=`` correlation
        #: id every span under a :meth:`pack` call carries.
        self.pack_seq = 0
        get_registry().register_provider("pipeline", self.stats)

    def pads_for(self, graphs: Sequence[InputGraph]) -> Optional[PadDims]:
        if self.bucket_policy is None:
            return None
        return self.bucket_policy.bucket(graphs)

    def pack(self, graphs: Sequence[InputGraph],
             inputs: Sequence[np.ndarray]) -> PackedBatch:
        """Fingerprint → cache lookup (or cold pack) → external packing
        → device copy, for one minibatch, at this pipeline's bucket
        policy."""
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
            # Chaos NaN-batch injection point (identity without a hook).
            ext_np = chaos_corrupt_ext(ext_np, sched)
            with trace.span("h2d.ext"):
                ext = trace.maybe_block(
                    torch.from_numpy(ext_np).to(self.device))
        return PackedBatch(sched=sched, dev=dev, ext=ext)

    @property
    def compile_count(self) -> int:
        """Distinct padded shapes produced so far."""
        return self.census.num_shapes

    def stats(self) -> Dict[str, float]:
        s = self.cache.stats()
        s.update(self.census.summary())
        s["compiled_shapes"] = self.census.num_shapes
        return s
