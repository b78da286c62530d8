"""Schedule-compilation pipeline: compose → fingerprint → cache (memory
+ graph splice + disk) → bucket → pack → async prefetch (see
``pipeline.py`` for the architecture note)."""

from repro_torch.pipeline.buckets import (BucketPolicy, PadDims, ShapeCensus,
                                          TIGHT, tight_dims)
from repro_torch.pipeline.cache import (ScheduleCache, cache_enabled_default,
                                        splice_enabled_default)
from repro_torch.pipeline.composer import (BatchComposer, ComposedBatch,
                                           CompositionStats,
                                           ShardedCompositionStats,
                                           ShardedStep, fifo_stats)
from repro_torch.pipeline.fingerprint import (batch_fingerprint,
                                              graph_fingerprint,
                                              graph_schedule_key)
from repro_torch.pipeline.persist import (SCHEMA_VERSION, SchedulePersist,
                                          persist_dir_default)
from repro_torch.pipeline.pipeline import (PackedBatch, SchedulePipeline,
                                           ShardedPipeline)
from repro_torch.pipeline.prefetch import AsyncPacker
from repro_torch.pipeline.splice import extract_solo, splice_schedules

__all__ = [
    "AsyncPacker", "BatchComposer", "BucketPolicy", "ComposedBatch",
    "CompositionStats", "PackedBatch", "PadDims", "SCHEMA_VERSION",
    "ScheduleCache", "SchedulePersist", "SchedulePipeline",
    "ShardedCompositionStats", "ShardedPipeline", "ShardedStep",
    "ShapeCensus", "TIGHT", "batch_fingerprint", "cache_enabled_default",
    "extract_solo", "fifo_stats", "graph_fingerprint",
    "graph_schedule_key", "persist_dir_default", "splice_enabled_default",
    "splice_schedules", "tight_dims",
]
