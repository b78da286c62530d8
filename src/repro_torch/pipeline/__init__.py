"""Schedule-compilation pipeline: fingerprint → cache → bucket → pack
(see ``pipeline.py``)."""

from repro_torch.pipeline.buckets import (BucketPolicy, PadDims, ShapeCensus,
                                          TIGHT, tight_dims)
from repro_torch.pipeline.cache import ScheduleCache, cache_enabled_default
from repro_torch.pipeline.fingerprint import (batch_fingerprint,
                                              graph_fingerprint,
                                              graph_schedule_key)
from repro_torch.pipeline.pipeline import PackedBatch, SchedulePipeline

__all__ = [
    "BucketPolicy", "PackedBatch", "PadDims", "ScheduleCache",
    "SchedulePipeline", "ShapeCensus", "TIGHT", "batch_fingerprint",
    "cache_enabled_default", "graph_fingerprint", "graph_schedule_key",
    "tight_dims",
]
