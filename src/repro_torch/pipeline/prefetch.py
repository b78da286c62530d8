"""Async packing (stage 4 of the schedule pipeline).

Even a cache-hit lookup does host work (fingerprinting, external-input
packing, the occasional cold ``pack_batch``), and the device should
never wait on the host.  :class:`AsyncPacker` runs the whole
fingerprint → cache → bucket → pack → device-copy chain on a background
thread with a bounded queue of ready batches — the same prefetch
discipline as ``data/loader.py`` (it IS ``BackgroundPrefetcher``
underneath), applied to schedule compilation.

Ordering is preserved (single producer, FIFO queue); exceptions raised
while packing surface on the consumer thread at the batch where they
occurred; ``close()`` stops the producer and drains the queue.

Transient faults (a :class:`~repro_torch.dist.fault.SimulatedFailure`, the
class chaos injection and simulated node failures raise — retry-able by
contract) are retried in place up to ``retries`` times before
surfacing, WITHOUT dropping the item being packed: a blip on the
background thread must not silently lose a batch from the stream.
Deterministic errors (bad data, shape mismatches) are never retried,
and neither is a CUDA error raised on the background thread: it is an
ordinary exception there, so it surfaces on the consumer at its batch.

Device copies made by ``pack_fn`` on the background thread are plain
synchronous copies (``Tensor.to`` from pageable host memory returns once
the copy is done), so a batch is whole on the device before it enters
the queue and the host buffers need not outlive anything.
``SchedulePipeline.prefetch`` issues them on the CONSUMER's current CUDA
stream (current streams are per thread), so the caching allocator never
hands a batch's memory to another stream while the consumer's kernels
may still read it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

from repro_torch.data.loader import BackgroundPrefetcher
from repro_torch.dist.fault import SimulatedFailure, chaos_fire
from repro_torch.obs import trace


class AsyncPacker:
    """Background-thread map of ``pack_fn`` over ``source`` with a
    bounded queue (``depth`` batches deep) — generic enough to pack
    schedules (``SchedulePipeline.prefetch``) or to stage plain token
    batches onto the device (``examples/train_lm.py``)."""

    def __init__(self, source: Iterable[Any],
                 pack_fn: Callable[[Any], Any], *, depth: int = 2,
                 retries: int = 2):
        self._source: Iterator[Any] = iter(source)
        self._pack_fn = pack_fn
        self._retries = retries
        self.packed = 0                   # batches produced so far
        self.transient_retries = 0        # SimulatedFailures absorbed
        self._bg = BackgroundPrefetcher(self._produce, depth=depth)

    def _produce(self) -> Any:
        item = next(self._source)         # StopIteration ends the stream
        attempt = 0
        # A retried pack is still ONE span; each retry is an instant
        # inside it.
        with trace.span("prefetch.pack", seq=self.packed):
            while True:
                try:
                    chaos_fire("prefetch")
                    out = self._pack_fn(item)
                    break
                except SimulatedFailure:
                    # Transient by contract: retry the SAME item so the
                    # stream never loses a batch; give up after the
                    # budget (the consumer then sees the failure at
                    # this batch).
                    attempt += 1
                    if attempt > self._retries:
                        raise
                    self.transient_retries += 1
                    trace.instant("prefetch.retry", seq=self.packed,
                                  attempt=attempt)
        self.packed += 1
        return out

    def __iter__(self) -> "AsyncPacker":
        return self

    def __next__(self) -> Any:
        return next(self._bg)

    def close(self) -> None:
        self._bg.close()

    def __enter__(self) -> "AsyncPacker":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
