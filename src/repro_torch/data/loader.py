"""Prefetching loader with straggler mitigation.

The device should never wait on the host: a background thread keeps a
bounded queue of ready batches (double/triple buffering).  Straggler
guard: each logical shard has a *hot spare* — if the primary source
misses its deadline, the spare (which regenerates the same deterministic
slice, see ``data/synthetic.py``) serves the batch and the primary is
marked slow.  On a real cluster the spare is a neighbour host; here both
run in-process, but the control flow (deadline, takeover, accounting) is
the production one.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional


class BackgroundPrefetcher:
    """The shared prefetch discipline: a daemon thread repeatedly calls
    ``produce`` and parks results in a bounded queue (double/triple
    buffering), so the consumer never waits on host-side work.

    ``produce`` signals exhaustion by raising ``StopIteration``; any
    other exception is captured and re-raised on the CONSUMER thread at
    the point in the stream where it occurred.  Used by
    :class:`PrefetchLoader` (batch generation) and by the schedule
    pipeline's async packing stage (``repro_torch.pipeline.prefetch``).
    """

    def __init__(self, produce: Callable[[], Any], *, depth: int = 2):
        self._produce = produce
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._terminal: Optional[BaseException] = None   # latched end state
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            terminal = False
            try:
                item = (True, self._produce())
            except StopIteration:
                item, terminal = (False, None), True
            except BaseException as e:  # noqa: BLE001 — re-raised downstream
                item, terminal = (False, e), True
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if terminal:
                return

    def __iter__(self) -> "BackgroundPrefetcher":
        return self

    def __next__(self) -> Any:
        # The worker exits after its first terminal event, so the end
        # state is LATCHED: every call after exhaustion/error re-raises
        # instead of blocking forever on a queue no producer feeds.
        if self._terminal is not None:
            raise self._terminal
        ok, item = self._q.get()
        if ok:
            return item
        self._terminal = item if item is not None else StopIteration()
        raise self._terminal

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        if self._terminal is None:
            # Latch a LOUD end state: without it, next() after close()
            # would block forever on a queue no producer feeds (e.g. a
            # second fit() over a loader the first fit() auto-closed).
            self._terminal = RuntimeError(
                "BackgroundPrefetcher is closed — create a new "
                "loader/packer instead of reusing a closed one")


class ComposedBatchSource:
    """Epoch-cycled, composition-aware batch source over a fixed corpus.

    The data-layer entry point for pipeline-aware batch formation: the
    corpus is composed ONCE by a :class:`repro_torch.pipeline.BatchComposer`
    (same-fingerprint groups first, greedy depth/size fill for the
    rest; composition is deterministic, so re-composing per epoch would
    reproduce the identical plan) and the composed batches are replayed
    every epoch as ``(graphs, inputs, aux, pads)`` items ready for
    ``SchedulePipeline.pack``/``.prefetch`` — from epoch 2 on, every
    batch topology is a schedule-cache hit.  The corpus is captured at
    construction and treated as immutable (build a new source for new
    data), and the object is a one-shot iterator: once ``epochs=N``
    epochs are exhausted it stays exhausted.

    ``aux`` riders (e.g. ``{"labels": [...]}`` with one value per
    sample) are permuted in lockstep; every yielded item additionally
    carries ``sample_ids`` in its aux dict for realignment.  The last
    epoch's :class:`repro_torch.pipeline.CompositionStats` is exposed as
    :attr:`stats`.
    """

    def __init__(self, graphs, inputs=None, aux=None, *, composer,
                 epochs: Optional[int] = None):
        self.graphs = graphs
        self.inputs = inputs
        self.aux = aux
        self.composer = composer
        self.epochs = epochs              # None = cycle forever
        self.stats = None                 # CompositionStats of the epoch
        self._batches = None              # composed once, replayed
        self._gen = self._generate()

    def _generate(self):
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            if self._batches is None:
                # composition is deterministic over a fixed corpus, so
                # compose once and replay — every later epoch would
                # reproduce the identical plan anyway
                self._batches, self.stats = self.composer.compose(
                    self.graphs, self.inputs, self.aux)
            for b in self._batches:
                yield b.as_item()
            epoch += 1

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)


class ShardedSource:
    """A deterministic, restartable batch source for one data shard.

    ``make_iter(shard, num_shards, start_batch)`` must return an iterator
    positioned at ``start_batch`` — restartability is what checkpoints
    rely on to resume mid-epoch without data duplication.
    """

    def __init__(self, make_iter: Callable[[int, int, int], Iterator],
                 shard: int, num_shards: int):
        self.make_iter = make_iter
        self.shard = shard
        self.num_shards = num_shards
        self.batch_index = 0
        self._it = make_iter(shard, num_shards, 0)

    def next_batch(self) -> Any:
        b = next(self._it)
        self.batch_index += 1
        return b

    def seek(self, batch_index: int) -> None:
        self._it = self.make_iter(self.shard, self.num_shards, batch_index)
        self.batch_index = batch_index


class PrefetchLoader:
    """Background-thread prefetch + deadline-based straggler takeover."""

    def __init__(self, source: ShardedSource, *, depth: int = 2,
                 deadline_s: Optional[float] = None,
                 spare: Optional[ShardedSource] = None,
                 delay_fn: Optional[Callable[[int], float]] = None):
        self.source = source
        self.spare = spare
        self.deadline_s = deadline_s
        self.delay_fn = delay_fn          # test hook: inject slowness
        self.takeovers = 0                # straggler events observed
        self._bg = BackgroundPrefetcher(self._produce_one, depth=depth)

    # -- producer ---------------------------------------------------------
    def _produce_one(self) -> Any:
        idx = self.source.batch_index
        if self.delay_fn is not None:
            delay = self.delay_fn(idx)
            if delay > 0:
                if (self.deadline_s is not None and delay > self.deadline_s
                        and self.spare is not None):
                    # Primary would miss its deadline: hot-spare takeover.
                    self.takeovers += 1
                    self.spare.seek(idx)
                    b = self.spare.next_batch()
                    self.source.seek(idx + 1)   # keep primary in sync
                    return b
                time.sleep(delay)
        return self.source.next_batch()

    # -- consumer ---------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        return next(self._bg)

    def close(self) -> None:
        self._bg.close()
