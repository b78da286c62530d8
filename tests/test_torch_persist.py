"""The on-disk schedule store in the port (``repro_torch.pipeline.persist``)
against the JAX package: one file format, so a store written by either
package warm-loads in the other with zero packs and byte-equal decoded
arrays; truncation, corruption and version skew are quiet, counted
misses whichever package wrote the file; the size, count and age caps
prune LRU-by-mtime; a failing store warns once."""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core import structure as jst
from repro.pipeline import BucketPolicy as JBucketPolicy
from repro.pipeline import ScheduleCache as JCache
from repro.pipeline import SchedulePersist as JPersist
from repro.pipeline import SchedulePipeline as JPipeline
from repro_torch.core import structure as tst
from repro_torch.pipeline import (SCHEMA_VERSION, BucketPolicy, ScheduleCache,
                                  SchedulePersist, SchedulePipeline,
                                  batch_fingerprint, persist_dir_default)
from repro_torch.pipeline import cache as cache_mod
from repro_torch.pipeline import persist as persist_mod

INPUT_DIM = 4
FIELDS = tuple(f.name for f in dataclasses.fields(tst.LevelSchedule))
PKG = {"jax": (jst, JCache, JPersist), "torch": (tst, ScheduleCache,
                                                 SchedulePersist)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def _corpora(m, n=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        graphs = [m.random_binary_tree(int(rng.integers(2, 7)), rng)
                  for _ in range(3)] + [m.chain(int(rng.integers(1, 5)))]
        inputs = [rng.standard_normal((g.num_nodes, INPUT_DIM))
                  .astype(np.float32) for g in graphs]
        out.append((graphs, inputs))
    return out


def test_fields_match_across_packages():
    assert FIELDS == tuple(f.name for f in
                           dataclasses.fields(jst.LevelSchedule))
    assert persist_mod._FIELDS == FIELDS and SCHEMA_VERSION == 1


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_store_warm_loads_in_the_other_package(tmp_path, writer, reader):
    """Cold packs (and their harvested solos) written by ``writer``;
    a fresh ``reader`` cache on the same directory serves the same
    batches from disk and a new combination of their members by splicing
    per-graph disk entries: zero packs of either kind."""
    wm, wcache, _ = PKG[writer]
    rm, rcache, _ = PKG[reader]
    pads = (16, 16, 2, 16)
    cold = wcache(enabled=True, splice=True, persist=tmp_path)
    for graphs, _ in _corpora(wm):
        cold.get_or_pack(graphs, pads)
    assert cold.packs == 4
    warm = rcache(enabled=True, splice=True, persist=tmp_path)
    corpora = _corpora(rm)
    for (graphs, _), (wgraphs, _) in zip(corpora, _corpora(wm)):
        got = warm.get_or_pack(graphs, pads)
        _assert_same(got, rm.pack_batch(graphs, *pads))
        _assert_same(got, wm.pack_batch(wgraphs, *pads))
    combo = [corpora[0][0][1], corpora[2][0][0], corpora[3][0][3]]
    _assert_same(warm.get_or_pack(combo, pads), rm.pack_batch(combo, *pads))
    s = warm.stats()
    assert s["packs"] == 0 and s["graph_packs"] == 0
    assert s["disk_hits"] == 4 and s["splices"] == 1
    assert s["disk_corrupt"] == 0 and s["disk_stale"] == 0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_decoded_arrays_equal_across_packages(tmp_path, writer):
    """One entry, every field (sorted runs included), loaded by both
    packages' stores: the decoded arrays are byte-equal."""
    graphs_t = _corpora(tst)[1][0]
    graphs_j = _corpora(jst)[1][0]
    key = batch_fingerprint(graphs_t, (None, None, 2, None))
    m, _, store_cls = PKG[writer]
    store_cls(tmp_path).store(key, m.pack_batch(
        graphs_j if writer == "jax" else graphs_t, pad_arity=2))
    got_t = SchedulePersist(tmp_path).load(key)
    got_j = JPersist(tmp_path).load(key)
    _assert_same(got_t, got_j)
    _assert_same(got_t, tst.pack_batch(graphs_t, pad_arity=2))


def test_pipeline_warm_restart_executes_zero_packs(tmp_path, monkeypatch):
    """A JAX pipeline's cold run fills the store; a restarted port
    pipeline serves every batch from disk (``pack_batch`` poisoned), and
    its device twins match a cold pack's."""
    cold = JPipeline(INPUT_DIM, bucket_policy=JBucketPolicy(),
                     cache=JCache(enabled=True, splice=True,
                                  persist=tmp_path))
    for graphs, inputs in _corpora(jst):
        cold.pack(graphs, inputs)
    warm = SchedulePipeline(INPUT_DIM, bucket_policy=BucketPolicy(),
                            cache=ScheduleCache(enabled=True, splice=True,
                                                persist=tmp_path),
                            device="cpu")

    def boom(*a, **k):
        raise AssertionError("pack_batch called on the warm path")

    corpora = _corpora(tst)
    with monkeypatch.context() as mp:
        mp.setattr(cache_mod, "pack_batch", boom)
        got = [warm.pack(g, x) for g, x in corpora]
    s = warm.stats()
    assert s["packs"] == 0 and s["graph_packs"] == 0
    assert s["disk_hits"] == len(corpora)
    for (graphs, inputs), pb in zip(corpora, got):
        fresh = tst.pack_batch(graphs, *warm.pads_for(graphs))
        _assert_same(pb.sched, fresh)
        assert pb.dev.live == fresh.to_device("cpu").live
        np.testing.assert_array_equal(
            pb.ext.numpy(), tst.pack_external(inputs, fresh, INPUT_DIM))


def _stored(tmp_path, writer):
    m, _, store_cls = PKG[writer]
    graphs = [m.chain(4), m.chain(2)]
    key = batch_fingerprint([tst.chain(4), tst.chain(2)], (None,) * 4)
    store_cls(tmp_path).store(key, m.pack_batch(graphs))
    return key, SchedulePersist(tmp_path).path_for(key)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_truncated_file_is_a_quiet_counted_miss(tmp_path, writer):
    key, path = _stored(tmp_path, writer)
    blob = path.read_bytes()
    for cut in (0, 3, persist_mod._HEADER_LEN - 1,
                persist_mod._HEADER_LEN + 5, len(blob) - 1):
        path.write_bytes(blob[:cut])
        fresh = SchedulePersist(tmp_path)
        assert fresh.load(key) is None
        assert fresh.stats()["disk_corrupt"] == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("where", ["magic", "payload"])
def test_garbled_file_is_a_quiet_counted_miss(tmp_path, writer, where):
    key, path = _stored(tmp_path, writer)
    blob = bytearray(path.read_bytes())
    blob[0 if where == "magic" else persist_mod._HEADER_LEN + 10] ^= 0xFF
    path.write_bytes(bytes(blob))
    fresh = SchedulePersist(tmp_path)
    assert fresh.load(key) is None
    assert fresh.stats()["disk_corrupt"] == 1
    assert JPersist(tmp_path).load(key) is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_version_skew_is_a_quiet_counted_miss(tmp_path, writer):
    key, path = _stored(tmp_path, writer)
    blob = bytearray(path.read_bytes())
    off = len(persist_mod.MAGIC)
    blob[off: off + 8] = np.uint64(SCHEMA_VERSION + 1).tobytes()
    path.write_bytes(bytes(blob))
    fresh = SchedulePersist(tmp_path)
    assert fresh.load(key) is None
    assert fresh.stats()["disk_stale"] == 1
    assert fresh.stats()["disk_corrupt"] == 0


def test_cache_heals_a_poisoned_store(tmp_path):
    """A poisoned batch entry and its harvested solo cost one re-pack;
    the cold pack replaces both files."""
    graphs = [tst.chain(5)]
    ScheduleCache(enabled=True, persist=tmp_path,
                  splice=True).get_or_pack(graphs)
    paths = list(tmp_path.glob("*.sched"))
    assert len(paths) == 2
    for p in paths:
        p.write_bytes(p.read_bytes()[:20])
    c2 = ScheduleCache(enabled=True, persist=tmp_path, splice=True)
    c2.get_or_pack(graphs)
    assert c2.packs == 1 and c2.persist.corrupt == 2
    c3 = ScheduleCache(enabled=True, persist=tmp_path, splice=True)
    c3.get_or_pack(graphs)
    assert c3.disk_hits == 1 and c3.packs == 0 and c3.persist.corrupt == 0


def _fill(store, n):
    keys = []
    for i in range(n):
        key = bytes([i]) * 16
        store.store(key, tst.pack_batch([tst.chain(2 + i % 3)]))
        os.utime(store.path_for(key), (1000.0 + i, 1000.0 + i))
        keys.append(key)
    return keys


def test_caps_prune_oldest_first(tmp_path):
    store = SchedulePersist(tmp_path / "n")
    keys = _fill(store, 4)
    store.max_entries = 2
    assert store.gc(now=1010.0) == 2
    assert [k in store for k in keys] == [False, False, True, True]
    assert store.stats()["disk_gc_removed"] == 2

    store = SchedulePersist(tmp_path / "b")
    keys = _fill(store, 3)
    store.max_bytes = int(store.path_for(keys[0]).stat().st_size * 2.5)
    assert store.gc(now=1010.0) == 1 and keys[0] not in store
    assert store.size_bytes() <= store.max_bytes

    store = SchedulePersist(tmp_path / "a")
    keys = _fill(store, 3)
    store.max_age_s = 5.0
    assert store.gc(now=1006.5) == 2 and keys[2] in store


def test_caps_from_env_and_gc_after_each_store(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCHED_PERSIST_MAX_ENTRIES", "2")
    monkeypatch.setenv("REPRO_SCHED_PERSIST_MAX_MB", "1.5")
    monkeypatch.setenv("REPRO_SCHED_PERSIST_MAX_AGE_S", "60")
    store = SchedulePersist(tmp_path)
    assert (store.max_entries, store.max_bytes, store.max_age_s) == \
        (2, int(1.5 * 1024 * 1024), 60.0)
    assert SchedulePersist(tmp_path, max_entries=7).max_entries == 7
    monkeypatch.delenv("REPRO_SCHED_PERSIST_MAX_AGE_S")
    store = SchedulePersist(tmp_path / "entries")     # entries dated 1970
    _fill(store, 5)
    assert len(store) <= 3               # at most one over before its gc
    store.gc()
    assert len(store) == 2


def test_load_touch_keeps_an_entry_hot(tmp_path):
    store = SchedulePersist(tmp_path)
    keys = _fill(store, 2)
    assert store.load(keys[0]) is not None
    store.max_entries = 1
    assert store.gc() == 1
    assert keys[0] in store and keys[1] not in store


def test_store_failure_is_swallowed_and_warns_once(tmp_path, monkeypatch):
    store = SchedulePersist(tmp_path)

    def full_disk(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(persist_mod.tempfile, "mkstemp", full_disk)
    with pytest.warns(RuntimeWarning, match="degrading to cold packs"):
        assert not store.store(b"\x03" * 16, tst.pack_batch([tst.chain(3)]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        store.store(b"\x04" * 16, tst.pack_batch([tst.chain(4)]))
    assert store.store_errors == 2 and list(tmp_path.glob("*")) == []


def test_persist_env_gate(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_SCHED_PERSIST", raising=False)
    assert persist_dir_default() is None and ScheduleCache().persist is None
    monkeypatch.setenv("REPRO_SCHED_PERSIST", str(tmp_path / "store"))
    assert ScheduleCache().persist.root == tmp_path / "store"
    assert ScheduleCache(persist=False).persist is None
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("REPRO_SCHED_PERSIST", str(blocker / "store"))
    c = ScheduleCache(enabled=True)
    assert c.persist is None
    c.get_or_pack([tst.chain(3)])
    assert c.packs == 1
    with pytest.raises(OSError):
        ScheduleCache(enabled=True, persist=str(blocker / "store"))
