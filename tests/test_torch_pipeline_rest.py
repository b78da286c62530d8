"""The rest of the schedule pipeline in the port against the JAX package:
the three-tier cache's ``stats()`` equal JAX's after every step of one
scripted lookup sequence (batch memory, graph splice, graph re-pad, disk,
warm restart, eviction, reset); the ``REPRO_SCHED_SPLICE`` and
``REPRO_SCHED_PERSIST`` gates (set through ``monkeypatch`` only); a warm
restart with ``packs == graph_packs == 0``; ``pack`` with aux riders and
explicit pads; ``prefetch`` keeping a composed item's pads; the graph
tier's ``extras`` living as long as their entry; and
``ShardedPipeline.pack_step`` equal to JAX's stacked arrays."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import structure as jst
from repro.pipeline import ScheduleCache as JCache
from repro.pipeline import SchedulePipeline as JPipeline
from repro.pipeline import ShardedPipeline as JSharded
from repro_torch.core import structure as tst
from repro_torch.pipeline import (BucketPolicy, PackedBatch, PadDims,
                                  ScheduleCache, SchedulePipeline,
                                  ShardedPipeline, splice_enabled_default)
from repro_torch.pipeline import cache as cache_mod

X = 3
FIELDS = tuple(f.name for f in dataclasses.fields(tst.LevelSchedule))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graphs(m, seed=0):
    rng = np.random.default_rng(seed)
    gs = [m.random_binary_tree(int(rng.integers(2, 7)), rng)
          for _ in range(5)]
    return gs + [m.chain(4), m.random_dag(6, rng, max_arity=3)]


def _script(m, Cache, root):
    """One lookup sequence through every tier; yields after each step."""
    g = _graphs(m)
    pads = (16, 32, 3, 16)
    c = Cache(capacity=2, enabled=True, splice=True, persist=root)
    c.get_or_pack(g[:3], pads)                       # cold + harvest
    yield "cold", c
    c.get_or_pack(g[:3], pads)                       # memory hit
    yield "hit", c
    c.get_or_pack([g[2], g[0]], pads)                # splice
    yield "splice", c
    c.get_or_pack([g[2], g[0]], pads, with_runs=False)   # hit, no runs
    yield "hit without runs", c
    c.get_or_pack_graph(g[1], (8, 8, 2, 8))          # re-pad a tight solo
    yield "graph re-pad", c
    c.get_or_pack_graph(g[1], (8, 8, 2, 8))          # graph hit
    yield "graph hit", c
    c.get_or_pack_graph(g[5])                        # solo cold pack
    yield "graph pack", c
    c.get_or_pack(g[3:5], pads)                      # cold, evicts LRU
    c.get_or_pack(g[:3], pads)                       # evicted → disk
    yield "eviction and disk", c
    warm = Cache(enabled=True, splice=True, persist=root)
    warm.get_or_pack(g[:3], pads)                    # batch from disk
    warm.get_or_pack([g[4], g[1], g[0]], pads)       # graph-disk splice
    warm.get_or_pack_graph(g[5])                     # graph from disk
    yield "warm restart", warm
    warm.get_or_pack([g[6]], pads)                   # DAG: cold
    warm.get_or_pack([g[6], g[0]])                   # tight: splice
    yield "warm misses", warm
    warm.reset_stats()
    yield "reset", warm


def test_cache_stats_equal_jax_over_a_scripted_sequence(tmp_path):
    steps = zip(_script(tst, ScheduleCache, tmp_path / "torch"),
                _script(jst, JCache, tmp_path / "jax"))
    seen = []
    for (name, tc), (jname, jc) in steps:
        assert name == jname
        assert tc.stats() == jc.stats(), name
        seen.append(name)
    assert seen[-1] == "reset" and "warm restart" in seen


def test_warm_restart_packs_nothing(tmp_path, monkeypatch):
    """A restarted cache: batch lookups from disk, never-seen
    combinations spliced from per-graph disk entries, solo lookups from
    disk — ``pack_batch`` poisoned, ``packs == graph_packs == 0``."""
    g = _graphs(tst, 3)
    pads = (16, 32, 3, 16)
    cold = ScheduleCache(enabled=True, splice=True, persist=tmp_path)
    cold.get_or_pack(g[:4], pads)
    cold.get_or_pack(g[4:], pads)
    cold.get_or_pack_graph(g[0], (16, 16, 2, 16))

    def boom(*a, **k):
        raise AssertionError("pack_batch on a warm restart")

    monkeypatch.setattr(cache_mod, "pack_batch", boom)
    warm = ScheduleCache(enabled=True, splice=True, persist=tmp_path)
    for batch in (g[:4], g[4:], g[::-1], [g[6], g[2]]):
        got, dev = warm.get_or_pack_device(batch, pads, device="cpu")
        want = tst.pack_batch(batch, *pads)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert dev.live == want.to_device("cpu").live
    warm.get_or_pack_graph(g[0], (16, 16, 2, 16))
    s = warm.stats()
    assert s["packs"] == 0 and s["graph_packs"] == 0
    # two batch combinations and the padded solo (a re-pad of its tight
    # disk entry: re-pads are not stored) splice
    assert s["disk_hits"] == 2 and s["splices"] == 3


def test_env_gates(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_SCHED_PERSIST", raising=False)
    monkeypatch.setenv("REPRO_SCHED_SPLICE", "0")
    assert not splice_enabled_default()
    c = ScheduleCache(enabled=True)
    assert not c.splice and c.persist is None
    g = _graphs(tst)
    c.get_or_pack(g[:2])
    c.get_or_pack([g[1], g[0]])
    assert (c.harvests, c.splices, c.packs) == (0, 0, 2)
    monkeypatch.setenv("REPRO_SCHED_SPLICE", "1")
    monkeypatch.setenv("REPRO_SCHED_PERSIST", str(tmp_path))
    pipe = SchedulePipeline(X, device="cpu")
    assert pipe.cache.splice and pipe.cache.persist.root == tmp_path
    assert not SchedulePipeline(X, splice=False, device="cpu").cache.splice


def _inputs(graphs, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((g.num_nodes, X)).astype(np.float32)
            for g in graphs]


def test_pack_takes_riders_and_explicit_pads():
    g = _graphs(tst)[:3]
    x = _inputs(g)
    pipe = SchedulePipeline(X, device="cpu")
    b = pipe.pack(g, x, {"labels": [1, 0, 1]}, pads=PadDims(16, 24, 2, 16))
    assert b.aux == {"labels": [1, 0, 1]}
    assert (b.sched.T, b.sched.M, b.sched.A, b.sched.N) == (16, 24, 2, 16)
    tight = pipe.pack(g, x, pads=None)
    assert (tight.sched.T, tight.sched.M) == tst.tight_dims(g)[:2]
    assert pipe.pack(g, x).sched.M == BucketPolicy().bucket(g).width
    with pytest.raises(ValueError, match="pads must be"):
        pipe.pack(g, x, pads="tight")


def test_prefetch_keeps_composed_pads_and_order():
    g = _graphs(tst) * 4
    x = _inputs(g)
    pipe = SchedulePipeline(X, bucket_policy=BucketPolicy(mode="pow2"),
                            device="cpu")
    batches, _ = pipe.compose(g, x, {"y": list(range(len(g)))},
                              batch_size=4)
    ready = PackedBatch(sched=None, dev=None, ext=None)
    with pipe.prefetch([b.as_item() for b in batches] + [ready]) as it:
        got = list(it)
    assert got[-1] is ready
    for b, p in zip(batches, got):
        assert (p.sched.T, p.sched.M, p.sched.A, p.sched.N) == tuple(b.pads)
        np.testing.assert_array_equal(p.aux["sample_ids"], b.sample_ids)
        assert p.aux["y"] == list(b.sample_ids)


def test_graph_tier_extras_live_with_their_entry():
    """The continuous engine's frontier-plan memo: the same dict on
    every hit, gone with its evicted entry."""
    g = [tst.chain(n) for n in (3, 4, 5)]
    c = ScheduleCache(enabled=True, graph_capacity=2, splice=True,
                      persist=False)
    s, ex = c.get_or_pack_graph(g[0], (16, 16, 2, 16), with_extras=True)
    ex["frontier_plan"] = "plan"
    s2, ex2 = c.get_or_pack_graph(g[0], (16, 16, 2, 16), with_extras=True)
    assert s2 is s and ex2 is ex
    c.get_or_pack_graph(g[1], (16, 16, 2, 16))
    c.get_or_pack_graph(g[2], (16, 16, 2, 16))
    _, ex3 = c.get_or_pack_graph(g[0], (16, 16, 2, 16), with_extras=True)
    assert ex3 == {} and c.graph_evictions >= 1


@pytest.mark.parametrize("with_runs", [True, False])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_pack_step_equals_jax(shards, with_runs):
    def corpus(m):
        rng = np.random.default_rng(5)
        gs = [m.random_binary_tree(int(rng.integers(1, 8)), rng)
              for _ in range(22)]
        return gs, _inputs(gs, 1), {"labels": list(range(22))}

    tp = ShardedPipeline(X, shards, with_runs=with_runs, device="cpu")
    jp = JSharded(X, shards, with_runs=with_runs)
    tsteps, _ = tp.composer(8).compose_sharded(*corpus(tst),
                                               num_shards=shards)
    jsteps, _ = jp.composer(8).compose_sharded(*corpus(jst),
                                               num_shards=shards)
    for ts, js in zip(tsteps, jsteps):
        t, j = tp.pack_step(ts), jp.pack_step(js)
        assert set(t) == set(j)
        np.testing.assert_array_equal(t["ext"].numpy(), np.asarray(j["ext"]))
        np.testing.assert_array_equal(t["weights"].numpy(),
                                      np.asarray(j["weights"]))
        for k in ("sample_ids", "labels"):
            np.testing.assert_array_equal(t[k], j[k])
        for f in ("child_ids", "child_mask", "ext_ids", "node_mask",
                  "slot_of", "node_valid", "root_slots", "sort_perm",
                  "sorted_child_ids", "run_head"):
            a, b = getattr(t["dev"], f), getattr(j["dev"], f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the unstackable fields: one entry per replica, each that
        # replica's own pack's
        for r, rep in enumerate(ts.replicas):
            own = tst.pack_batch(rep.graphs, *ts.pads,
                                 with_runs=with_runs).to_device("cpu")
            assert t["dev"].live[r] == own.live
            assert (t["dev"].child_plans is None) == (not with_runs)
    s = tp.stats()
    assert s["packs"] == sum(p.cache.packs for p in tp.pipes)
    assert len(s["per_replica"]) == shards


def test_pipeline_stats_keys_equal_jax():
    g = _graphs(tst)
    jg = _graphs(jst)
    tp = SchedulePipeline(X, device="cpu", splice=True)
    jp = JPipeline(X, splice=True)
    for batch, jbatch in ((g[:3], jg[:3]), (g[:3], jg[:3]),
                          (g[2:0:-1], jg[2:0:-1])):
        tp.pack(batch, _inputs(batch))
        jp.pack(jbatch, _inputs(jbatch))
    t, j = tp.stats(), jp.stats()
    assert {k: v for k, v in t.items() if "disk" not in k} == \
        {k: v for k, v in j.items() if "disk" not in k}
