"""The batch composer in the port (``repro_torch.pipeline.composer``)
against the JAX package's ``BatchComposer`` on the same corpora (with
repeated topologies, chains, trees and DAGs): the same composed batches
(sample ids, pads, riders), the same ``CompositionStats`` and
``ShardedCompositionStats``, the same sharded steps (replica ids,
filler weights, shared pads), the same ``fifo_stats``, the same
refusals, and the stats published to the port's registry."""

import dataclasses

import numpy as np
import pytest

from repro.core import structure as jst
from repro.pipeline import BatchComposer as JComposer
from repro.pipeline import BucketPolicy as JPolicy
from repro.pipeline import fifo_stats as jfifo
from repro_torch.core import structure as tst
from repro_torch.data import ComposedBatchSource
from repro_torch.obs.registry import get_registry
from repro_torch.pipeline import BatchComposer, BucketPolicy, fifo_stats


def _corpus(m, seed, n):
    """A corpus with heavy repetition: a few hot topologies (one shared
    object each, as a dataset of parsed sentences has) among fresh
    trees, chains and DAGs; inputs and a label rider."""
    rng = np.random.default_rng(seed)
    hot = [m.chain(3), m.random_binary_tree(4, np.random.default_rng(7)),
           m.balanced_binary_tree(4)]
    graphs = []
    for _ in range(n):
        r = int(rng.integers(0, 6))
        if r < 3:
            graphs.append(hot[r])
        elif r == 3:
            graphs.append(m.random_binary_tree(int(rng.integers(1, 9)), rng))
        elif r == 4:
            graphs.append(m.chain(int(rng.integers(1, 9))))
        else:
            graphs.append(m.random_dag(int(rng.integers(2, 8)), rng,
                                       max_arity=3))
    inputs = [np.full((g.num_nodes, 2), i, np.float32)
              for i, g in enumerate(graphs)]
    return graphs, inputs, {"labels": list(range(100, 100 + n))}


POLICIES = {"mult8": (lambda: JPolicy(), lambda: BucketPolicy()),
            "pow2": (lambda: JPolicy(mode="pow2"),
                     lambda: BucketPolicy(mode="pow2")),
            "tight": (lambda: None, lambda: None)}


def _same_batch(t, j):
    np.testing.assert_array_equal(t.sample_ids, j.sample_ids)
    assert tuple(t.pads or ()) == tuple(j.pads or ())
    assert t.aux == j.aux
    assert [g.num_nodes for g in t.graphs] == [g.num_nodes for g in j.graphs]
    for a, b in zip(t.inputs, j.inputs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("budget", [None, 2])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("bs,n", [(4, 37), (8, 64), (16, 20)])
@pytest.mark.parametrize("seed", range(2))
def test_composed_batches_and_stats_equal_jax(seed, bs, n, policy, budget):
    jp, tp = (f() for f in POLICIES[policy])
    tb, ts = BatchComposer(bs, bucket_policy=tp, shape_budget=budget) \
        .compose(*_corpus(tst, seed, n))
    jb, js = JComposer(bs, bucket_policy=jp, shape_budget=budget) \
        .compose(*_corpus(jst, seed, n))
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        _same_batch(t, j)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    ids = np.sort(np.concatenate([b.sample_ids for b in tb]))
    np.testing.assert_array_equal(ids, np.arange(n))          # lossless


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("bs,n", [(8, 41), (16, 64), (8, 3)])
@pytest.mark.parametrize("seed", range(2))
def test_sharded_steps_and_stats_equal_jax(seed, bs, n, shards):
    ts_, tst_ = BatchComposer(bs, bucket_policy=BucketPolicy()) \
        .compose_sharded(*_corpus(tst, seed, n), num_shards=shards)
    js_, jst_ = JComposer(bs, bucket_policy=JPolicy()) \
        .compose_sharded(*_corpus(jst, seed, n), num_shards=shards)
    assert len(ts_) == len(js_)
    for t, j in zip(ts_, js_):
        assert tuple(t.pads) == tuple(j.pads) and len(t) == len(j)
        for rt, rj in zip(t.replicas, j.replicas):
            _same_batch(rt, rj)
    assert tst_.summary() == jst_.summary()
    assert tst_.node_imbalance == jst_.node_imbalance


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", range(2))
def test_fifo_stats_equal_jax(seed, policy):
    jp, tp = (f() for f in POLICIES[policy])
    t = fifo_stats(_corpus(tst, seed, 50)[0], 8, tp)
    j = jfifo(_corpus(jst, seed, 50)[0], 8, jp)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


REFUSALS = {
    "batch size": lambda m, C, c: C(0),
    "shape budget": lambda m, C, c: C(4, shape_budget=0),
    "empty corpus": lambda m, C, c: C(4).compose([]),
    "inputs": lambda m, C, c: C(4).compose(c[0], c[1][:-1]),
    "rider length": lambda m, C, c: C(4).compose(c[0], None,
                                                 {"y": [1]}),
    "reserved rider": lambda m, C, c: C(4).compose(
        c[0], None, {"sample_ids": list(range(len(c[0])))}),
    "shards": lambda m, C, c: C(4).compose_sharded(c[0], num_shards=0),
    "indivisible": lambda m, C, c: C(6).compose_sharded(c[0],
                                                        num_shards=4),
    "weights rider": lambda m, C, c: C(4).compose_sharded(
        c[0], None, {"weights": [1.0] * len(c[0])}, num_shards=2),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_equal_jax(case):
    with pytest.raises(ValueError) as et:
        REFUSALS[case](tst, BatchComposer, _corpus(tst, 0, 10))
    with pytest.raises(ValueError) as ej:
        REFUSALS[case](jst, JComposer, _corpus(jst, 0, 10))
    assert str(et.value) == str(ej.value)


def test_stats_published_to_the_registry():
    reg = get_registry()
    reg.reset()
    _, stats = BatchComposer(8).compose(*_corpus(tst, 3, 40))
    assert reg.gauge("compose.hit_rate") == stats.hit_rate
    assert reg.gauge("compose.num_batches") == stats.num_batches
    _, sstats = BatchComposer(8).compose_sharded(*_corpus(tst, 3, 40),
                                                 num_shards=2)
    assert reg.gauge("compose_sharded.num_fillers") == sstats.num_fillers
    assert "compose.mean_occupancy" in reg.snapshot()["gauges"]


def test_composed_source_replays_the_plan_every_epoch():
    graphs, inputs, aux = _corpus(tst, 4, 30)
    comp = BatchComposer(8)
    batches, _ = comp.compose(graphs, inputs, aux)
    src = ComposedBatchSource(graphs, inputs, aux, composer=comp, epochs=2)
    items = list(src)
    assert len(items) == 2 * len(batches)
    for (g, x, a, pads), b in zip(items, batches + batches):
        assert g == b.graphs and pads == b.pads
        np.testing.assert_array_equal(a["sample_ids"], b.sample_ids)
        assert a["labels"] == [100 + i for i in b.sample_ids]
    assert src.stats.num_batches == len(batches)
    with pytest.raises(StopIteration):
        next(src)
