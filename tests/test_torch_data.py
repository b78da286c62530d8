"""The data layer and the async packer in the port against the JAX
package: ``synthetic_corpus``/``lm_batches``/``token_batch_specs``,
``tree_fc_dataset``/``var_len_chains``/``sst_like_dataset`` and
``fit_bucket`` give equal arrays for the same seed; the loaders keep
order, latch their end state and surface errors on the consumer;
``close`` drains and stops the thread; ``AsyncPacker`` retries a
``SimulatedFailure`` in place (never another error, a CUDA error
included) and gives up after its budget."""

import threading

import numpy as np
import pytest
import torch

from repro.core import structure as jst
from repro.data import loader as jloader
from repro.data import synthetic as jsyn
from repro.data import trees as jtrees
from repro_torch.core import structure as tst
from repro_torch.data import (PrefetchLoader, ShardedSource, lm_batches,
                              synthetic_corpus, token_batch_specs)
from repro_torch.data import trees as ttrees
from repro_torch.dist.fault import (ScriptedChaos, SimulatedFailure,
                                    install_chaos)
from repro_torch.pipeline import AsyncPacker

JOIN_S = 5.0


@pytest.mark.parametrize("seed", range(3))
def test_synthetic_corpus_and_batches_equal_jax(seed):
    c = synthetic_corpus(5000, 97, seed=seed)
    np.testing.assert_array_equal(c, jsyn.synthetic_corpus(5000, 97,
                                                           seed=seed))
    assert c.dtype == np.int32 and c.min() >= 0 and c.max() < 97
    for shard in range(2):
        t = lm_batches(c, 4, 16, seed=seed, shard=shard, num_shards=2)
        j = jsyn.lm_batches(c, 4, 16, seed=seed, shard=shard, num_shards=2)
        for _ in range(3):
            bt, bj = next(t), next(j)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(bt[k], bj[k])
            np.testing.assert_array_equal(bt["tokens"][:, 1:],
                                          bt["labels"][:, :-1])
    assert token_batch_specs(4, 16) == jsyn.token_batch_specs(4, 16)


DATASETS = {
    "tree_fc": lambda m, s: m.tree_fc_dataset(3, leaves=8, input_dim=5,
                                              seed=s),
    "var_len_chains": lambda m, s: m.var_len_chains(9, input_dim=5, seed=s),
    "sst_like": lambda m, s: m.sst_like_dataset(9, input_dim=5, seed=s),
}


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_tree_datasets_equal_jax(name, seed):
    t, j = DATASETS[name](ttrees, seed), DATASETS[name](jtrees, seed)
    assert len(t) == len(j)
    for gt, gj, xt, xj in zip(t.graphs, j.graphs, t.inputs, j.inputs):
        assert gt.children == gj.children
        np.testing.assert_array_equal(xt, xj)
    if j.labels is None:
        assert t.labels is None
    else:
        np.testing.assert_array_equal(t.labels, j.labels)


@pytest.mark.parametrize("bs", [1, 3, 8])
@pytest.mark.parametrize("seed", range(2))
def test_fit_bucket_equal_jax(seed, bs):
    t = ttrees.sst_like_dataset(12, input_dim=2, seed=seed).graphs
    j = jtrees.sst_like_dataset(12, input_dim=2, seed=seed).graphs
    bt, bj = tst.fit_bucket(t, bs), jst.fit_bucket(j, bs)
    assert (bt.pad_levels, bt.pad_width, bt.pad_arity, bt.pad_nodes) == \
        (bj.pad_levels, bj.pad_width, bj.pad_arity, bj.pad_nodes)
    got, want = bt.pack(t[:bs]), bj.pack(j[:bs])
    np.testing.assert_array_equal(got.child_ids, want.child_ids)
    np.testing.assert_array_equal(got.slot_of, want.slot_of)


def _make_iter(shard, num_shards, start):
    def gen():
        i = start
        while True:
            yield {"i": np.asarray([i * num_shards + shard])}
            i += 1
    return gen()


def _ids(loader, n):
    return [int(next(loader)["i"][0]) for _ in range(n)]


def test_loader_order_seek_and_straggler_takeover():
    loader = PrefetchLoader(ShardedSource(_make_iter, 0, 1), depth=2)
    assert _ids(loader, 5) == [0, 1, 2, 3, 4]
    loader.close()
    src = ShardedSource(_make_iter, 1, 2)
    src.next_batch()
    src.seek(10)
    assert int(src.next_batch()["i"][0]) == 21 and src.batch_index == 11
    primary = ShardedSource(_make_iter, 0, 1)
    spare = ShardedSource(_make_iter, 0, 1)
    loader = PrefetchLoader(primary, depth=1, deadline_s=0.05, spare=spare,
                            delay_fn=lambda i: 10.0 if i == 2 else 0.0)
    assert _ids(loader, 5) == [0, 1, 2, 3, 4] and loader.takeovers == 1
    loader.close()


def test_loader_error_surfaces_on_the_consumer_and_close_latches():
    def bad(shard, num_shards, start):
        def gen():
            yield {"i": np.asarray([0])}
            raise ValueError("bad shard")
        return gen()

    loader = PrefetchLoader(ShardedSource(bad, 0, 1), depth=2)
    assert _ids(loader, 1) == [0]
    for _ in range(2):                               # latched
        with pytest.raises(ValueError, match="bad shard"):
            next(loader)
    loader.close()
    loader = PrefetchLoader(ShardedSource(_make_iter, 0, 1), depth=2)
    next(loader)
    loader.close()
    assert not loader._bg._thread.is_alive()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="closed"):
            next(loader)


def test_background_prefetcher_matches_jax_order():
    t = jloader.BackgroundPrefetcher(iter(range(30)).__next__, depth=3)
    got = list(t)
    p = AsyncPacker(range(30), lambda x: x, depth=3)
    assert list(p) == got == list(range(30))
    with pytest.raises(StopIteration):
        next(p)                                       # latched end
    p.close()
    t.close()


def test_async_packer_keeps_order_and_close_drains():
    release = threading.Event()

    def slow(x):
        if x == 5:
            release.wait(JOIN_S)
        return x * x

    p = AsyncPacker(range(100), slow, depth=3)
    assert [next(p) for _ in range(5)] == [0, 1, 4, 9, 16]
    release.set()
    p.close()                      # mid-stream: drains, stops the thread
    p._bg._thread.join(JOIN_S)
    assert not p._bg._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(p)


def test_async_packer_error_surfaces_at_its_batch():
    def boom(x):
        if x == 2:
            raise RuntimeError("bad batch 2")
        return x

    p = AsyncPacker([0, 1, 2, 3], boom, retries=5)
    assert next(p) == 0 and next(p) == 1
    for _ in range(2):
        with pytest.raises(RuntimeError, match="bad batch 2"):
            next(p)
    assert p.transient_retries == 0          # never retried
    p.close()


def test_async_packer_retries_only_simulated_failures():
    calls = []

    def flaky(x):
        calls.append(x)
        if x == 1 and calls.count(1) <= 2:
            raise SimulatedFailure("transient")
        return x

    p = AsyncPacker(range(4), flaky, retries=2)
    assert list(p) == [0, 1, 2, 3]
    assert p.transient_retries == 2 and calls.count(1) == 3
    p.close()
    # the chaos site retries the same item too
    with install_chaos(ScriptedChaos(fail={"prefetch": [0, 3]})) as hook:
        p = AsyncPacker(range(3), lambda x: x)
        assert list(p) == [0, 1, 2]
        p.close()
    assert hook.fired["prefetch"] == [0, 3] and p.transient_retries == 2
    # past the budget the failure surfaces at its batch
    p = AsyncPacker(range(3), lambda x: (_ for _ in ()).throw(
        SimulatedFailure("down")) if x == 1 else x, retries=1)
    assert next(p) == 0
    with pytest.raises(SimulatedFailure, match="down"):
        next(p)
    assert p.transient_retries == 1
    p.close()


def test_async_packer_never_retries_a_device_error():
    """A CUDA fault on the pack thread is an ordinary error there: it
    surfaces on the consumer at its batch, once, unretried."""
    err = getattr(torch, "AcceleratorError", RuntimeError)
    calls = []

    def fault(x):
        calls.append(x)
        if x == 1:
            raise err("CUDA error: an illegal memory access was "
                      "encountered")
        return x

    p = AsyncPacker(range(3), fault, retries=3)
    assert next(p) == 0
    with pytest.raises(err, match="illegal memory access"):
        next(p)
    assert calls.count(1) == 1 and p.transient_retries == 0
    p.close()
