"""Parity of the port's host schedule layer with the JAX package:
graph builders, ``pack_batch`` (all 11 ``LevelSchedule`` fields
byte-identical), ``tight_dims``, ``pack_external``, topology
fingerprints, bucket policy, and the device copy."""

import numpy as np
import pytest
import torch

from repro.core import structure as jst
from repro.pipeline import buckets as jbk
from repro.pipeline import fingerprint as jfp
from repro_torch.core import structure as tst
from repro_torch.pipeline import buckets as tbk
from repro_torch.pipeline import fingerprint as tfp

FIELDS = ("child_ids", "child_mask", "ext_ids", "node_mask", "slot_of",
          "node_valid", "root_slots", "num_nodes", "sort_perm",
          "sorted_child_ids", "run_head")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(make, seed, n):
    """The same graphs built by both packages from the same seed."""
    return ([make(jst, np.random.default_rng(seed + i)) for i in range(n)],
            [make(tst, np.random.default_rng(seed + i)) for i in range(n)])


MAKERS = {
    "trees": lambda m, r: m.random_binary_tree(int(r.integers(1, 12)), r),
    "dags": lambda m, r: m.random_dag(int(r.integers(1, 14)), r,
                                      max_arity=3),
    "chains": lambda m, r: m.chain(int(r.integers(1, 9))),
    "balanced": lambda m, r: m.balanced_binary_tree(
        int(2 ** r.integers(0, 4))),
}

PADS = {
    "tight": {},
    "padded": dict(pad_levels=16, pad_width=64, pad_arity=4, pad_nodes=32),
    "levels_only": dict(pad_levels=20),
}


def _assert_same_schedule(js, ts):
    for f in FIELDS:
        a, b = getattr(js, f), getattr(ts, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        assert a.dtype == b.dtype, f
        assert a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("with_runs", [True, False])
@pytest.mark.parametrize("pads", sorted(PADS))
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_pack_batch_byte_identical(kind, pads, with_runs):
    jg, tg = _pair(MAKERS[kind], 100, 6)
    for a, b in zip(jg, tg):
        assert [list(c) for c in a.children] == [list(c) for c in b.children]
    js = jst.pack_batch(jg, with_runs=with_runs, **PADS[pads])
    ts = tst.pack_batch(tg, with_runs=with_runs, **PADS[pads])
    _assert_same_schedule(js, ts)
    assert jst.tight_dims(jg) == tst.tight_dims(tg)


def test_attach_sorted_runs_matches():
    jg, tg = _pair(MAKERS["dags"], 7, 5)
    js = jst.attach_sorted_runs(jst.pack_batch(jg, with_runs=False))
    ts = tst.attach_sorted_runs(tst.pack_batch(tg, with_runs=False))
    _assert_same_schedule(js, ts)
    # duplicate destinations within a level are what the runs are for
    assert (ts.run_head == 0).any()


def test_from_parent_pointers_and_errors_match():
    parents = [-1, 0, 0, 1, 1, 2]
    a = jst.from_parent_pointers(parents)
    b = tst.from_parent_pointers(parents)
    assert a.children == b.children
    assert np.array_equal(a.levels(), b.levels())
    assert a.roots() == b.roots()
    g = tst.random_binary_tree(5, np.random.default_rng(0))
    with pytest.raises(ValueError, match="pad_levels"):
        tst.pack_batch([g], pad_levels=1)
    with pytest.raises(ValueError, match="cycle"):
        tst.InputGraph(children=[[1], [0]]).levels()


def test_pack_external_matches():
    rng = np.random.default_rng(3)
    jg, tg = _pair(MAKERS["trees"], 30, 4)
    xs = [rng.standard_normal((g.num_nodes, 5)).astype(np.float32)
          for g in jg]
    js = jst.pack_batch(jg, pad_nodes=32)
    ts = tst.pack_batch(tg, pad_nodes=32)
    a = jst.pack_external(xs, js, 5)
    b = tst.pack_external(xs, ts, 5)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_fingerprints_equal_across_packages(kind):
    jg, tg = _pair(MAKERS[kind], 200, 5)
    for a, b in zip(jg, tg):
        assert jfp.graph_fingerprint(a) == tfp.graph_fingerprint(b)
        assert jfp.graph_schedule_key(a, (8, 8, 2, 16)) == \
            tfp.graph_schedule_key(b, (8, 8, 2, 16))
    for pads in (None, (8, 16, 3, 32)):
        assert jfp.batch_fingerprint(jg, pads) == \
            tfp.batch_fingerprint(tg, pads)


def test_fingerprint_freezes_topology():
    g = tst.random_binary_tree(4, np.random.default_rng(0))
    tfp.graph_fingerprint(g)
    with pytest.raises((AttributeError, TypeError)):
        g.children[0].append(1)
    g.children = [list(c) for c in g.children]
    with pytest.raises(ValueError, match="frozen"):
        tfp.graph_fingerprint(g)


@pytest.mark.parametrize("mode", ["multiple", "pow2"])
def test_bucket_policy_matches(mode):
    jg, tg = _pair(MAKERS["trees"], 50, 7)
    jp = jbk.BucketPolicy(mode=mode).bucket(jg)
    tp = tbk.BucketPolicy(mode=mode).bucket(tg)
    assert tuple(jp) == tuple(tp)


def test_to_device_keeps_int32_and_values():
    g = [tst.random_dag(9, np.random.default_rng(1), max_arity=3)]
    s = tst.pack_batch(g)
    d = s.to_device("cpu")
    assert d.child_ids.dtype == torch.int32
    assert d.ext_ids.dtype == torch.int32 and d.root_slots.dtype == torch.int32
    assert d.node_mask.dtype == torch.float32
    assert (d.T, d.M, d.A) == (s.T, s.M, s.A)
    assert np.array_equal(d.child_ids.numpy(), s.child_ids)
    assert np.array_equal(d.sort_perm.numpy(), s.sort_perm)
    assert tst.pack_batch(g, with_runs=False).to_device("cpu").sort_perm \
        is None
