"""The port's ``StructureServeEngine`` against the JAX engine on the same
requests and params (roots at 1e-4), plus the behaviour the JAX
package's serving and chaos tests pin down: rejection at the door, a
full queue, TTL deadlines, the kernel degradation ladder and its
breaker, poison quarantine, NaN isolation, and the schedule cache."""

import numpy as np
import pytest
import torch

import jax

from repro.core import structure as jst
from repro.models.treelstm import TreeLSTMVertex as JTreeLSTM
from repro.serve import StructureRequest as JRequest
from repro.serve import StructureServeEngine as JEngine
from repro_torch.core import structure as tst
from repro_torch.dist.fault import (ScriptedChaos, SimulatedFailure,
                                    chaos_fire, get_chaos, install_chaos)
from repro_torch.interop import params_from_jax
from repro_torch.models.treelstm import TreeLSTMVertex as TTreeLSTM
from repro_torch.obs import trace
from repro_torch.obs.registry import get_registry
from repro_torch.pipeline import (BucketPolicy, ScheduleCache,
                                  SchedulePipeline)
from repro_torch.serve import StructureRequest, StructureServeEngine
from repro_torch.serve.robustness import FAILED, OK, TERMINAL

INPUT_DIM, HIDDEN = 4, 8
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jfn = JTreeLSTM(input_dim=INPUT_DIM, hidden=HIDDEN, arity=2)
    jp = jfn.init(jax.random.PRNGKey(0))
    tfn = TTreeLSTM(input_dim=INPUT_DIM, hidden=HIDDEN, arity=2)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jfn, jp, tfn, tp


def _data(seed, n, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        leaves = int(rng.integers(lo, hi))
        g_seed = int(rng.integers(1 << 30))
        x = (rng.standard_normal((2 * leaves - 1, INPUT_DIM)) * 0.3
             ).astype(np.float32)
        out.append((leaves, g_seed, x))
    return out


def _reqs(data, cls, mod):
    return [cls(request_id=i, graph=mod.random_binary_tree(
        leaves, np.random.default_rng(s)), inputs=x)
        for i, (leaves, s, x) in enumerate(data)]


def _engine(fn, params, **kw):
    kw.setdefault("device", "cpu")
    return StructureServeEngine(fn, params, **kw)


def _roots(reqs):
    return {r.request_id: r.root_state for r in reqs if r.status == OK}


@pytest.mark.parametrize("compose", [True, False])
@pytest.mark.parametrize("fusion", ["auto", "none"])
def test_roots_match_jax_engine(models, fusion, compose):
    jfn, jp, tfn, tp = models
    data = _data(1, 11)
    jreqs = _reqs(data, JRequest, jst)
    je = JEngine(jfn, jp, batch_size=4, compose=compose)
    for r in jreqs:
        assert je.submit(r)
    je.run()
    treqs = _reqs(data, StructureRequest, tst)
    te = _engine(tfn, tp, batch_size=4, compose=compose, fusion_mode=fusion)
    for r in treqs:
        assert te.submit(r)
    te.run()
    assert te.batches == je.batches
    assert all(r.status == OK for r in treqs)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_allclose(b.root_state, a.root_state, rtol=0,
                                   atol=TOL)
    assert te.health()["degradations"] == 0


def test_repeated_topology_hits_cache(models):
    *_, tfn, tp = models
    eng = _engine(tfn, tp, batch_size=3, pipeline=SchedulePipeline(
        INPUT_DIM, bucket_policy=BucketPolicy(mode="pow2"),
        cache=ScheduleCache(enabled=True), device="cpu"))
    rng = np.random.default_rng(17)
    for i in range(9):
        g = tst.random_binary_tree(4, np.random.default_rng(0))
        x = rng.standard_normal((g.num_nodes, INPUT_DIM)).astype(np.float32)
        eng.submit(StructureRequest(i, g, x))
    assert len(eng.run()) == 9 and eng.batches == 3
    assert eng.pipeline.cache.hits == 2
    assert eng.pipeline.compile_count == 1
    assert eng.health()["schedule_cache"]["packs"] == 1
    snap = get_registry().snapshot()
    assert any(k.startswith("pipeline") for k in snap["providers"])


def test_rejects_malformed_request(models):
    *_, tfn, tp = models
    eng = _engine(tfn, tp)
    req = StructureRequest(0, tst.chain(3),
                           np.zeros((4, INPUT_DIM), np.float32))
    assert eng.submit(req) is False
    assert req.status == "rejected" and req.done
    assert "4 input rows for 3 nodes" in req.error
    bad = np.full((3, INPUT_DIM), np.nan, np.float32)
    nan_req = StructureRequest(1, tst.chain(3), bad)
    assert eng.submit(nan_req) is False and "non-finite" in nan_req.error
    assert eng.submit(req) is False                      # double submit
    assert eng.health()["rejected"] == 3 and not eng.queue


def test_queue_full_backpressure(models):
    *_, tfn, tp = models
    eng = _engine(tfn, tp, max_queue=2)
    reqs = _reqs(_data(2, 3), StructureRequest, tst)
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    assert eng.submit(reqs[2]) is False
    assert "queue full" in reqs[2].error
    eng.run()
    assert [r.status for r in reqs] == [OK, OK, "rejected"]


def test_ttl_deadline_times_out_queued_request(models):
    *_, tfn, tp = models
    now = [0.0]
    eng = _engine(tfn, tp, batch_size=1, clock=lambda: now[0])
    reqs = _reqs(_data(3, 2), StructureRequest, tst)
    reqs[1].ttl = 0.5
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    now[0] = 1.0
    eng.run()
    assert reqs[0].status == OK and reqs[1].status == "timeout"
    assert eng.health()["deadline_misses"] == 1
    assert all(r.status in TERMINAL for r in eng.finished)


def test_kernel_chaos_degrades_then_breaker_pins_oracle(models):
    """On CPU tensors, every fused attempt fails: the first
    ``breaker_threshold`` batches degrade to the oracle (counted, with
    the cause kept), then the breaker opens and the fused path is never
    re-tried.  (On the card there is no ladder: see
    ``test_torch_serve_card.py``.)"""
    *_, tfn, tp = models
    data = _data(5, 8)
    ref = _engine(tfn, tp, batch_size=2, compose=False)
    for r in _reqs(data, StructureRequest, tst):
        ref.submit(r)
    ref.run()
    want = _roots(ref.finished)
    eng = _engine(tfn, tp, batch_size=2, compose=False, breaker_threshold=2)
    assert eng.fused
    for r in _reqs(data, StructureRequest, tst):
        eng.submit(r)
    hook = ScriptedChaos(fail={"kernel": list(range(100))})
    with install_chaos(hook):
        eng.run()
    assert hook.calls["kernel"] == 2
    assert not eng.fused
    h = eng.health()
    assert h["degradations"] == 2 and "SimulatedFailure" in \
        eng.last_degradation
    assert h["breaker_open"] and h["breaker_trips"] == 1
    assert h["completed"] == 8 and h["failed"] == 0
    got = _roots(eng.finished)
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], rtol=0, atol=1e-6)


def test_persistent_poison_is_bisected_down_to_one_request(models):
    """Cold-pack failures on every batch holding request 0: only that
    request fails; its peers complete with the fault-free results."""
    *_, tfn, tp = models
    data = _data(11, 4)

    ref = _engine(tfn, tp, batch_size=4, compose=False)
    for r in _reqs(data, StructureRequest, tst):
        ref.submit(r)
    ref.run()
    want = _roots(ref.finished)
    eng = _engine(tfn, tp, batch_size=4, compose=False)
    reqs = _reqs(data, StructureRequest, tst)
    for r in reqs:
        eng.submit(r)
    hook = ScriptedChaos(fail={"pack": [0, 1, 2]})
    with install_chaos(hook):
        eng.run()
    assert hook.fired["pack"] == [0, 1, 2]
    assert reqs[0].status == FAILED
    assert "batch execution failed" in reqs[0].error
    for peer in reqs[1:]:
        assert peer.status == OK
        np.testing.assert_allclose(peer.root_state, want[peer.request_id],
                                   rtol=0, atol=1e-6)
    h = eng.health()
    assert h["failed"] == 1 and h["completed"] == 3 and h["quarantines"] == 1


def test_nan_injection_fails_only_poisoned_request(models):
    *_, tfn, tp = models
    data = _data(3, 4)
    ref = _engine(tfn, tp, batch_size=4, compose=False)
    for r in _reqs(data, StructureRequest, tst):
        ref.submit(r)
    ref.run()
    want = _roots(ref.finished)
    eng = _engine(tfn, tp, batch_size=4, compose=False)
    reqs = _reqs(data, StructureRequest, tst)
    for r in reqs:
        eng.submit(r)
    hook = ScriptedChaos(nan_ext={0: (1,)})
    with install_chaos(hook):
        eng.run()
    assert reqs[1].status == FAILED
    assert reqs[1].error == "non-finite root state"
    for k in (0, 2, 3):
        assert reqs[k].status == OK
        np.testing.assert_array_equal(reqs[k].root_state, want[k])
    assert eng.health()["quarantines"] == 0


def test_scripted_chaos_fires_only_scripted_calls():
    hook = ScriptedChaos(fail={"pack": [1]})
    with install_chaos(hook):
        chaos_fire("pack")
        with pytest.raises(SimulatedFailure):
            chaos_fire("pack")
        chaos_fire("pack")
        chaos_fire("kernel")
    assert hook.calls == {"pack": 3, "kernel": 1}
    assert hook.fired == {"pack": [1]}
    assert get_chaos() is None


def test_tracer_records_serving_spans(models):
    *_, tfn, tp = models
    eng = _engine(tfn, tp, batch_size=2)
    for r in _reqs(_data(4, 3), StructureRequest, tst):
        eng.submit(r)
    with trace.install_tracer(trace.Tracer()) as t:
        eng.run()
        h = eng.health()
    names = {s.name for s in t.snapshot()}
    assert {"serve.flush", "serve.batch", "serve.score", "pipeline.pack",
            "sched.pack_batch", "h2d.ext"} <= names
    assert h["recent_spans"]
    batch_ids = {s.cid["batch"] for s in t.snapshot()
                 if s.name == "pipeline.pack"}
    assert len(batch_ids) == 2


def test_cache_pairs_host_and_device_lookups(monkeypatch):
    """``get_or_pack`` then ``get_or_pack_device`` on the same key is one
    logical lookup (one pack, no hit), also with the cache disabled; a
    later lookup hits and reuses the device twin; a with-runs lookup
    upgrades the entry without repacking."""
    g = [tst.random_binary_tree(5, np.random.default_rng(i)) for i in range(3)]
    pads = (8, 16, 2, 16)
    c = ScheduleCache(capacity=4, enabled=True)
    s = c.get_or_pack(g, pads, with_runs=False)
    s2, d = c.get_or_pack_device(g, pads, with_runs=False, device="cpu")
    assert s2 is s and (c.hits, c.misses, c.packs) == (0, 1, 1)
    _, d2 = c.get_or_pack_device(g, pads, with_runs=False, device="cpu")
    assert d2 is d and c.hits == 1
    assert c.get_or_pack(g, pads).sort_perm is not None and c.packs == 1
    monkeypatch.setenv("REPRO_SCHED_CACHE", "0")
    off = ScheduleCache()
    assert not off.enabled
    off.get_or_pack(g)
    off.get_or_pack_device(g, device="cpu")
    assert off.packs == 1
