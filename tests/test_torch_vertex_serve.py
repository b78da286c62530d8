"""The port's ``VertexServeEngine`` (the decode path of the LSTM/GRU
cells) against the JAX package's engine on the same requests and params,
on both fusion legs, and against the port's ``execute`` over the same
chains; then the behaviour ``tests/test_vertex_serve.py`` pins down for
the reference: staggered admission, tree cells refused, the
``REPRO_FUSION`` switch, and freed-slot rows zeroed after a timeout and
after a failed tick; plus the CPU degradation ladder.

Tolerance: final states within 1e-4 of the JAX engine and of ``execute``
(the reference's fused-vs-unfused bar); the two legs of the port within
1e-5.  Every cell draws a NONZERO bias."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import rnn as jrnn
from repro.serve import VertexRequest as JRequest
from repro.serve import VertexServeEngine as JEngine
from repro_torch.core.scheduler import execute, readout_nodes
from repro_torch.core.structure import chain, pack_batch, pack_external
from repro_torch.dist.fault import ScriptedChaos, install_chaos
from repro_torch.interop import params_from_jax
from repro_torch.models.rnn import GRUVertex, LSTMVertex
from repro_torch.models.treelstm import TreeLSTMVertex
from repro_torch.serve import VertexRequest, VertexServeEngine

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CELLS = {"lstm": (jrnn.LSTMVertex, LSTMVertex),
         "gru": (jrnn.GRUVertex, GRUVertex)}


def _pair(cell, x_dim, hidden, seed):
    jcls, tcls = CELLS[cell]
    jfn, tfn = jcls(input_dim=x_dim, hidden=hidden), \
        tcls(input_dim=x_dim, hidden=hidden)
    p = {k: np.asarray(v) for k, v in jfn.init(jax.random.PRNGKey(seed))
         .items()}
    p["b"] = (np.random.default_rng(seed).standard_normal(p["b"].shape)
              * 0.3).astype(np.float32)
    return jfn, {k: jnp.asarray(v) for k, v in p.items()}, tfn, \
        params_from_jax(p, "cpu")


def _inputs(rng, lens, x_dim):
    return [(rng.standard_normal((L, x_dim)) * 0.3).astype(np.float32)
            for L in lens]


def _engine(fn, params, **kw):
    kw.setdefault("device", "cpu")
    return VertexServeEngine(fn, params, **kw)


def _scheduler_finals(fn, params, inputs):
    sched = pack_batch([chain(x.shape[0]) for x in inputs])
    ext = torch.from_numpy(pack_external(inputs, sched, fn.input_dim))
    dev = sched.to_device("cpu")
    with torch.no_grad():
        buf = execute(fn, params, dev, ext, fusion_mode="none").buf
    nodes = readout_nodes(buf, dev).numpy()
    return [nodes[k, x.shape[0] - 1] for k, x in enumerate(inputs)]


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_decode_both_legs_match_jax_and_execute(cell):
    jfn, jp, tfn, tp = _pair(cell, 6, 5, 0)
    rng = np.random.default_rng(0)
    lens = [3, 7, 1, 5, 4, 6]                 # 6 requests through 2 slots
    inputs = _inputs(rng, lens, 6)
    jeng = JEngine(jfn, jp, num_slots=2, fusion_mode="megastep")
    for i, x in enumerate(inputs):
        jeng.submit(JRequest(request_id=i, inputs=x))
    jfinal = {r.request_id: r.final_state for r in jeng.run()}
    finals = {}
    for mode in ("megastep", "none"):
        eng = _engine(tfn, tp, num_slots=2, fusion_mode=mode)
        assert eng.fused == (mode == "megastep")
        for i, x in enumerate(inputs):
            eng.submit(VertexRequest(request_id=i, inputs=x))
        done = eng.run()
        assert len(done) == len(lens) and eng.num_active == 0
        assert all(r.status == "ok" for r in done)
        assert eng.ticks == jeng.ticks
        finals[mode] = {r.request_id: r.final_state for r in done}
    oracle = _scheduler_finals(tfn, tp, inputs)
    for i in range(len(lens)):
        np.testing.assert_allclose(finals["megastep"][i], finals["none"][i],
                                   rtol=0, atol=1e-5)
        for mode in finals:
            np.testing.assert_allclose(finals[mode][i], jfinal[i], rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(finals[mode][i], oracle[i], rtol=0,
                                       atol=TOL)


def test_decode_staggered_admission_slot_isolation():
    """A request's final state must not depend on its co-tenants or on
    WHEN it was admitted."""
    _jfn, _jp, fn, params = _pair("lstm", 4, 3, 1)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((6, 4)).astype(np.float32)

    def run(co_lens, co_at_tick):
        eng = _engine(fn, params, num_slots=3)
        eng.submit(VertexRequest(request_id=0, inputs=x0))
        for _ in range(co_at_tick):
            eng.step()
        for i, L in enumerate(co_lens):
            eng.submit(VertexRequest(
                request_id=1 + i,
                inputs=rng.standard_normal((L, 4)).astype(np.float32)))
        done = eng.run()
        return {r.request_id: r.final_state for r in done}

    a = run(co_lens=[2, 9], co_at_tick=0)
    b = run(co_lens=[5], co_at_tick=3)
    np.testing.assert_array_equal(a[0], b[0])


def test_decode_respects_fusion_env(monkeypatch):
    _jfn, _jp, fn, params = _pair("gru", 4, 3, 2)
    monkeypatch.delenv("REPRO_FUSION", raising=False)
    assert _engine(fn, params, num_slots=2).fused
    monkeypatch.setenv("REPRO_FUSION", "none")
    assert not _engine(fn, params, num_slots=2).fused


def test_decode_rejects_tree_cells_and_defaults_to_the_card():
    fn = TreeLSTMVertex(input_dim=4, hidden=3, arity=2)
    with pytest.raises(ValueError, match="arity"):
        _engine(fn, fn.init(torch.Generator().manual_seed(0), device="cpu"),
                num_slots=2)
    sig = inspect.signature(VertexServeEngine)
    assert sig.parameters["device"].default == "cuda"


def test_decode_rejects_malformed_sequences():
    _jfn, _jp, fn, params = _pair("lstm", 4, 3, 0)
    eng = _engine(fn, params, num_slots=1)
    for bad in (np.zeros((0, 4), np.float32), np.zeros((3, 5), np.float32),
                np.full((2, 4), np.inf, np.float32), np.zeros(4, np.float32)):
        r = VertexRequest(request_id=0, inputs=bad)
        assert not eng.submit(r) and r.status == "rejected"
    assert len(eng.finished) == 4


def test_timeout_freed_slot_rows_are_zeroed_before_reuse():
    """Rows freed by the deadline sweep are re-zeroed, and the next
    admission into the slot is bitwise what a fresh engine computes."""
    _jfn, _jp, fn, params = _pair("lstm", 4, 3, 3)
    rng = np.random.default_rng(3)
    long_x = rng.standard_normal((50, 4)).astype(np.float32)
    short_x = rng.standard_normal((5, 4)).astype(np.float32)
    t = [0.0]
    eng = _engine(fn, params, num_slots=1, clock=lambda: t[0])
    victim = VertexRequest(request_id=0, inputs=long_x, ttl=0.5)
    assert eng.submit(victim)
    for _ in range(3):
        eng.step()
    assert eng._buf.abs().max() > 0.0
    t[0] = 1.0
    eng.step()
    assert victim.status == "timeout"
    assert not eng._buf.any()
    reused = VertexRequest(request_id=1, inputs=short_x)
    assert eng.submit(reused)
    eng.run()
    assert reused.status == "ok"
    fresh_eng = _engine(fn, params, num_slots=1)
    fresh = VertexRequest(request_id=2, inputs=short_x)
    assert fresh_eng.submit(fresh)
    fresh_eng.run()
    np.testing.assert_array_equal(reused.final_state, fresh.final_state)


def test_tick_failure_zeroes_freed_slot_rows():
    """A failure of both rungs routes every in-flight request to
    ``failed``; the vacated rows are zero, and queued requests admit."""
    _jfn, _jp, fn, params = _pair("lstm", 4, 3, 4)
    rng = np.random.default_rng(4)
    eng = _engine(fn, params, num_slots=2, fusion_mode="none")
    eng.submit(VertexRequest(
        request_id=0, inputs=rng.standard_normal((6, 4)).astype(np.float32)))
    eng.step()
    assert eng._buf.any()
    orig = eng._tick_oracle
    eng._tick_oracle = lambda *a: (_ for _ in ()).throw(RuntimeError("boom"))
    try:
        eng.step()
    finally:
        eng._tick_oracle = orig
    assert eng.finished[-1].status == "failed"
    assert "boom" in eng.finished[-1].error
    assert not eng._buf.any() and eng.num_active == 0
    late = VertexRequest(request_id=1,
                         inputs=rng.standard_normal((2, 4)).astype(np.float32))
    eng.submit(late)
    eng.run()
    assert late.status == "ok"


def test_fused_failure_degrades_then_breaker_pins_op_by_op():
    """On CPU tensors a failed fused tick runs the op-by-op tick instead
    (same states, counted); three in a row trip the breaker."""
    _jfn, _jp, fn, params = _pair("gru", 4, 3, 5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    clean = _engine(fn, params, num_slots=1)
    ref_req = VertexRequest(request_id=0, inputs=x)
    clean.submit(ref_req)
    clean.run()
    eng = _engine(fn, params, num_slots=1)
    req = VertexRequest(request_id=0, inputs=x)
    with install_chaos(ScriptedChaos(fail={"kernel": [0, 1, 2]})) as chaos:
        eng.submit(req)
        eng.run()
    assert chaos.fired == {"kernel": [0, 1, 2]}
    h = eng.health()
    assert req.status == "ok" and h["degradations"] == 3
    assert h["breaker_open"] and not eng.fused
    assert "SimulatedFailure" in eng.last_degradation
    np.testing.assert_allclose(req.final_state, ref_req.final_state,
                               rtol=0, atol=1e-5)
