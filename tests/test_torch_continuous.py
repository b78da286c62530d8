"""The port's ``ContinuousBatchEngine`` against the JAX package's on the
same requests, params and admission schedule, and against the port's own
solo scoring (``StructureServeEngine``, ``batch_size=1``); then the
behaviour ``tests/test_continuous.py`` pins down for the reference:
exactly one terminal status under churn, the CPU degradation ladder
(including a double failure), plan and schedule reuse on admission, a
disabled cache replanning every request, and tokens that do not depend
on how requests interleave.

Tolerance: roots and head logits within 1e-4 (the reference's
fused-vs-unfused bar).  The reference's own suites claim bitwise
served-equals-solo, which its CPU runs do not meet (ROADMAP queue 3), so
no bitwise claim is made here.  Every cell draws a NONZERO bias."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import structure as jst
from repro.models import readout as jreadout
from repro.models import rnn as jrnn
from repro.models import treelstm as jtree
from repro.serve import AdmissionPolicy as JPolicy
from repro.serve import ContinuousBatchEngine as JEngine
from repro.serve import ContinuousRequest as JRequest
from repro_torch.core.structure import chain, random_dag
from repro_torch.dist.fault import ScriptedChaos, install_chaos
from repro_torch.interop import params_from_jax
from repro_torch.models.readout import ClassificationHead, TokenReadout
from repro_torch.models.rnn import LSTMVertex
from repro_torch.models.treelstm import TreeLSTMVertex
from repro_torch.pipeline import ScheduleCache
from repro_torch.serve import (AdmissionPolicy, ContinuousBatchEngine,
                               ContinuousRequest, StructureRequest,
                               StructureServeEngine, TERMINAL)

from tests.hypothesis_compat import given, settings, st

TOL = 1e-4
X, H = 4, 3
POLICY = dict(min_occupancy=0.25, ttl_slack_s=0.05, max_defer_ticks=2,
              max_window=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(cell, seed=0):
    """(JAX cell, its params, port cell, its params): the JAX init with a
    nonzero bias, carried across."""
    if cell == "lstm":
        jfn, tfn = jrnn.LSTMVertex(X, H), LSTMVertex(X, H)
    else:
        jfn, tfn = jtree.TreeLSTMVertex(X, H, 2), TreeLSTMVertex(X, H, 2)
    p = {k: np.asarray(v) for k, v in jfn.init(jax.random.PRNGKey(seed))
         .items()}
    p["b"] = (np.random.default_rng(seed).standard_normal(p["b"].shape)
              * 0.3).astype(np.float32)
    return jfn, {k: jnp.asarray(v) for k, v in p.items()}, tfn, \
        params_from_jax(p, "cpu")


PAIRS = {c: _pair(c, i) for i, c in enumerate(("lstm", "tree"))}


def _mk_inputs(rng, g):
    return (rng.standard_normal((g.num_nodes, X)) * 0.4).astype(np.float32)


def _mk_graph(arity, rng, n):
    return chain(n) if arity == 1 else random_dag(n, rng, max_arity=arity)


def _cohort(arity, sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        g = _mk_graph(arity, rng, n)
        out.append((g, _mk_inputs(rng, g)))
    return out


def _drive(eng, reqs, schedule, t):
    """An interleaving of submissions, steps and clock advances on a
    virtual clock ``t``; whatever the schedule did not submit goes in at
    the end, then the engine drains."""
    it = iter(reqs)
    for op in schedule:
        if op == "submit":
            nxt = next(it, None)
            if nxt is not None:
                eng.submit(nxt)
        elif op == "step":
            eng.step()
        elif op == "clock":
            t[0] += 0.2
    for nxt in it:
        eng.submit(nxt)
    eng.run()


def _port_engine(fn, params, mode, t, width=3, **kw):
    return ContinuousBatchEngine(
        fn, params, num_rows=32, frontier_width=width, fusion_mode=mode,
        clock=lambda: t[0], policy=AdmissionPolicy(**POLICY), device="cpu",
        **kw)


def _run_both(cell, mode, sizes, schedule, ttls=None, head=False,
              width=3):
    """The same cohort and interleaving through the JAX engine and the
    port's; returns both request lists (and both engines)."""
    jfn, jp, tfn, tp = PAIRS[cell]
    cohort = _cohort(tfn.arity, sizes, hash(tuple(sizes)) % (2 ** 32))
    ttl = (lambda i: None) if ttls is None else (lambda i: ttls[i])
    jkw, tkw = {}, {}
    if head:
        jh = jreadout.ClassificationHead(tfn.state_dim, 3)
        hp = {k: np.asarray(v) for k, v in
              jh.init(jax.random.PRNGKey(7)).items()}
        hp["b"] = np.linspace(-0.2, 0.2, 3).astype(np.float32)
        jkw = dict(head=jh, head_params={k: jnp.asarray(v)
                                         for k, v in hp.items()})
        tkw = dict(head=ClassificationHead(tfn.state_dim, 3),
                   head_params=params_from_jax(hp, "cpu"))
    jt, tt = [0.0], [0.0]
    jeng = JEngine(jfn, jp, num_rows=32, frontier_width=width,
                   fusion_mode="megastep" if mode == "auto" else mode,
                   clock=lambda: jt[0], policy=JPolicy(**POLICY), **jkw)
    jreqs = [JRequest(i, jst.InputGraph(children=[list(c)
                                                  for c in g.children]),
                      x, ttl=ttl(i)) for i, (g, x) in enumerate(cohort)]
    _drive(jeng, jreqs, schedule, jt)
    teng = _port_engine(tfn, tp, mode, tt, width, **tkw)
    treqs = [ContinuousRequest(i, g, x, ttl=ttl(i))
             for i, (g, x) in enumerate(cohort)]
    _drive(teng, treqs, schedule, tt)
    return jeng, jreqs, teng, treqs


def _solo_root(fn, params, g, x, mode):
    eng = StructureServeEngine(fn, params, batch_size=1, compose=False,
                               fusion_mode=mode, device="cpu")
    req = StructureRequest(0, g, x)
    assert eng.submit(req), req.error
    eng.run()
    assert req.status == "ok", (req.status, req.error)
    return req.root_state


def _check(cell, mode, jeng, jreqs, teng, treqs):
    _jfn, _jp, tfn, tp = PAIRS[cell]
    assert len(teng.finished) == len(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.status in TERMINAL
        assert teng.finished.count(tr) == 1          # exactly one terminal
        # The same scheduling logic: the same outcome for every request.
        assert tr.status == jr.status, (tr.request_id, tr.status,
                                        jr.status)
        if tr.status != "ok":
            continue
        np.testing.assert_allclose(tr.root_state, jr.root_state, rtol=0,
                                   atol=TOL)
        solo = _solo_root(tfn, tp, tr.graph, tr.inputs, mode)
        np.testing.assert_allclose(tr.root_state, solo, rtol=0, atol=TOL)
        if jr.logits is not None:
            np.testing.assert_allclose(tr.logits, jr.logits, rtol=0,
                                       atol=TOL)
            assert tr.label == int(np.argmax(tr.logits))
    assert teng.num_active == 0 and not teng.queue
    assert teng.free_rows == teng.num_rows
    assert teng.ticks == jeng.ticks and teng.windows == jeng.windows
    assert teng.deferred == jeng.deferred
    # Freed arena rows are re-zeroed (dead state never lingers).
    assert not teng._buf.any()


# ---------------------------------------------------------------------------
# Any interleaving: the JAX engine's outcome and roots, and solo scoring's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "none"])
@pytest.mark.parametrize("cell", ["lstm", "tree"])
@settings(max_examples=4, deadline=None)
@given(st.data())
def test_property_any_interleaving_matches_jax_and_solo(cell, mode, data):
    sizes = data.draw(st.lists(st.integers(min_value=1, max_value=9),
                               min_size=1, max_size=5))
    schedule = data.draw(st.lists(
        st.sampled_from(["submit", "step", "clock"]), min_size=0,
        max_size=10))
    ttls = None
    if data.draw(st.booleans()):
        ttls = [data.draw(st.sampled_from([None, 0.1, 1000.0]))
                for _ in sizes]
    _check(cell, mode, *_run_both(cell, mode, sizes, schedule, ttls))


_FIXED_CASES = [
    # (sizes, schedule, ttls)
    ([3, 7, 5, 12, 1, 9], [], None),                       # all up front
    ([6, 2, 8], ["submit", "step", "step", "submit", "step", "submit"],
     None),                                                # staggered
    ([9, 2, 7, 3], ["submit", "step", "clock", "clock", "submit", "step",
                    "submit", "clock", "step"],
     [1000.0, 0.1, None, 1000.0]),                         # mixed TTLs
]


@pytest.mark.parametrize("mode", ["auto", "none"])
@pytest.mark.parametrize("case", range(len(_FIXED_CASES)))
def test_fixed_interleavings_with_head_match_jax(case, mode):
    sizes, schedule, ttls = _FIXED_CASES[case]
    _check("lstm", mode, *_run_both("lstm", mode, sizes, schedule, ttls,
                                    head=True))


#: Retirement windows (sizes, frontier width, the host buffer's rows at
#: the end): one request; many over several windows; 20 roots in the first
#: window, more than the engine's host buffer starts with (``HOST_ROWS``,
#: 16), so it grows to 32.
_RETIRE_CASES = [([6], 3, 16), ([3, 7, 5, 12, 1, 9, 2, 4, 6, 8], 3, 16),
                 ([1] * 20 + [4, 2], 24, 32)]


@pytest.mark.parametrize("case", range(len(_RETIRE_CASES)))
def test_retirement_windows_with_head_match_jax(case):
    """Roots, logits and labels through the port's one-sync readback
    against the JAX engine's and solo scoring, for one, many and more
    retired roots than the host buffer first holds."""
    sizes, width, rows = _RETIRE_CASES[case]
    jeng, jreqs, teng, treqs = _run_both("lstm", "auto", sizes, [],
                                         head=True, width=width)
    _check("lstm", "auto", jeng, jreqs, teng, treqs)
    assert all(r.status == "ok" for r in treqs)
    assert ContinuousBatchEngine.HOST_ROWS == 16
    assert teng._host.shape[0] == rows


def test_tree_cohort_with_head_matches_jax():
    _check("tree", "auto", *_run_both("tree", "auto", [4, 9, 1, 6, 11],
                                      ["submit", "step", "submit"],
                                      head=True))


# ---------------------------------------------------------------------------
# Lifecycle, ladder, caches, tokens
# ---------------------------------------------------------------------------

def _lstm():
    return PAIRS["lstm"][2], PAIRS["lstm"][3]


def test_defaults_to_the_card():
    sig = inspect.signature(ContinuousBatchEngine)
    assert sig.parameters["device"].default == "cuda"
    assert sig.parameters["seed"].default == 0


def test_exactly_one_terminal_under_churn():
    """Rejections (bad structure, arena overflow, arity overflow, double
    submit, full queue), timeouts and completions each route every
    request to exactly one terminal."""
    t = [0.0]
    fn, params = _lstm()
    eng = ContinuousBatchEngine(fn, params, num_rows=8, frontier_width=2,
                                max_queue=2, clock=lambda: t[0],
                                policy=AdmissionPolicy(min_occupancy=0.0,
                                                       max_window=1),
                                device="cpu")
    rng = np.random.default_rng(0)
    reqs = []
    ok = ContinuousRequest(0, chain(3), _mk_inputs(rng, chain(3)))
    assert eng.submit(ok)
    reqs.append(ok)
    bad = ContinuousRequest(1, chain(2), np.full((2, X), np.nan, np.float32))
    assert not eng.submit(bad) and bad.status == "rejected"
    reqs.append(bad)
    too_big = ContinuousRequest(2, chain(20), _mk_inputs(rng, chain(20)))
    assert not eng.submit(too_big) and "arena rows" in too_big.error
    reqs.append(too_big)
    tree = random_dag(4, np.random.default_rng(5), max_arity=2)
    assert tree.max_arity > 1
    wide = ContinuousRequest(3, tree, _mk_inputs(rng, tree))
    assert not eng.submit(wide) and "arity" in wide.error
    reqs.append(wide)
    slow = ContinuousRequest(4, chain(8), _mk_inputs(rng, chain(8)),
                             ttl=0.5)
    assert eng.submit(slow)
    reqs.append(slow)
    fillers = [ContinuousRequest(10 + i, chain(2),
                                 _mk_inputs(rng, chain(2)))
               for i in range(4)]
    accepted = [eng.submit(f) for f in fillers]
    assert not all(accepted)                  # at least one backpressured
    reqs.extend(fillers)
    assert not eng.submit(ok)                 # double submit
    eng.step()
    t[0] = 1.0                                # expire `slow` mid-flight
    eng.run()
    for r in reqs:
        assert r.status in TERMINAL, (r.request_id, r.status)
        assert eng.finished.count(r) == 1
    assert slow.status == "timeout" and ok.status == "ok"
    assert sorted(id(r) for r in eng.finished) == sorted(id(r) for r in reqs)
    assert eng.free_rows == eng.num_rows and not eng._buf.any()


def test_degradation_ladder_and_double_failure():
    """A failing fused window degrades to the op-by-op window (same
    roots), and after three in a row the breaker pins the op-by-op
    window; a failure of both fails the in-flight set and frees (zeroes)
    its rows."""
    fn, params = _lstm()
    rng = np.random.default_rng(1)
    eng = ContinuousBatchEngine(fn, params, num_rows=8, frontier_width=2,
                                fusion_mode="megastep", device="cpu",
                                policy=AdmissionPolicy(min_occupancy=0.0,
                                                       max_window=1))
    r = ContinuousRequest(0, chain(5), _mk_inputs(rng, chain(5)))
    eng.submit(r)
    eng._window = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("kaboom"))
    eng.run()
    assert r.status == "ok"
    h = eng.health()
    assert h["degradations"] == 3 and "kaboom" in eng.last_degradation
    assert h["breaker_open"] and not eng.fused      # 5 windows, threshold 3
    np.testing.assert_allclose(
        r.root_state, _solo_root(fn, params, r.graph, r.inputs, "none"),
        rtol=0, atol=TOL)

    eng2 = ContinuousBatchEngine(fn, params, num_rows=8, frontier_width=2,
                                 fusion_mode="none", device="cpu",
                                 policy=AdmissionPolicy(min_occupancy=0.0,
                                                        max_window=1))
    r2 = ContinuousRequest(1, chain(5), _mk_inputs(rng, chain(5)))
    eng2.submit(r2)
    eng2.step()
    assert eng2._buf.any()
    eng2._window_oracle = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("kaboom"))
    eng2.run()
    assert r2.status == "failed" and "kaboom" in r2.error
    assert eng2.free_rows == eng2.num_rows and not eng2._buf.any()


def test_kernel_chaos_degrades_once_on_cpu():
    fn, params = _lstm()
    rng = np.random.default_rng(2)
    eng = ContinuousBatchEngine(fn, params, num_rows=16, frontier_width=4,
                                device="cpu",
                                policy=AdmissionPolicy(min_occupancy=0.0))
    reqs = [ContinuousRequest(i, chain(n), _mk_inputs(rng, chain(n)))
            for i, n in enumerate([3, 4])]
    with install_chaos(ScriptedChaos(fail={"kernel": [0]})) as chaos:
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert chaos.fired == {"kernel": [0]}
    assert all(r.status == "ok" for r in reqs)
    assert eng.health()["degradations"] == 1 and eng.fused


def test_nan_injection_fails_only_the_poisoned_request():
    fn, params = _lstm()
    rng = np.random.default_rng(3)
    eng = ContinuousBatchEngine(fn, params, num_rows=16, frontier_width=4,
                                device="cpu")
    reqs = [ContinuousRequest(i, chain(3), _mk_inputs(rng, chain(3)))
            for i in range(3)]
    with install_chaos(ScriptedChaos(nan_ext={1: [0]})):
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert [r.status for r in reqs] == ["ok", "failed", "ok"]
    assert "non-finite" in reqs[1].error


def test_plan_and_schedule_reuse_on_admission():
    """A recurring topology admits through the cache's per-graph tier:
    one solo pack and one plan, ever."""
    fn, params = _lstm()
    rng = np.random.default_rng(3)
    eng = ContinuousBatchEngine(fn, params, num_rows=64, frontier_width=4,
                                cache=ScheduleCache(enabled=True),
                                device="cpu")
    for i in range(8):
        g = chain(5)
        assert eng.submit(ContinuousRequest(i, g, _mk_inputs(rng, g)))
        eng.run()
    h = eng.health()
    assert h["plan_hits"] >= 7 and h["plan_misses"] == 1
    stats = h["schedule_cache"]
    assert stats["graph_hits"] >= 7 and stats["graph_packs"] == 1


def test_disabled_cache_admission_replans_every_request():
    fn, params = _lstm()
    rng = np.random.default_rng(4)
    eng = ContinuousBatchEngine(fn, params, num_rows=64, frontier_width=4,
                                cache=ScheduleCache(enabled=False),
                                device="cpu")
    for i in range(3):
        g = chain(4)
        assert eng.submit(ContinuousRequest(i, g, _mk_inputs(rng, g)))
        eng.run()
    h = eng.health()
    assert h["plan_misses"] == 3 and h["plan_hits"] == 0
    assert eng.cache.stats()["graph_packs"] == 3


def test_cache_disabled_by_env(monkeypatch):
    monkeypatch.setenv("REPRO_SCHED_CACHE", "0")
    fn, params = _lstm()
    eng = ContinuousBatchEngine(fn, params, device="cpu")
    assert not eng.cache.enabled


def test_token_generation_deterministic_across_interleavings():
    """Step t of request r samples under (seed, r, t): the SAME tokens
    whether the request ran alone or behind an arbitrary admission
    order."""
    fn, params = _lstm()
    tr = TokenReadout(fn, vocab=13)
    tp = tr.init(torch.Generator().manual_seed(3), device="cpu")

    def run(extra_sizes, seed=9):
        eng = ContinuousBatchEngine(fn, params, num_rows=32,
                                    frontier_width=3, token_readout=tr,
                                    token_params=tp, max_new_tokens=6,
                                    seed=seed, device="cpu")
        gen = np.random.default_rng(5)
        g = chain(5)
        target = ContinuousRequest(77, g, _mk_inputs(gen, g))
        eng.submit(target)
        for i, n in enumerate(extra_sizes):
            eng.submit(ContinuousRequest(i, chain(n),
                                         _mk_inputs(gen, chain(n))))
        eng.run()
        assert target.status == "ok"
        return target.tokens

    alone = run([])
    crowded = run([3, 8, 2, 6])
    assert alone == crowded and len(alone) == 6
    assert run([], seed=10) != alone
