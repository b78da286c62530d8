"""The row scatter-add's plan (``core.structure.ScatterPlan``, which the
card's K7 kernel reads) and the kernel's summation order, on the CPU.

The plan's properties are swept with hypothesis over R, n, D and the
share of indices aimed at one sentinel row (0-95 %): every position once,
ascending within a run, chunks of at most ``C``, a split run's chunks
contiguous, split chunks first.  ``ref.scatter_add_rows_planned`` (the
kernel's order in plain PyTorch: chunk sums, then a split run's partials
in groups in chunk order) is held against ``ref.scatter_add_rows``
(``index_add_``) and against the JAX Pallas ``scatter_add_rows`` in
interpret mode on the same numpy inputs.  Tolerance: 1e-6 of max |want|
in the fixed cases, the same fp32 sums in another order at these sizes
(at most a few hundred unit-normal terms a row); in the hypothesis sweep,
1e-6 of the largest ``|dst| + sum |rows|`` a row, since a drawn row whose
terms cancel makes max |want| small while the order's rounding scales
with the terms.  The plans ``to_device`` builds, and the
scheduler's three scatter call sites passing them, are checked too.  The
kernel itself is held against both on the card by
``tests/test_torch_train_card.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import level_megastep_bwd as jlmb
from repro_torch.core import scheduler as tsch
from repro_torch.core import structure as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.treelstm import TreeLSTMVertex
from tests.hypothesis_compat import given, settings, st

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(seed, R, D, n, share):
    """Unit-normal dst and rows; indices uniform over [0, R) with
    ``share`` of them moved to the sentinel row R - 1, whose rows are
    mostly zeros (masked rows)."""
    rng = np.random.default_rng(seed)
    dst = rng.standard_normal((R, D)).astype(np.float32)
    idx = rng.integers(0, R, size=n).astype(np.int32)
    heavy = rng.random(n) < share
    idx[heavy] = R - 1
    rows = rng.standard_normal((n, D)).astype(np.float32)
    rows[heavy & (rng.random(n) < 0.8)] = 0.0
    return dst, idx, rows


def _check_plan(idx, plan):
    """Every property the kernel relies on, from the plan's arrays."""
    n = idx.size
    order = plan.order.numpy()
    ch = plan.chunks.numpy()
    starts = plan.run_start.numpy()
    S, C = plan.split_chunks, plan.chunk_rows
    assert plan.n == n and order.dtype == np.int32 and ch.dtype == np.int32
    assert np.array_equal(np.sort(order), np.arange(n))   # each i once
    assert plan.rows == (int(idx.max()) + 1 if n else 0)
    if n == 0:
        assert ch.shape == (0, 4) and S == 0 and list(starts) == [0]
        return
    row, begin, end, first = ch.T
    longest = int(np.unique(idx, return_counts=True)[1].max())
    assert C == max(tst.PLAN_MIN_CHUNK, -(-longest // tst.PLAN_MAX_SPLIT))
    assert (end > begin).all() and (end - begin <= C).all()
    # the chunks cut [0, n) of the grouped positions exactly once
    cover = np.zeros(n, np.int32)
    for b, e in zip(begin, end):
        cover[b:e] += 1
    assert (cover == 1).all()
    assert np.array_equal(first, order[begin])
    sidx = idx[order]
    for r, b, e in zip(row, begin, end):
        assert (sidx[b:e] == r).all()
    # within a row's run, positions ascend (the stable argsort)
    same = sidx[1:] == sidx[:-1]
    assert (order[1:][same] > order[:-1][same]).all()
    # split runs first, each contiguous: its chunks adjacent in the list
    # and in order, of C positions but the last, covering the row's run
    assert starts[0] == 0 and starts[-1] == S
    assert (np.diff(starts) >= 2).all()
    for c0, c1 in zip(starts[:-1], starts[1:]):
        assert (row[c0:c1] == row[c0]).all()
        assert np.array_equal(begin[c0 + 1:c1], end[c0:c1 - 1])
        assert (end[c0:c1 - 1] - begin[c0:c1 - 1] == C).all()
        assert (idx == row[c0]).sum() == end[c1 - 1] - begin[c0]
    # the rest are whole runs, one a row, by row
    assert (np.diff(row[S:]) > 0).all()
    assert not np.isin(row[S:], row[:S]).any()
    assert len(set(row[S:])) + len(starts) - 1 == np.unique(idx).size


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@settings(max_examples=40, deadline=None)
@given(R=st.integers(1, 300), n=st.integers(0, 700), D=st.integers(1, 9),
       share=st.sampled_from([0.0, 0.3, 0.6, 0.8, 0.95]),
       seed=st.integers(0, 2 ** 16))
def test_plan_properties_and_planned_sum(R, n, D, share, seed):
    dst, idx, rows = _case(seed, R, D, n, share)
    plan = tst.ScatterPlan.build(idx, "cpu")
    _check_plan(idx, plan)
    want = tref.scatter_add_rows(torch.from_numpy(dst.copy()),
                                 torch.from_numpy(idx), torch.from_numpy(rows))
    got = tref.scatter_add_rows_planned(torch.from_numpy(dst.copy()),
                                        torch.from_numpy(rows), plan)
    size = tref.scatter_add_rows(torch.from_numpy(np.abs(dst)),
                                 torch.from_numpy(idx),
                                 torch.from_numpy(np.abs(rows)))
    assert float((got - want).abs().max()) <= TOL * float(size.max())
    untouched = np.setdiff1d(np.arange(R), idx)
    assert got.numpy()[untouched].tobytes() == dst[untouched].tobytes()


@pytest.mark.parametrize("n,R", [(0, 5), (1, 1), (100, 1), (20000, 3)])
def test_plan_edges(n, R):
    """No index, one, every index on one row (100 is split; 20,000 makes
    C grow past PLAN_MIN_CHUNK to keep at most PLAN_MAX_SPLIT chunks)."""
    idx = np.full(n, R - 1, np.int32)
    plan = tst.ScatterPlan.build(idx, "cpu")
    _check_plan(idx, plan)
    k = plan.run_start.numel() - 1
    assert k == (1 if n > tst.PLAN_MIN_CHUNK else 0)
    assert plan.split_chunks <= tst.PLAN_MAX_SPLIT
    if n == 20000:
        assert plan.chunk_rows == -(-n // tst.PLAN_MAX_SPLIT)
    with pytest.raises(ValueError, match="< 0"):
        tst.ScatterPlan.build(np.array([0, -1], np.int32), "cpu")


@pytest.mark.parametrize("r,d,n,share,seed", [
    (10, 5, 7, 0.0, 0), (40, 24, 90, 0.3, 1), (9, 3, 160, 0.8, 2),
    (17, 130, 230, 0.95, 3)])
def test_planned_sum_matches_jax_pallas_interpret(r, d, n, share, seed):
    dst, idx, rows = _case(seed, r, d, n, share)
    plan = tst.ScatterPlan.build(idx, "cpu")
    want = np.asarray(jlmb.scatter_add_rows(
        jnp.asarray(dst), jnp.asarray(idx), jnp.asarray(rows), block_r=8,
        interpret=True))
    got = tref.scatter_add_rows_planned(torch.from_numpy(dst.copy()),
                                        torch.from_numpy(rows), plan).numpy()
    assert _rel(got, want) <= TOL
    plain = tref.scatter_add_rows(torch.from_numpy(dst.copy()),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(rows)).numpy()
    assert _rel(plain, want) <= TOL
    untouched = np.setdiff1d(np.arange(r), idx)
    assert got[untouched].tobytes() == dst[untouched].tobytes()
    if share >= 0.8:
        assert plan.split_chunks > 0              # the combine is exercised


def _same_plan(a, b):
    for f in ("order", "chunks", "run_start"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.split_chunks, a.chunk_rows, a.rows) == \
        (b.split_chunks, b.chunk_rows, b.rows)


@pytest.mark.parametrize("kind", ["trees", "dags"])
def test_to_device_plans_equal_direct_plans(kind):
    rng = np.random.default_rng(11)
    graphs = ([tst.random_binary_tree(int(rng.integers(2, 40)), rng)
               for _ in range(8)] if kind == "trees" else
              [tst.random_dag(int(rng.integers(4, 20)), rng, max_arity=3)
               for _ in range(6)])
    s = tst.pack_batch(graphs)
    d = s.to_device("cpu")
    _same_plan(d.ext_plan, tst.ScatterPlan.build(s.ext_ids.reshape(-1),
                                                 "cpu"))
    _check_plan(s.ext_ids.reshape(-1), d.ext_plan)
    assert d.ext_plan.split_chunks > 0              # padding at the sentinel
    assert len(d.child_plans) == s.T
    for t in range(s.T):
        flat = s.child_ids[t].reshape(-1)
        _same_plan(d.child_plans[t], tst.ScatterPlan.build(flat, "cpu"))
        _check_plan(flat, d.child_plans[t])
        assert torch.equal(d.child_plans[t].order, d.sort_perm[t])
    bare = tst.pack_batch(graphs, with_runs=False).to_device("cpu")
    assert bare.ext_plan is None and bare.child_plans is None
    with pytest.raises(ValueError, match="sorted runs"):
        tst.pack_batch(graphs, with_runs=False).scatter_plans("cpu")


def test_ops_on_cpu_ignores_the_plan():
    dst, idx, rows = _case(4, 20, 6, 300, 0.9)
    plan = tst.ScatterPlan.build(idx, "cpu")
    a = tops.scatter_add_rows(torch.from_numpy(dst.copy()),
                              torch.from_numpy(idx), torch.from_numpy(rows),
                              plan=plan)
    b = tref.scatter_add_rows(torch.from_numpy(dst.copy()),
                              torch.from_numpy(idx), torch.from_numpy(rows))
    assert torch.equal(a, b)


@pytest.mark.parametrize("fusion_mode", ["auto", "none"])
def test_scheduler_passes_the_schedules_plans(fusion_mode, monkeypatch):
    """The fused leg's ∂pull and the op-by-op leg's ∂gather (one a level)
    and ∂pull hand ``ops.scatter_add_rows`` the schedule's own plans, each
    the plan of the indices it is called with."""
    rng = np.random.default_rng(2)
    graphs = [tst.random_binary_tree(int(rng.integers(2, 12)), rng)
              for _ in range(4)]
    fn = TreeLSTMVertex(input_dim=4, hidden=6, arity=2)
    params = fn.init(torch.Generator().manual_seed(0), device="cpu")
    s = tst.pack_batch(graphs)
    d = s.to_device("cpu")
    ext = torch.from_numpy(rng.standard_normal((s.K * s.N + 1, 4))
                           .astype(np.float32))
    ext[-1] = 0.0
    calls = []
    inner = tops.scatter_add_rows

    def tap(dst, idx, rows, **kw):
        calls.append((idx.clone(), kw.get("plan")))
        return inner(dst, idx, rows, **kw)

    monkeypatch.setattr(tops, "scatter_add_rows", tap)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    buf = tsch.execute_lazy(fn, leaves, ext.clone().requires_grad_(), d,
                            fusion_mode=fusion_mode)
    buf.sum().backward()
    want = ([] if fusion_mode == "auto" else
            [d.child_plans[t] for t in reversed(range(s.T))]) + [d.ext_plan]
    assert len(calls) == len(want)
    for (idx, plan), w in zip(calls, want):
        assert plan is w
        _same_plan(plan, tst.ScatterPlan.build(idx.numpy(), "cpu"))
