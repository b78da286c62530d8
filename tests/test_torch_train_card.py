"""The backward's hand-written kernels on the card: the reverse megastep
(K2) and the row scatter-add (K7) against their plain versions, training
gradients that repeat bit for bit, the fused leg against the op-by-op
leg, and a refused launch that raises instead of falling back to the
plain version.  Every test here is ``gpu``-marked and skips inside its
body where there is no card; none needs JAX, which the GPU machine
lacks.

Tolerance: the kernels' error relative to max |plain| <= 1e-4, the
reference's fused-vs-unfused bar (``repro/core/scheduler.py:305``); rows
a launch does not touch are compared bit for bit."""

import numpy as np
import pytest
import torch

from repro_torch.core import scheduler as tsch
from repro_torch.core.structure import (ScatterPlan, pack_batch,
                                        random_binary_tree, random_dag)
from repro_torch.interop import pack_recurrent
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.models.treelstm import TreeLSTMVertex

TOL = 1e-4
WEIGHTS = ("ui", "uf", "uo", "uu", "b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _weights(rng, h, dev):
    p = {k: torch.from_numpy((rng.standard_normal((h, h)) * h ** -0.5)
                             .astype(np.float32)) for k in WEIGHTS[:4]}
    p["b"] = torch.from_numpy((rng.standard_normal(4 * h) * 0.1)
                              .astype(np.float32))
    p = pack_recurrent({k: v.to(dev) for k, v in p.items()})
    return tuple(p[k] for k in WEIGHTS)


def _graphs(kind, rng):
    if kind == "trees":
        return [random_binary_tree(int(rng.integers(2, 30)), rng)
                for _ in range(6)]
    if kind == "one":                             # levels of one live slot
        return [random_binary_tree(5, rng)]
    return [random_dag(int(rng.integers(6, 24)), rng, max_arity=3)
            for _ in range(6)]


def _cuda_launches(kind="treelstm"):
    return lm.LAUNCHES[f"{kind}_bwd_megastep.cuda_launches"]


def _levels(kind, seed, h=72, dev="cuda", **pads):
    """Every level of a packed schedule, with random buffer, gradient and
    ext rows (sentinels zero)."""
    rng = np.random.default_rng(seed)
    s = pack_batch(_graphs(kind, rng), **pads)
    d = s.to_device(dev)
    R = s.T * s.M + 1
    buf = torch.from_numpy((rng.standard_normal((R, 2 * h)) * 0.5)
                           .astype(np.float32))
    buf[-1] = 0.0
    g = torch.from_numpy(rng.standard_normal((R, 2 * h)).astype(np.float32))
    ext = torch.from_numpy((rng.standard_normal((s.K * s.N + 1, 4 * h))
                            * 0.5).astype(np.float32))
    ext[-1] = 0.0
    return s, d, buf.to(dev), g.to(dev), ext.to(dev), _weights(rng, h, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,pads,h", [
    ("trees", {}, 72), ("dags", {}, 72),
    ("trees", {"pad_levels": 32, "pad_width": 256}, 72),
    ("trees", {}, 20), ("dags", {}, 20), ("one", {}, 72), ("one", {}, 5)])
def test_reverse_megastep_matches_plain_on_card(kind, pads, h):
    """Every level through the kernel with the schedule's plan against the
    plain version (error relative to max |plain| <= TOL), rows no child
    touches bit-unchanged, a second launch bitwise equal, and the CUDA
    launches the level's plan designs (none without a live slot, 2 where
    every row gets one contribution, 3 on a DAG level with a run of
    several).  H 20 and 5 are ragged widths (a partial k-step of 8; 5
    takes 4-byte copies)."""
    _need_card()
    s, d, buf, g, ext, w = _levels(kind, 1, h=h, **pads)
    ws = lmb.bwd_workspace("treelstm", s.M, s.A, w[0].shape[0], "cuda")
    lm.reset_launches()
    for t in range(s.T):
        want = ref.bwd_megastep("treelstm", g.clone(), buf, d.child_ids[t],
                                d.child_mask[t], d.ext_ids[t],
                                d.node_mask[t], t * s.M, ext, w)
        before = _cuda_launches()
        args = ("treelstm", buf, d.child_ids[t], d.ext_ids[t],
                d.node_mask[t], t * s.M, ext, w)
        got = lmb.bwd_megastep(args[0], g.clone(), *args[1:], workspace=ws,
                               **tsch._level_runs(d, t))
        made = _cuda_launches() - before
        again = lmb.bwd_megastep(args[0], g.clone(), *args[1:],
                                 workspace=ws, **tsch._level_runs(d, t))
        torch.cuda.synchronize()
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) / scale <= TOL, t
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), t
        touched = torch.zeros(g.shape[0], dtype=torch.bool, device="cuda")
        touched[d.child_ids[t].reshape(-1).long()] = True
        touched[-1] = False                       # the sentinel is kept
        assert torch.equal(got[~touched].view(torch.int32),
                           g[~touched].view(torch.int32)), t
        live, single = d.live[t], d.bwd_single[t]
        assert made == (0 if live == 0 else 2 if single else 3), t
    work = sum(1 for live in d.live if live)
    assert lm.LAUNCHES["treelstm_bwd_megastep"] == 2 * work
    if kind == "dags":
        assert not all(d.bwd_single), "no level with a run of several"
    if kind == "one":
        assert 1 in d.live, "no level of one live slot"


@pytest.mark.gpu
@pytest.mark.parametrize("kind,pads", [
    ("trees", {}), ("one", {}), ("dags", {}),
    ("trees", {"pad_levels": 32, "pad_width": 256})])
def test_cuda_launches_a_level_follow_the_plan(kind, pads):
    """K2's CUDA launches a level, as the entry point counts them: none on
    a level with no live slot (leaves, padding levels), at most 2 on a
    tree level (each row one contribution: the two passes add into the
    gradient rows themselves), 3 on a DAG level with a run of several
    (the run pass)."""
    _need_card()
    s, d, buf, g, ext, w = _levels(kind, 5, **pads)
    made = []
    for t in range(s.T):
        before = _cuda_launches()
        lmb.bwd_megastep("treelstm", g, buf, d.child_ids[t], d.ext_ids[t],
                         d.node_mask[t], t * s.M, ext, w,
                         **tsch._level_runs(d, t))
        made.append(_cuda_launches() - before)
    torch.cuda.synchronize()
    assert made == [0 if not live else 2 if single else 3
                    for live, single in zip(d.live, d.bwd_single)]
    assert made[0] == 0                           # the leaves
    if kind == "dags":
        assert 3 in made
    else:
        assert max(made) == 2
    if pads:
        assert made[-1] == 0                      # a padding level


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["trees", "dags"])
def test_reverse_megastep_builds_its_plan_without_one(kind):
    """A level called without its plan (a hand-built level) gets the bits
    of the same level with the schedule's plan."""
    _need_card()
    s, d, buf, g, ext, w = _levels(kind, 2)
    for t in range(s.T):
        kw = tsch._level_runs(d, t)
        args = ("treelstm", buf, d.child_ids[t], d.ext_ids[t],
                d.node_mask[t], t * s.M, ext, w)
        planned = lmb.bwd_megastep(args[0], g.clone(), *args[1:], **kw)
        for k in ("live", "single", "heads"):
            kw.pop(k)
        built = lmb.bwd_megastep(args[0], g.clone(), *args[1:], **kw)
        torch.cuda.synchronize()
        assert torch.equal(planned.view(torch.int32),
                           built.view(torch.int32)), t


@pytest.mark.gpu
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("R,D,n,heavy,strided", [
    (33, 40, 500, 0.0, False), (200, 2048, 3000, 0.9, False),
    (5, 7, 1, 0.0, False),
    (32 * 65535 + 100, 4, 4000, 0.5, False),      # R past the old grid
    (300, 7, 2000, 0.95, False),                  # D % 4 != 0, split runs
    (300, 130, 2000, 0.95, True),                 # strided dst, odd stride
    (64, 36, 3000, 1.0, True),                    # every index on one row
    (10, 16, 0, 0.0, False)])                     # n = 0
def test_scatter_add_rows_matches_plain_on_card(R, D, n, heavy, strided,
                                                with_plan):
    """The kernel against ``index_add_`` (error relative to max |plain|
    <= TOL), bit for bit against the plain rendering of its own
    summation order (``ref.scatter_add_rows_planned``) and against a
    second launch, rows no index points at (and a strided dst's other
    columns) bit-unchanged; with the plan given or built by the
    wrapper."""
    _need_card()
    rng = np.random.default_rng(R + n)
    width = D + (1 if D % 4 else 4) if strided else D
    base = torch.from_numpy(rng.standard_normal((R, width))
                            .astype(np.float32)).cuda()
    dst = base[:, :D]
    idx = rng.integers(0, R, size=n).astype(np.int32)
    idx[rng.random(n) < heavy] = R - 1            # a duplicate-heavy row
    rows = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    rows = rows.cuda()
    idx_t = torch.from_numpy(idx).cuda()
    plan = ScatterPlan.build(idx, "cuda") if with_plan else None
    want = ref.scatter_add_rows(dst.clone(), idx_t, rows)
    order = ref.scatter_add_rows_planned(
        dst.clone(), rows, ScatterPlan.build(idx, "cuda"))
    lm.reset_launches()
    out = base.clone()
    got = lmb.scatter_add_rows(out[:, :D], idx_t, rows, plan=plan)
    again = lmb.scatter_add_rows(base.clone()[:, :D], idx_t, rows, plan=plan)
    torch.cuda.synchronize()
    assert lm.LAUNCHES["scatter_add_rows"] == (2 if n else 0)
    assert float((got - want).abs().max()) \
        / max(float(want.abs().max()), 1e-30) <= TOL
    assert torch.equal(got.view(torch.int32), order.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    untouched = torch.from_numpy(np.setdiff1d(np.arange(R), idx)).cuda()
    assert torch.equal(got[untouched].view(torch.int32),
                       dst[untouched].view(torch.int32))
    assert torch.equal(out[:, D:], base[:, D:])


@pytest.mark.gpu
def test_scatter_add_rows_refuses_a_plan_that_does_not_fit():
    """A plan of other indices (another count, a row past dst, another
    device) raises before any launch."""
    _need_card()
    dst = torch.zeros(8, 16, device="cuda")
    idx = torch.tensor([1, 7, 7], dtype=torch.int32, device="cuda")
    rows = torch.ones(3, 16, device="cuda")
    lm.reset_launches()
    for plan in (ScatterPlan.build(np.array([1, 7], np.int32), "cuda"),
                 ScatterPlan.build(np.array([1, 9, 9], np.int32), "cuda"),
                 ScatterPlan.build(np.array([1, 7, 7], np.int32), "cpu")):
        with pytest.raises(ValueError, match="plan"):
            lmb.scatter_add_rows(dst, idx, rows, plan=plan)
    with pytest.raises(ValueError, match="row"):
        lmb.scatter_add_rows(dst, torch.tensor([8], dtype=torch.int32,
                                               device="cuda"), rows[:1])
    torch.cuda.synchronize()
    assert sum(lm.LAUNCHES.values()) == 0
    assert not dst.any()


def _grads(fn, params, sched, ext, labels_cot, fusion_mode):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    e = ext.clone().requires_grad_()
    buf = tsch.execute_lazy(fn, leaves, e, sched, fusion_mode=fusion_mode)
    buf.backward(labels_cot)
    return {**{k: v.grad for k, v in leaves.items()}, "external": e.grad}


def _train_case(seed, kind="trees", h=72, x=16):
    rng = np.random.default_rng(seed)
    graphs = _graphs(kind, rng)
    fn = TreeLSTMVertex(input_dim=x, hidden=h,
                        arity=max(g.max_arity for g in graphs))
    params = fn.init(torch.Generator().manual_seed(seed), device="cuda")
    s = pack_batch(graphs, pad_width=256)
    ext = np.zeros((s.K * s.N + 1, x), np.float32)
    ext[:-1] = rng.standard_normal((s.K * s.N, x)) * 0.5
    cot = rng.standard_normal((s.T * s.M + 1, 2 * h)).astype(np.float32)
    return (fn, params, s.to_device("cuda"), torch.from_numpy(ext).cuda(),
            torch.from_numpy(cot).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["trees", "dags"])
def test_training_gradients_repeat_bitwise_and_match_opbyop(kind):
    _need_card()
    fn, params, sched, ext, cot = _train_case(3, kind)
    lm.reset_launches()
    first = _grads(fn, params, sched, ext, cot, "auto")
    work = [single for live, single in zip(sched.live, sched.bwd_single)
            if live]
    assert lm.LAUNCHES["treelstm_bwd_megastep"] == len(work)
    assert _cuda_launches() == sum(2 if single else 3 for single in work)
    assert lm.LAUNCHES["scatter_add_rows"] == 1
    second = _grads(fn, params, sched, ext, cot, "auto")
    oracle = _grads(fn, params, sched, ext, cot, "none")
    torch.cuda.synchronize()
    for k, v in first.items():
        assert torch.equal(v.view(torch.int32),
                           second[k].view(torch.int32)), k
        scale = max(float(oracle[k].abs().max()), 1e-30)
        assert float((v - oracle[k]).abs().max()) / scale <= TOL, k


@pytest.mark.gpu
def test_refused_launch_raises_without_fallback(monkeypatch):
    """A launch CUDA refuses, a schedule without its sorted runs or an
    argument the kernel does not take raises; nothing falls back to the
    plain version and the gradient buffer is left as it was."""
    _need_card()
    s, d, buf, g, ext, w = _levels("trees", 4, h=16)
    t = s.T - 1
    args = ("treelstm", g, buf, d.child_ids[t], d.child_mask[t],
            d.ext_ids[t], d.node_mask[t], t * s.M, ext, w)
    runs = dict(sort_perm=d.sort_perm[t],
                sorted_child_ids=d.sorted_child_ids[t],
                run_head=d.run_head[t])
    before = g.clone()
    with pytest.raises(ValueError, match="sorted runs"):
        ops.bwd_megastep(*args)
    with pytest.raises(ValueError, match="unknown megastep gate kind"):
        ops.bwd_megastep("bogus", *args[1:], **runs)
    with pytest.raises(TypeError):
        ops.bwd_megastep("treelstm", g.double(), *args[2:], **runs)
    with pytest.raises(TypeError):
        ops.scatter_add_rows(g, d.child_ids[t].reshape(-1).long(),
                             g[:s.M * s.A])
    lm.reset_launches()

    def refused(*a):
        return 1                                  # cudaErrorInvalidValue

    monkeypatch.setitem(_build._LOADED, "treelstm_bwd_megastep", refused)
    monkeypatch.setitem(_build._LOADED, "scatter_add_rows", refused)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ops.bwd_megastep(*args, **runs)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ops.scatter_add_rows(g, d.child_ids[t].reshape(-1),
                             g[:s.M * s.A].clone())
    torch.cuda.synchronize()
    assert sum(lm.LAUNCHES.values()) == 0
    assert torch.equal(g, before)
