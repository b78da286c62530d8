"""Continuous and decode serving on the card: the K6 row gather/scatter
kernels against their plain versions (bit for bit; K6a with the ids on
the host, one launch per ``GATHER_CAP``, its rows also in a pinned host
buffer), a retiring window's copies by the profiler (none host→device,
at most one device→host), the frontier
megastep, one launch that stores each lane's row at its arena id, against
the plain frontier (1e-4 of max |plain|) for every kind, the designed
launches of a continuous tick (one megastep, one CUDA launch; one row
scatter a tick on the op-by-op leg) and of a decode tick (one megastep),
and a kernel fault failing the in-flight requests of both engines with no
fallback to the plain versions.  Every test is
``gpu``-marked and skips inside its body where there is no card; none
needs JAX, which the GPU machine lacks."""

import numpy as np
import pytest
import torch

from repro_torch.core.scheduler import resolve_fusion
from repro_torch.core.structure import chain, random_binary_tree
from repro_torch.dist.fault import ScriptedChaos, install_chaos
from repro_torch.kernels import gather_scatter as gsc
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import ops, ref
from repro_torch.models.readout import ClassificationHead
from repro_torch.models.rnn import GRUVertex, LSTMVertex
from repro_torch.models.treelstm import TreeFCVertex, TreeLSTMVertex
from repro_torch.serve import (AdmissionPolicy, ContinuousBatchEngine,
                               ContinuousRequest, StructureRequest,
                               StructureServeEngine, VertexRequest,
                               VertexServeEngine)
from repro_torch.serve.robustness import FAILED, OK

TOL = 1e-4
X = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _pinned(n, D, dtype):
    return gsc.host_rows(max(n, 1), D, dtype, True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D,n", [(4097, 1024, 256), (1025, 512, 64),
                                   (100, 130, 33), (9, 3, 1), (50, 1025, 17)])
def test_k6_kernels_equal_plain_bit_for_bit(R, D, n, dtype):
    """K6a (the ids on the host, the rows also stored into a pinned host
    buffer) and K6b (the ids on the card) against their plain versions."""
    _need_card()
    gen = torch.Generator().manual_seed(R + D + n)
    src = torch.randn(R, D, generator=gen).to(dtype).cuda()
    idx = torch.randint(0, R, (n,), generator=gen, dtype=torch.int32)
    host = _pinned(n, D, dtype)
    got = gsc.gather_rows(src, idx, host_out=host)
    want = ref.gather_rows(src, idx.cuda())
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(host[:n]), _bits(want.cpu()))
    live = torch.randperm(R, generator=gen)[:n].to(torch.int32)
    pads = torch.tensor([R, R + 1, R + 7], dtype=torch.int32)
    ids = torch.cat([live, pads]).cuda()
    rows = torch.randn(ids.numel(), D, generator=gen).to(dtype).cuda()
    dst = torch.randn(R, D, generator=gen).to(dtype).cuda()
    k = gsc.scatter_rows(dst.clone(), ids, rows)
    p = ref.scatter_rows(dst.clone(), ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(_bits(k), _bits(p))
    keep = torch.ones(R, dtype=torch.bool, device="cuda")
    keep[live.long().cuda()] = False
    assert torch.equal(_bits(k[keep]), _bits(dst[keep]))


CAP = gsc.GATHER_CAP


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", [
    (torch.float32, 1024),       # 16-byte vectors
    (torch.float32, 130),        # 8-byte
    (torch.float32, 3),          # 4-byte
    (torch.bfloat16, 129),       # 2-byte
    (torch.bfloat16, 1024)])
@pytest.mark.parametrize("n", [1, 7, CAP, CAP + 1])
def test_k6a_ids_by_value_equal_index_select(n, dtype, D):
    """K6a equals ``index_select`` bit for bit at 1, 7, ``GATHER_CAP`` and
    one past it (two launches), at every vector width; its host rows equal
    its card rows; ids outside ``[0, R)`` give zero rows; a numpy id array
    works like a CPU tensor."""
    _need_card()
    R = 600
    gen = torch.Generator().manual_seed(n + D)
    src = torch.randn(R, D, generator=gen).to(dtype).cuda()
    idx = torch.randint(0, R, (n,), generator=gen, dtype=torch.int32)
    host = _pinned(n, D, dtype)
    lm.reset_launches()
    got = gsc.gather_rows(src, idx, host_out=host)
    torch.cuda.synchronize()
    assert lm.LAUNCHES == {"gather_rows": -(-n // CAP)}
    assert torch.equal(_bits(got),
                       _bits(torch.index_select(src, 0, idx.long().cuda())))
    assert torch.equal(_bits(host[:n]), _bits(got.cpu()))
    bad = idx.clone()
    bad[::3] = R + 5
    bad[1::5] = -1
    out = gsc.gather_rows(src, bad.numpy(), host_out=host)
    torch.cuda.synchronize()
    live = ((bad >= 0) & (bad < R)).cuda()
    want = torch.where(live[:, None],
                       src.index_select(0, torch.where(live, bad.cuda(), 0)),
                       torch.zeros((), dtype=dtype, device="cuda"))
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(_bits(host[:n]), _bits(want.cpu()))


@pytest.mark.gpu
def test_k6_wrappers_count_launches_and_refuse():
    _need_card()
    lm.reset_launches()
    src = torch.randn(10, 4, device="cuda")
    ops.gather_rows(src, torch.tensor([1, 2], dtype=torch.int32))
    ops.scatter_rows(src, torch.tensor([3], dtype=torch.int32,
                                       device="cuda"),
                     torch.zeros(1, 4, device="cuda"))
    assert lm.LAUNCHES == {"gather_rows": 1, "scatter_rows": 1}
    with pytest.raises(TypeError):
        gsc.gather_rows(src.double(), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="host"):        # ids on the card
        gsc.gather_rows(src, torch.zeros(1, dtype=torch.int32,
                                         device="cuda"))
    with pytest.raises(ValueError, match="page-locked"):  # not pinned
        gsc.gather_rows(src, torch.zeros(1, dtype=torch.int32),
                        host_out=torch.zeros(1, 4))
    with pytest.raises(ValueError):
        gsc.scatter_rows(src, torch.zeros(1, dtype=torch.int32,
                                          device="cuda"),
                         torch.zeros(2, 4, device="cuda"))
    assert lm.LAUNCHES == {"gather_rows": 1, "scatter_rows": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("with_head", [True, False])
def test_retiring_window_makes_at_most_one_copy(with_head):
    """A retiring window enqueues no host→device copy and at most one
    device→host copy (the head's logits; none without a head): K6a takes
    the root ids by value and stores the roots into the engine's pinned
    buffer, and one sync covers both."""
    _need_card()
    fn = LSTMVertex(X, 72)
    gen = torch.Generator().manual_seed(0)
    params = fn.init(gen, device="cuda")
    head = ClassificationHead(fn.state_dim, 5) if with_head else None
    hp = head.init(gen, device="cuda") if with_head else None
    eng = ContinuousBatchEngine(
        fn, params, num_rows=256, frontier_width=16, head=head,
        head_params=hp, device="cuda",
        policy=AdmissionPolicy(min_occupancy=0.0, max_window=4))
    assert eng._host.is_pinned()
    reqs = [ContinuousRequest(i, g, x) for i, (g, x) in
            enumerate(_chains(6, 24))]
    import chip_smoke                # the copy count its phases check
    per = chip_smoke.retire_copies(eng, reqs, 0.05, 8)
    assert len(per) == eng.readbacks > 0
    assert all(w["api"] <= int(with_head) and w["h2d"] == 0
               and w["d2h"] <= 1 for w in per), per
    assert any(w["k6a"] for w in per), "the profiler kept no window's events"
    assert all(r.status == OK for r in reqs)


CELLS = {"treelstm": lambda H: TreeLSTMVertex(X, H, 2),
         "lstm": lambda H: LSTMVertex(X, H),
         "gru": lambda H: GRUVertex(X, H),
         "treefc": lambda H: TreeFCVertex(X, H, 2)}


def _frontier_case(kind, H, M, R, gen):
    """A tick over an arena of R rows and the sentinel R that keeps the
    frontier's contract: the live lanes store to rows of one half of a
    permutation of the arena, children read the other half (or the
    sentinel, mask 0); every fourth lane from M / 3 is a pad lane (node
    mask 0, an id past the arena, children at the sentinel)."""
    fn = CELLS[kind](H)
    A = max(1, fn.arity)
    params = fn.init(gen, device="cuda")
    params["b"] = (torch.randn(params["b"].shape, generator=gen) * 0.1) \
        .cuda()
    spec = resolve_fusion(fn, "megastep", sched_arity=A)
    buf = torch.randn(R + 1, fn.state_dim, generator=gen) * 0.5
    buf[R] = 0.0
    perm = torch.randperm(R, generator=gen).to(torch.int32)
    half = R // 2
    cmask = (torch.rand(M, A, generator=gen) > 0.3).float()
    reads = perm[half:][torch.randint(0, R - half, (M, A), generator=gen)]
    cids = torch.where(cmask > 0, reads,
                       torch.full((M, A), R, dtype=torch.int32))
    nm = torch.ones(M)
    nm[M // 3::4] = 0.0
    out = R + 1 + torch.arange(M, dtype=torch.int32)
    live = (nm > 0).nonzero()[:, 0]
    out[live] = perm[:live.numel()]
    cids[nm == 0] = R
    cmask[nm == 0] = 0.0
    rows = torch.randn(M, fn.ext_dim, generator=gen) * 0.5
    return (spec, *(t.cuda() for t in (buf, cids, cmask, rows, nm, out)),
            spec.weights(params))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["treelstm", "lstm", "gru", "treefc"])
@pytest.mark.parametrize("H,M,R", [(16, 5, 40), (72, 64, 300),
                                   (512, 256, 4096), (5, 70, 200)])
def test_frontier_megastep_matches_plain_on_card(kind, H, M, R):
    """The staged composition (megastep into a staging block, then K6b)
    folded into one launch: the megastep over the arena itself stores
    each lane's row at its id.  Against the plain frontier within 1e-4 of
    max |plain|; rows no live lane names (the sentinel among them) and
    the pad lanes' rows bit-unchanged; two launches bitwise equal; one
    counted launch and one CUDA launch a tick, no scatter; the tick keeps
    the contract."""
    _need_card()
    gen = torch.Generator().manual_seed(H + M)
    spec, buf, cids, cmask, rows, nm, out, w = _frontier_case(kind, H, M, R,
                                                              gen)
    assert bool(ops.frontier_contract_holds(cids, out, R + 1))
    want = ref.frontier_megastep(kind, buf.clone(), cids, cmask, rows, nm,
                                 out, w)
    lm.reset_launches()
    got = ops.frontier_megastep(kind, buf.clone(), cids, cmask, rows, nm,
                                out, w)
    assert lm.LAUNCHES == {f"{kind}_megastep": 1}
    assert lm.CUDA_LAUNCHES[f"{kind}_megastep"] == 1
    got2 = ops.frontier_megastep(kind, buf.clone(), cids, cmask, rows, nm,
                                 out, w)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale
    assert torch.equal(_bits(got), _bits(got2))
    untouched = torch.ones(R + 1, dtype=torch.bool, device="cuda")
    untouched[out[nm > 0].long()] = False
    assert torch.equal(_bits(got[untouched]), _bits(buf[untouched]))
    assert not got[R].any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["treelstm", "lstm"])
def test_frontier_megastep_with_ext_ids_on_card(kind):
    """Pulled rows through ``ext_ids`` into a larger matrix (the engine's
    pulled-row arena): the same rows as pre-gathered ones, bit for bit."""
    _need_card()
    gen = torch.Generator().manual_seed(7)
    spec, buf, cids, cmask, rows, nm, out, w = _frontier_case(kind, 72, 64,
                                                              300, gen)
    table = torch.randn(300, rows.shape[1], generator=gen).cuda()
    ids = torch.randperm(300, generator=gen)[:64].to(torch.int32).cuda()
    table[ids.long()] = rows
    a = ops.frontier_megastep(kind, buf.clone(), cids, cmask, rows, nm,
                              out, w)
    b = ops.frontier_megastep(kind, buf.clone(), cids, cmask, table, nm,
                              out, w, ext_ids=ids)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))


def _chains(seed, n, lo=1, hi=9):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = chain(int(rng.integers(lo, hi)))
        out.append((g, (rng.standard_normal((g.num_nodes, X)) * 0.4)
                    .astype(np.float32)))
    return out


def _trees(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = random_binary_tree(int(rng.integers(1, 12)), rng)
        out.append((g, (rng.standard_normal((g.num_nodes, X)) * 0.4)
                    .astype(np.float32)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["lstm", "treelstm"])
def test_continuous_engine_launches_per_tick_and_roots(cell):
    """Each tick is one megastep, one CUDA launch that stores the lanes'
    rows at their ids (no row scatter); each retiring window one row
    gather; the roots and head logits within 1e-4 of solo scoring on the
    card and of the plain path on the CPU."""
    _need_card()
    fn = TreeLSTMVertex(X, 72, 2) if cell == "treelstm" else LSTMVertex(X, 72)
    gen = torch.Generator().manual_seed(0)
    params = fn.init(gen, device="cuda")
    params["b"] = (torch.randn(params["b"].shape, generator=gen) * 0.1) \
        .cuda()
    head = ClassificationHead(fn.state_dim, 5)
    hp = head.init(gen, device="cuda")
    data = _trees(1, 12) if cell == "treelstm" else _chains(1, 12)

    def run(device, p, h):
        eng = ContinuousBatchEngine(
            fn, p, num_rows=256, frontier_width=16, head=head,
            head_params=h, device=device,
            policy=AdmissionPolicy(min_occupancy=0.0, max_window=4))
        reqs = [ContinuousRequest(i, g, x) for i, (g, x) in enumerate(data)]
        for r in reqs:
            assert eng.submit(r), r.error
        eng.run()
        return eng, reqs

    lm.reset_launches()
    eng, reqs = run("cuda", params, hp)
    kind = "treelstm" if cell == "treelstm" else "lstm"
    assert lm.LAUNCHES[f"{kind}_megastep"] == eng.ticks > 0
    assert lm.CUDA_LAUNCHES[f"{kind}_megastep"] == eng.ticks
    assert "scatter_rows" not in lm.LAUNCHES
    assert 0 < lm.LAUNCHES["gather_rows"] <= eng.windows
    h = eng.health()
    assert h["degradations"] == 0 and not h["breaker_open"]
    assert all(r.status == OK for r in reqs)
    assert not eng._buf.any()
    cpu = {k: v.cpu() for k, v in params.items()}
    _, creqs = run("cpu", cpu, {k: v.cpu() for k, v in hp.items()})
    for r, c in zip(reqs, creqs):
        np.testing.assert_allclose(r.root_state, c.root_state, rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(r.logits, c.logits, rtol=0, atol=TOL)
        solo = StructureServeEngine(fn, params, batch_size=1, device="cuda")
        s = StructureRequest(0, r.graph, r.inputs)
        solo.submit(s)
        solo.run()
        np.testing.assert_allclose(r.root_state, s.root_state, rtol=0,
                                   atol=TOL)


@pytest.mark.gpu
def test_unfused_continuous_engine_scatters_each_tick():
    """The op-by-op leg of the continuous engine (``fusion_mode="none"``):
    each tick gathers its children, runs the cell in plain ops and
    scatters the states with one K6b launch; roots within 1e-4 of the
    fused engine's."""
    _need_card()
    fn = LSTMVertex(X, 72)
    params = fn.init(torch.Generator().manual_seed(0), device="cuda")
    data = _chains(2, 10)

    def run(mode):
        eng = ContinuousBatchEngine(
            fn, params, num_rows=128, frontier_width=16, fusion_mode=mode,
            device="cuda",
            policy=AdmissionPolicy(min_occupancy=0.0, max_window=4))
        reqs = [ContinuousRequest(i, g, x) for i, (g, x) in enumerate(data)]
        for r in reqs:
            assert eng.submit(r), r.error
        lm.reset_launches()
        eng.run()
        return eng, reqs, dict(lm.LAUNCHES)

    eng, reqs, launches = run("none")
    assert not eng.fused
    assert launches["scatter_rows"] == eng.ticks > 0
    assert "lstm_megastep" not in launches
    _, freqs, _ = run("auto")
    for r, f in zip(reqs, freqs):
        assert r.status == f.status == OK
        np.testing.assert_allclose(r.root_state, f.root_state, rtol=0,
                                   atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [LSTMVertex, GRUVertex])
def test_decode_engine_one_launch_per_tick(cell):
    _need_card()
    fn = cell(input_dim=X, hidden=72)
    gen = torch.Generator().manual_seed(1)
    params = fn.init(gen, device="cuda")
    params["b"] = (torch.randn(params["b"].shape, generator=gen) * 0.1) \
        .cuda()
    rng = np.random.default_rng(2)
    xs = [(rng.standard_normal((int(rng.integers(1, 12)), X)) * 0.3)
          .astype(np.float32) for _ in range(9)]

    def run(device, p):
        eng = VertexServeEngine(fn, p, num_slots=4, device=device)
        reqs = [VertexRequest(i, x) for i, x in enumerate(xs)]
        for r in reqs:
            assert eng.submit(r)
        eng.run()
        return eng, reqs

    lm.reset_launches()
    eng, reqs = run("cuda", params)
    kind = "lstm" if cell is LSTMVertex else "gru"
    assert lm.LAUNCHES == {f"{kind}_megastep": eng.ticks}
    assert all(r.status == OK for r in reqs)
    _, creqs = run("cpu", {k: v.cpu() for k, v in params.items()})
    for r, c in zip(reqs, creqs):
        np.testing.assert_allclose(r.final_state, c.final_state, rtol=0,
                                   atol=TOL)


@pytest.mark.gpu
def test_kernel_fault_fails_inflight_without_fallback():
    """A kernel fault on the card fails the in-flight requests of both
    engines: no degradation, no launch, the breaker closed, freed rows
    zeroed."""
    _need_card()
    fn = LSTMVertex(X, 16)
    params = fn.init(torch.Generator().manual_seed(3), device="cuda")
    hook = ScriptedChaos(fail={"kernel": list(range(100))})
    lm.reset_launches()
    with install_chaos(hook):
        ceng = ContinuousBatchEngine(fn, params, num_rows=64,
                                     frontier_width=8, breaker_threshold=1,
                                     device="cuda")
        creqs = [ContinuousRequest(i, g, x)
                 for i, (g, x) in enumerate(_chains(4, 5))]
        for r in creqs:
            ceng.submit(r)
        ceng.run()
        veng = VertexServeEngine(fn, params, num_slots=2,
                                 breaker_threshold=1, device="cuda")
        vreqs = [VertexRequest(i, x) for i, (_g, x)
                 in enumerate(_chains(5, 3))]
        for r in vreqs:
            veng.submit(r)
        veng.run()
    assert hook.calls["kernel"] > 0
    assert not lm.LAUNCHES.get("lstm_megastep")
    for eng, reqs in ((ceng, creqs), (veng, vreqs)):
        assert all(r.status == FAILED for r in reqs)
        assert all("injected kernel failure" in r.error for r in reqs)
        h = eng.health()
        assert h["degradations"] == 0 and not h["breaker_open"]
        assert eng.fused and eng.last_degradation is None
        assert not eng._buf.any()
