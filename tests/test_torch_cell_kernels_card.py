"""The op-by-op leg's gate kernels on the card: K8a ``lstm_gates``, K8b
``treelstm_gates`` and K9 ``lstm_level_fused`` against their plain
versions at edge shapes (M = 1, widths that are no multiple of a tile or
a vector, A = 1/2/3, strided views of gathered states, bf16 buffers);
two launches bitwise equal; each wrapper refusing CPU tensors and types
it does not take; each backward raising; and the launch counts through
``execute(fusion_mode="none")`` and both serving engines on that leg.
Every test here is ``gpu``-marked and skips inside its body where there
is no card; none needs JAX, which the GPU machine lacks.

Tolerances: 1e-5 absolute on a float32 gate chain and 1e-4 of max |plain|
on K9's product (the reference's bars, ``tests/test_kernels.py:32`` and
``repro/core/scheduler.py:305``); 2e-2 / 3e-2 on bf16 outputs (one bf16
rounding of values up to ~4, ``tests/test_kernels.py:32``/``:241``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import scheduler as tsch
from repro_torch.core.structure import (chain, pack_batch, pack_external,
                                        random_binary_tree, random_dag)
from repro_torch.kernels import cell_kernels as ck
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_step as ls
from repro_torch.kernels import ops, ref
from repro_torch.models.rnn import LSTMVertex
from repro_torch.models.treelstm import TreeLSTMVertex
from repro_torch.serve import (StructureRequest, StructureServeEngine,
                               VertexRequest, VertexServeEngine)

TOL, GATE_TOL = 1e-4, 1e-5
BF16 = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _twice_equal(fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("m,h", [(1, 8), (37, 50), (200, 130), (128, 512),
                                 (5, 3)])
@pytest.mark.parametrize("gates_dtype,state_dtype",
                         [("float32", "float32"), ("float32", "bfloat16"),
                          ("bfloat16", "bfloat16")])
def test_lstm_gates_matches_plain(m, h, gates_dtype, state_dtype):
    _need_card()
    gen = torch.Generator().manual_seed(m * 7 + h)
    gates = _randn(gen, m, 4 * h, dtype=BF16[gates_dtype])
    state = _randn(gen, m, 2 * h, dtype=BF16[state_dtype])
    c_prev = state[:, :h]                          # strided: row stride 2H
    lm.reset_launches()
    c, hy = ck.lstm_gates(gates, c_prev)
    want = ref.lstm_gates(gates, c_prev)
    torch.cuda.synchronize()
    assert lm.LAUNCHES == {"lstm_gates": 1}
    assert c.dtype == hy.dtype == gates.dtype and c.shape == (m, h)
    tol = GATE_TOL if gates_dtype == "float32" else 2e-2
    np.testing.assert_allclose(c.float().cpu(), want[0].float().cpu(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(hy.float().cpu(), want[1].float().cpu(),
                               rtol=tol, atol=tol)
    assert _twice_equal(lambda: ck.lstm_gates(gates, c_prev))


@pytest.mark.gpu
@pytest.mark.parametrize("m,h", [(128, 512), (256, 512), (37, 52), (1, 8)])
@pytest.mark.parametrize("gates_dtype,state_dtype",
                         [("float32", "float32"), ("float32", "bfloat16"),
                          ("bfloat16", "bfloat16")])
def test_lstm_gates_every_geometry_same_bits(monkeypatch, m, h, gates_dtype,
                                             state_dtype):
    """K8a at each of its vector geometries (``cell_kernels.
    K8A_GEOMETRIES``, forced in turn) and the 1-wide route on strided,
    mixed-type and bf16 operands: within the plain version's bar, and
    every geometry bitwise the one the wrapper chooses (the math is the
    same lane by lane); at M 128, H 512 the chosen grid puts two CTAs on
    every SM of this card."""
    _need_card()
    gen = torch.Generator().manual_seed(m + h)
    gates = _randn(gen, m, 4 * h, dtype=BF16[gates_dtype])
    c_prev = _randn(gen, m, 2 * h, dtype=BF16[state_dtype])[:, :h]
    chosen = ck.lstm_gates(gates, c_prev)
    want = ref.lstm_gates(gates, c_prev)
    torch.cuda.synchronize()
    tol = GATE_TOL if gates_dtype == "float32" else 2e-2
    for g, w in zip(chosen, want):
        np.testing.assert_allclose(g.float().cpu(), w.float().cpu(),
                                   rtol=tol, atol=tol)
    sms = lm._sm_count(gates.device)
    if (m, h) == (128, 512):
        V, nt = ck.k8a_geometry(m, h, sms, True)
        assert -(-m * (h // V) // nt) >= 2 * sms
    for geometry in ck.K8A_GEOMETRIES + ((1, 256), (1, 64)):
        monkeypatch.setattr(ck, "k8a_geometry",
                            lambda *a, g=geometry: g)
        got = ck.lstm_gates(gates, c_prev)
        torch.cuda.synchronize()
        assert all(torch.equal(_bits(x), _bits(y))
                   for x, y in zip(got, chosen)), geometry
        assert _twice_equal(lambda: ck.lstm_gates(gates, c_prev))


@pytest.mark.gpu
def test_lstm_gates_refuses_a_vector_that_does_not_fit(monkeypatch):
    """A geometry whose vector a row stride does not allow is refused by
    the launch (never run misaligned)."""
    _need_card()
    gen = torch.Generator().manual_seed(3)
    gates = _randn(gen, 4, 4 * 6)
    c_prev = _randn(gen, 4, 13)[:, :6]             # row stride 13
    monkeypatch.setattr(ck, "k8a_geometry", lambda *a: (2, 64))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ck.lstm_gates(gates, c_prev)


@pytest.mark.gpu
@pytest.mark.parametrize("m,a,h", [(1, 1, 8), (5, 2, 16), (64, 3, 40),
                                   (130, 2, 128), (64, 2, 512)])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_treelstm_gates_matches_plain(m, a, h, state_dtype):
    _need_card()
    gen = torch.Generator().manual_seed(m + a + h)
    i, o, u = (_randn(gen, m, h) for _ in range(3))
    f = _randn(gen, m, a, h)
    cs = _randn(gen, m, a, 2 * h, dtype=BF16[state_dtype])
    mask = (torch.rand(m, a, generator=gen) > 0.3).to("cuda",
                                                      BF16[state_dtype])
    c_k = cs[..., :h]                              # strided children
    lm.reset_launches()
    c, hy = ck.treelstm_gates(i, f, o, u, c_k, mask)
    want = ref.treelstm_gates(i, f, o, u, c_k, mask)
    torch.cuda.synchronize()
    assert lm.LAUNCHES == {"treelstm_gates": 1}
    assert c.dtype == torch.float32
    np.testing.assert_allclose(c.cpu(), want[0].cpu(), rtol=GATE_TOL,
                               atol=GATE_TOL)
    np.testing.assert_allclose(hy.cpu(), want[1].cpu(), rtol=GATE_TOL,
                               atol=GATE_TOL)
    assert _twice_equal(lambda: ck.treelstm_gates(i, f, o, u, c_k, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("m,h", [(1, 8), (3, 16), (64, 64), (130, 128),
                                 (70, 72), (128, 512), (7, 5)])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_lstm_level_fused_matches_plain(m, h, state_dtype):
    """K9 on the strided halves of a gathered ``[M, 2H]`` state: 16-byte
    copies where H and the views allow, and at H 5 (views 20 or 10 bytes
    off a 16-byte boundary) the narrow copies, the bf16 rows by plain
    loads; a partial last tile at M 3, 7, 70 and 130; one launch a call,
    two bitwise equal."""
    _need_card()
    gen = torch.Generator().manual_seed(m * 3 + h)
    state = _randn(gen, m, 2 * h, dtype=BF16[state_dtype])
    ext = _randn(gen, m, 4 * h, scale=0.5)
    wh = _randn(gen, h, 4 * h, scale=h ** -0.5)
    b = _randn(gen, 4 * h, scale=0.1)
    h_prev, c_prev = state[:, h:], state[:, :h]
    lm.reset_launches()
    c, hy = ls.lstm_level_fused(h_prev, c_prev, ext, wh, b)
    want = ref.lstm_level_fused(h_prev, c_prev, ext, wh, b)
    torch.cuda.synchronize()
    assert lm.LAUNCHES == {"lstm_level_fused": 1}
    assert c.dtype == hy.dtype == state.dtype and c.shape == (m, h)
    for got, w in zip((c, hy), want):
        got, w = got.float(), w.float()
        err = float((got - w).abs().max())
        if state_dtype == "float32":
            assert err <= TOL * float(w.abs().max()), err
        else:
            np.testing.assert_allclose(got.cpu(), w.cpu(), rtol=3e-2,
                                       atol=3e-2)
    assert _twice_equal(lambda: ls.lstm_level_fused(h_prev, c_prev, ext, wh,
                                                    b))


@pytest.mark.gpu
def test_wrappers_refuse_cpu_and_unsupported_types():
    _need_card()
    m, h = 4, 8
    gen = torch.Generator().manual_seed(0)
    g, c = _randn(gen, m, 4 * h), _randn(gen, m, h)
    wh, b = _randn(gen, h, 4 * h), _randn(gen, 4 * h)
    f, cs = _randn(gen, m, 2, h), _randn(gen, m, 2, h)
    mask = torch.ones(m, 2, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ck.lstm_gates(g.cpu(), c.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        ck.treelstm_gates(c.cpu(), f.cpu(), c.cpu(), c.cpu(), cs.cpu(),
                          mask.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        ls.lstm_level_fused(c.cpu(), c.cpu(), g.cpu(), wh.cpu(), b.cpu())
    with pytest.raises(TypeError):
        ck.lstm_gates(g.half(), c)
    with pytest.raises(TypeError):
        ck.treelstm_gates(c, f, c, c, cs, mask.bfloat16())
    with pytest.raises(TypeError):
        ls.lstm_level_fused(c, c, g.bfloat16(), wh, b)
    with pytest.raises(ValueError, match="stride"):
        ck.lstm_gates(g, _randn(gen, h, m).t())    # column-major c_prev
    with pytest.raises(ValueError, match="shape"):
        ls.lstm_level_fused(c, c, g[:, :h], wh, b)


@pytest.mark.gpu
def test_backward_through_each_kernel_raises():
    """The reference's kernels have no VJP; neither do these, so a
    gradient through them fails loudly instead of taking the plain
    version."""
    _need_card()
    m, h = 3, 8
    gen = torch.Generator().manual_seed(1)
    g = _randn(gen, m, 4 * h).requires_grad_()
    c = _randn(gen, m, h).requires_grad_()
    wh = _randn(gen, h, 4 * h).requires_grad_()
    b = _randn(gen, 4 * h)
    f, cs = _randn(gen, m, 2, h), _randn(gen, m, 2, h)
    mask = torch.ones(m, 2, device="cuda")
    outs = [ops.lstm_gates(g, c),
            ops.treelstm_gates(c, f, c, c, cs, mask),
            ops.lstm_level_fused(c, c, g, wh, b)]
    for out in outs:
        with pytest.raises(NotImplementedError, match="no VJP"):
            out[1].sum().backward()


def _chains_batch(fn, n, seed, dev="cuda"):
    rng = np.random.default_rng(seed)
    graphs = [chain(int(k)) for k in rng.integers(1, 12, size=n)]
    s = pack_batch(graphs, with_runs=False)
    xs = [rng.standard_normal((g.num_nodes, fn.input_dim)).astype(np.float32)
          for g in graphs]
    return s, torch.from_numpy(pack_external(xs, s, fn.input_dim)).to(dev)


def _params(fn, seed):
    gen = torch.Generator().manual_seed(seed)
    p = fn.init(gen, device="cuda")
    p["b"] = (torch.randn(p["b"].shape, generator=gen) * 0.1).cuda()
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("impl,kernel", [("pallas", "lstm_gates"),
                                         ("fused", "lstm_level_fused")])
def test_execute_none_launches_one_per_level(impl, kernel):
    _need_card()
    fn = LSTMVertex(input_dim=6, hidden=72, cell_impl=impl)
    params = _params(fn, 2)
    s, ext = _chains_batch(fn, 9, 3)
    d = s.to_device("cuda")
    with torch.no_grad():
        fused = tsch.execute(fn, params, d, ext).buf       # K3 megastep
        lm.reset_launches()
        got = tsch.execute(fn, params, d, ext, fusion_mode="none").buf
        torch.cuda.synchronize()
        assert lm.LAUNCHES == {kernel: s.T}
        assert float((got - fused).abs().max()) \
            <= TOL * float(fused.abs().max())
        bf = tsch.execute(fn, params, d, ext, fusion_mode="none",
                          dtype=torch.bfloat16).buf
        cpu = tsch.execute(fn, {k: v.cpu() for k, v in params.items()},
                           s.to_device("cpu"), ext.cpu(), fusion_mode="none",
                           dtype=torch.bfloat16).buf
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().cpu(), cpu.float(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arity", [2, 3])
def test_treelstm_execute_none_launches_one_per_level(arity):
    _need_card()
    fn = TreeLSTMVertex(input_dim=6, hidden=40, arity=arity,
                        cell_impl="pallas")
    params = _params(fn, 4)
    rng = np.random.default_rng(5)
    graphs = ([random_binary_tree(int(rng.integers(1, 12)), rng)
               for _ in range(6)] if arity == 2 else
              [random_dag(int(rng.integers(3, 14)), rng, max_arity=3)
               for _ in range(6)])
    s = pack_batch(graphs, with_runs=False)
    xs = [rng.standard_normal((g.num_nodes, 6)).astype(np.float32)
          for g in graphs]
    ext = torch.from_numpy(pack_external(xs, s, 6)).cuda()
    d = s.to_device("cuda")
    with torch.no_grad():
        fused = tsch.execute(fn, params, d, ext).buf       # K1 megastep
        lm.reset_launches()
        got = tsch.execute(fn, params, d, ext, fusion_mode="none").buf
        torch.cuda.synchronize()
    assert lm.LAUNCHES == {"treelstm_gates": s.T}
    assert float((got - fused).abs().max()) <= TOL * float(fused.abs().max())


@pytest.mark.gpu
def test_engines_on_the_op_by_op_leg_launch_the_gate_kernels():
    """``StructureServeEngine(fusion_mode="none")`` with a "pallas"
    Tree-LSTM launches one K8b per padded level, and
    ``VertexServeEngine(fusion_mode="none")`` with a "fused" LSTM one K9
    per tick; neither degrades."""
    _need_card()
    rng = np.random.default_rng(7)
    tree = TreeLSTMVertex(input_dim=6, hidden=40, cell_impl="pallas")
    tp = _params(tree, 8)
    graphs = [random_binary_tree(int(rng.integers(1, 9)), rng)
              for _ in range(10)]
    reqs = [StructureRequest(i, g, rng.standard_normal((g.num_nodes, 6))
                             .astype(np.float32))
            for i, g in enumerate(graphs)]
    eng = StructureServeEngine(tree, tp, batch_size=4, fusion_mode="none",
                               device="cuda")
    for r in reqs:
        assert eng.submit(r)
    lm.reset_launches()
    eng.run()
    levels = sum(shape[0] * n
                 for shape, n in eng.pipeline.census.counts().items())
    assert lm.LAUNCHES == {"treelstm_gates": levels}
    assert all(r.status == "ok" for r in reqs)
    assert eng.health()["degradations"] == 0

    lstm = LSTMVertex(input_dim=6, hidden=40, cell_impl="fused")
    lp = _params(lstm, 9)
    veng = VertexServeEngine(lstm, lp, num_slots=4, fusion_mode="none",
                             device="cuda")
    vreqs = [VertexRequest(i, rng.standard_normal(
        (int(rng.integers(1, 9)), 6)).astype(np.float32)) for i in range(7)]
    for r in vreqs:
        assert veng.submit(r)
    lm.reset_launches()
    veng.run()
    assert lm.LAUNCHES == {"lstm_level_fused": veng.ticks}
    assert all(r.status == "ok" for r in vreqs)
    assert veng.health()["degradations"] == 0
