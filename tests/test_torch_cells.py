"""The port's LSTM, GRU and Tree-FC cells against the JAX package: the
cells' ``apply`` and ``project_inputs`` on the same ``VertexIO`` and
JAX-initialised params; ``execute`` on both fusion legs and
``execute_lazy``'s parameter and external gradients (against
``jax.grad`` of the JAX ``execute_lazy``) over variable-length chains,
M = 1, single-level batches, padded levels and ``pad_arity=2`` trees; a
5-step AdamW loss trajectory for the paper's ``var_lstm`` and ``tree_fc``
against a JAX loop from the same init; the paper configs' graphs packing
byte-identically; the fixed-arity refusal; and ``params_from_jax``
carrying ``wh``/``wc``/``b``.  The ``cell_impl`` kernels (K8/K9) are
tested in ``tests/test_torch_cell_kernels.py``.

Every case replaces the reference init's zero bias with a seeded nonzero
draw (a zero bias hides a bias in the wrong place).  Tolerance: 1e-5 on
one cell application (the same fp32 math); 1e-4 relative (with a 1e-5
floor) on buffers and gradients, the reference's fused-vs-unfused bar
(``repro/core/scheduler.py:305``); 1e-4 absolute on the losses of the
5-step trajectories."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import paper as jpaper
from repro.core import scheduler as jsch
from repro.core import structure as jst
from repro.core.vertex import VertexIO as JVertexIO
from repro.models import rnn as jrnn
from repro.models import treelstm as jtree
from repro.optim import adamw as jadamw
from repro_torch.configs import paper as tpaper
from repro_torch.core import scheduler as tsch
from repro_torch.core import structure as tst
from repro_torch.core.vertex import VertexIO as TVertexIO
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import rnn as trnn
from repro_torch.models import treelstm as ttree
from repro_torch.optim import adamw as tadamw

TOL, FLOOR, CELL_TOL, LOSS_TOL = 1e-4, 1e-5, 1e-5, 1e-4
INPUT_DIM, HIDDEN = 5, 8
CELLS = ["lstm", "gru", "treefc"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cells(cell, x=INPUT_DIM, h=HIDDEN, arity=2):
    """The same cell in both packages."""
    if cell == "lstm":
        return jrnn.LSTMVertex(x, h), trnn.LSTMVertex(x, h)
    if cell == "gru":
        return jrnn.GRUVertex(x, h), trnn.GRUVertex(x, h)
    return (jtree.TreeFCVertex(x, h, arity=arity),
            ttree.TreeFCVertex(x, h, arity=arity))


def _params(jfn, seed, rng):
    """JAX ``init`` params with ``b`` replaced by a seeded nonzero draw, and
    the same values as torch tensors."""
    jp = jfn.init(jax.random.PRNGKey(seed))
    jp["b"] = jnp.asarray((rng.standard_normal(jp["b"].shape) * 0.3)
                          .astype(np.float32))
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=TOL,
        atol=max(FLOOR, TOL * float(np.abs(want).max(initial=0.0))),
        err_msg=what)


@pytest.mark.parametrize("cell", CELLS)
def test_apply_and_project_inputs_match_jax(cell):
    rng = np.random.default_rng(0)
    jfn, tfn = _cells(cell)
    jp, tp = _params(jfn, 0, rng)
    M, A = 9, tfn.arity
    mask = (rng.random((M, A)) > 0.3).astype(np.float32)
    child = (rng.standard_normal((M, A, tfn.state_dim)) * mask[..., None]
             ).astype(np.float32)
    raw = rng.standard_normal((M, INPUT_DIM)).astype(np.float32)
    nm = np.ones(M, np.float32)
    j_ext = jfn.project_inputs(jp, jnp.asarray(raw))
    t_ext = tfn.project_inputs(tp, torch.from_numpy(raw))
    np.testing.assert_allclose(t_ext.numpy(), np.asarray(j_ext), rtol=0,
                               atol=CELL_TOL)
    jio = JVertexIO(child_states=jnp.asarray(child),
                    child_mask=jnp.asarray(mask), external=j_ext,
                    node_mask=jnp.asarray(nm))
    tio = TVertexIO(child_states=torch.from_numpy(child),
                    child_mask=torch.from_numpy(mask), external=t_ext,
                    node_mask=torch.from_numpy(nm))
    want = jfn.apply(jp, jio).state
    got = tfn.apply(tp, tio).state
    assert got.shape == (M, tfn.state_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CELL_TOL)
    js, ts = jfn.gate_spec(), tfn.gate_spec()
    assert (ts.kind, ts.weight_names, ts.arity, ts.state_dim, ts.gate_dim) \
        == (js.kind, js.weight_names, js.arity, js.state_dim, js.gate_dim)
    assert (tfn.state_dim, tfn.ext_dim) == (jfn.state_dim, jfn.ext_dim)


@pytest.mark.parametrize("cell", CELLS)
def test_init_matches_reference_shapes_and_is_seeded(cell):
    jfn, tfn = _cells(cell)
    jp = jfn.init(jax.random.PRNGKey(0))
    tp = tfn.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} \
        == {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    assert not torch.any(tp["b"])                    # zero, as the reference
    again = tfn.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)


def test_params_from_jax_carries_wh_wc_and_b_unchanged():
    """``pack_recurrent`` only packs dicts with the Tree-LSTM's
    ``ui|uf|uo|uu``: the sequence cells' and Tree-FC's params come across
    as they are, each its own contiguous tensor."""
    rng = np.random.default_rng(1)
    for cell in CELLS:
        jfn, _ = _cells(cell)
        jp, tp = _params(jfn, 1, rng)
        assert set(tp) == set(jp)
        for k, v in jp.items():
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v))
            assert tp[k].is_contiguous() and tp[k].storage_offset() == 0
    nested = params_from_jax({"cell": {k: np.asarray(v)
                                       for k, v in jp.items()}}, "cpu")
    assert params_to_numpy(nested)["cell"].keys() == jp.keys()


def _graphs(family, seed):
    """The same graphs for both packages, and the pads to pack them at."""
    def make(m, r):
        if family == "chains":                   # variable lengths
            return [m.chain(int(n)) for n in r.integers(1, 9, size=5)]
        if family == "single":                   # M = 1, one chain
            return [m.chain(4)]
        if family == "one_level":                # T = 1
            return [m.chain(1) for _ in range(3)]
        if family == "padded":                   # bucket-padded levels
            return [m.chain(int(n)) for n in r.integers(2, 7, size=4)]
        if family == "balanced":
            return [m.balanced_binary_tree(8) for _ in range(2)]
        if family == "trees":
            return [m.random_binary_tree(int(r.integers(1, 9)), r)
                    for _ in range(4)]
        raise ValueError(family)
    pads = {"padded": {"pad_levels": 10, "pad_width": 8}}.get(family, {})
    return (make(jst, np.random.default_rng(seed)),
            make(tst, np.random.default_rng(seed)), pads)


def _setup(cell, family, seed):
    jg, tg, pads = _graphs(family, seed)
    rng = np.random.default_rng(seed + 1)
    xs = [(rng.standard_normal((g.num_nodes, INPUT_DIM)) * 0.5)
          .astype(np.float32) for g in jg]
    jfn, tfn = _cells(cell)
    if cell == "treefc":
        pads = dict(pads, pad_arity=2)
    jp, tp = _params(jfn, seed, rng)
    js = jst.pack_batch(jg, **pads)
    ts = tst.pack_batch(tg, **pads)
    ext = jst.pack_external(xs, js, INPUT_DIM)
    cot = rng.standard_normal((js.T * js.M + 1, tfn.state_dim)) \
        .astype(np.float32)
    return (jfn, jp, js.to_device(), jnp.asarray(ext),
            tfn, tp, ts.to_device("cpu"), torch.from_numpy(ext), cot)


FAMILIES = [(c, f) for c in ("lstm", "gru")
            for f in ("chains", "single", "one_level", "padded")] \
    + [("treefc", f) for f in ("balanced", "trees", "one_level")]
LEGS = ["none", "megastep"]


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("cell,family", FAMILIES)
def test_execute_matches_jax(cell, family, leg):
    jfn, jp, jd, jext, tfn, tp, td, text, _ = _setup(cell, family, 31)
    want = jsch.execute(jfn, jp, jd, jext, fusion_mode=leg).buf
    got = tsch.execute(tfn, tp, td, text, fusion_mode=leg).buf
    _close(got.detach().numpy(), want, "buf")
    _close(tsch.readout_roots(got, td).detach().numpy(),
           jsch.readout_roots(want, jd), "roots")
    assert not torch.any(got[-1])                # the sentinel stays zero


def _torch_grads(run, tp, text, cot):
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    ext = text.clone().requires_grad_()
    buf = run(leaves, ext)
    buf.backward(torch.from_numpy(cot))
    return buf.detach(), {k: v.grad for k, v in leaves.items()}, ext.grad


def _jax_grads(run, jp, jext, cot):
    def loss(p, e):
        return jnp.sum(run(p, e) * cot)
    g_p, g_e = jax.grad(loss, argnums=(0, 1))(jp, jext)
    return run(jp, jext), g_p, g_e


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("cell,family", FAMILIES)
def test_execute_lazy_grads_match_jax(cell, family, leg):
    jfn, jp, jd, jext, tfn, tp, td, text, cot = _setup(cell, family, 32)
    jbuf, jg_p, jg_e = _jax_grads(
        lambda p, e: jsch.execute_lazy(jfn, p, e, jd, fusion_mode=leg),
        jp, jext, cot)
    tbuf, tg_p, tg_e = _torch_grads(
        lambda p, e: tsch.execute_lazy(tfn, p, e, td, fusion_mode=leg),
        tp, text, cot)
    _close(tbuf.numpy(), jbuf, "buf")
    assert set(tg_p) == set(jg_p)
    for k in jg_p:
        _close(tg_p[k].numpy(), jg_p[k], k)
    _close(tg_e.numpy(), jg_e, "external")


@pytest.mark.parametrize("cell", CELLS)
def test_fused_and_opbyop_legs_agree_on_padded_buckets(cell):
    """What the training pipeline packs (pow2 pads, sorted runs), both
    legs of the port against each other."""
    family = "trees" if cell == "treefc" else "chains"
    *_, tfn, tp, _, ext, _ = _setup(cell, family, 33)
    s = tst.pack_batch(_graphs(family, 33)[1], pad_levels=16, pad_width=32,
                       with_runs=True,
                       **({"pad_arity": 2} if cell == "treefc" else {}))
    d = s.to_device("cpu")
    assert ext.shape[0] == s.K * s.N + 1        # pads move no external row
    cot = np.random.default_rng(0).standard_normal(
        (s.T * s.M + 1, tfn.state_dim)).astype(np.float32)
    fused = _torch_grads(lambda p, e: tsch.execute_lazy(tfn, p, e, d),
                         tp, ext, cot)
    plain = _torch_grads(
        lambda p, e: tsch.execute_lazy(tfn, p, e, d, fusion_mode="none"),
        tp, ext, cot)
    _close(fused[0].numpy(), plain[0].numpy(), "buf")
    for k in plain[1]:
        _close(fused[1][k].numpy(), plain[1][k].numpy(), k)
    _close(fused[2].numpy(), plain[2].numpy(), "external")


@pytest.mark.parametrize("name", ["var_lstm", "tree_fc"])
def test_five_step_loss_trajectory_matches_jax(name):
    """``mean(readout_roots(buf)[:, h] ** 2)`` (the quickstart's loss)
    through ``execute_lazy``, 5 AdamW steps, against a JAX loop from the
    same init (nonzero bias) and batch order."""
    H, X, B, steps = 8, 6, 6, 5
    jcfg, tcfg = jpaper.get_paper_model(name), tpaper.get_paper_model(name)
    jfn = jcfg.make_vertex(hidden=H, input_dim=X)
    tfn = tcfg.make_vertex(hidden=H, input_dim=X)
    rng = np.random.default_rng(7)
    jp, tp = _params(jfn, 3, rng)
    kw = {"max_len": 9} if name == "var_lstm" else {"leaves": 8}
    pads = {"pad_arity": 2} if name == "tree_fc" else {}
    h_lo = H if name == "var_lstm" else 0
    batches = []
    for step in range(steps):
        r = np.random.default_rng(100 + step)
        jg = jcfg.make_graphs(B, rng=r, **kw)
        tg = tcfg.make_graphs(B, rng=np.random.default_rng(100 + step), **kw)
        xs = [(r.standard_normal((g.num_nodes, X)) * 0.5).astype(np.float32)
              for g in jg]
        js = jst.pack_batch(jg, **pads)
        ts = tst.pack_batch(tg, with_runs=True, **pads)
        ext = jst.pack_external(xs, js, X)
        batches.append((js.to_device(), jnp.asarray(ext), ts.to_device("cpu"),
                        torch.from_numpy(ext)))
    jopt, topt = jadamw.adamw_init(jp), tadamw.adamw_init(tp)

    @jax.jit
    def j_step(params, opt, ext, dev):
        def loss_fn(p):
            buf = jsch.execute_lazy(jfn, p, ext, dev)
            return jnp.mean(jsch.readout_roots(buf, dev)[:, h_lo:] ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = jadamw.adamw_update(params, grads, opt, lr=1e-2)
        return params, opt, loss

    j_losses, t_losses = [], []
    for jd, jext, td, text in batches:
        jp, jopt, jloss = j_step(jp, jopt, jext, jd)
        leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
        buf = tsch.execute_lazy(tfn, leaves, text, td)
        loss = torch.mean(tsch.readout_roots(buf, td)[:, h_lo:] ** 2)
        loss.backward()
        tadamw.adamw_update(tp, {k: v.grad for k, v in leaves.items()},
                            topt, lr=1e-2)
        j_losses.append(float(jloss))
        t_losses.append(float(loss.detach()))
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=LOSS_TOL)
    assert t_losses[0] != t_losses[-1]
    for k, v in jp.items():                      # the bias moved too
        _close(tp[k].numpy(), v, k)


@pytest.mark.parametrize("name,kw", [
    ("fixed_lstm", {"steps": 7}), ("var_lstm", {"max_len": 30}),
    ("var_lstm", {}), ("tree_fc", {"leaves": 16})])
def test_paper_graphs_pack_identically(name, kw):
    jcfg, tcfg = jpaper.get_paper_model(name), tpaper.get_paper_model(name)
    jg = jcfg.make_graphs(12, rng=np.random.default_rng(5), **kw)
    tg = tcfg.make_graphs(12, rng=np.random.default_rng(5), **kw)
    pads = {"pad_arity": 2} if name == "tree_fc" else {}
    js = jst.pack_batch(jg, with_runs=True, **pads)
    ts = tst.pack_batch(tg, with_runs=True, **pads)
    fields = ("child_ids", "child_mask", "ext_ids", "node_mask", "slot_of",
              "node_valid", "root_slots", "num_nodes", "sort_perm",
              "sorted_child_ids", "run_head")
    for f in fields:
        a, b = getattr(js, f), getattr(ts, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (jcfg.input_dim, jcfg.hidden) == (tcfg.input_dim, tcfg.hidden)
    jfn, tfn = jcfg.make_vertex(), tcfg.make_vertex()
    assert (type(jfn).__name__, jfn.hidden, jfn.input_dim) \
        == (type(tfn).__name__, tfn.hidden, tfn.input_dim)


def test_treefc_refuses_a_schedule_of_another_arity():
    """The concat weight fixes the gather arity: ``"megastep"`` raises on
    a schedule with ``A != arity`` and ``"auto"`` keeps the op-by-op path,
    as in the reference."""
    jfn, tfn = _cells("treefc")
    g = [tst.random_binary_tree(5, np.random.default_rng(0))]
    host = tst.pack_batch(g, pad_arity=3)
    s = host.to_device("cpu")
    tp = tfn.init(torch.Generator().manual_seed(0), device="cpu")
    ext = torch.zeros((host.K * host.N + 1, INPUT_DIM))
    with pytest.raises(ValueError, match="fixed gather arity 2"):
        tsch.execute_lazy(tfn, tp, ext, s, fusion_mode="megastep")
    with pytest.raises(ValueError, match="fixed gather arity 2"):
        tsch.execute(tfn, tp, s, ext, fusion_mode="megastep")
    for mode in ("auto", "none"):
        t_spec = tsch.resolve_fusion(tfn, mode, sched_arity=3)
        j_spec = jsch.resolve_fusion(jfn, mode, sched_arity=3)
        assert t_spec is None and j_spec is None
    assert tsch.resolve_fusion(tfn, "auto", sched_arity=2).kind == "treefc"
    assert jsch.resolve_fusion(jfn, "auto", sched_arity=2).kind == "treefc"
