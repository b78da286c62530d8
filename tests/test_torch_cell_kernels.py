"""The op-by-op leg's gate kernels (K8a ``lstm_gates``, K8b
``treelstm_gates``, K9 ``lstm_level_fused``) and the cells that reach
them, against the JAX package on the CPU.

- The plain versions (``ref.lstm_gates``, ``ref.treelstm_gates``,
  ``ref.lstm_level_fused``) against the JAX Pallas kernels in interpret
  mode, at the reference tests' shapes and types
  (``tests/test_kernels.py``), plus strided and mixed-type inputs as the
  cells hand them over (the c half of a gathered ``[M, 2H]`` state, a
  bf16 buffer meeting float32 pre-activations).
- ``execute(fusion_mode="none")`` with ``cell_impl`` "pallas" and
  "fused" against JAX's (``REPRO_KERNEL_IMPL=pallas``, so JAX runs its
  Pallas kernels in interpret mode) over LSTM chains, ``tree_lstm``
  (A 2) and ``graph_rnn`` (A 3), at float32 and bf16, both packages'
  cells built from the same numpy params.
- A bf16 node buffer for all four cells under "none" and "auto".
- ``make_vertex(impl=)`` on all five paper configs.
- ``execute_serial`` against JAX's and against ``execute``'s rows.
- On the CPU a gradient through the op-by-op leg with the kernel
  ``cell_impl``s (the plain versions there) equals the "jnp" cell's.
- The ``ops`` dispatch, and the wrappers refusing CPU tensors.

Tolerances, each from the reference's own tests: 1e-5 on a float32 gate
chain (``tests/test_kernels.py:32``), 2e-5 on the Tree-LSTM gates
(``:55``) and 2e-2 / 3e-2 on bf16 outputs (``:32`` / ``:241``); 1e-4
relative (1e-5 floor) on float32 buffers, the fused-vs-unfused bar
(``repro/core/scheduler.py:305``); 3e-2 on bf16 buffers; 1e-4 on the
serial states (``tests/test_scheduler.py`` uses 2e-5 for the same
comparison within one package)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import paper as jpaper
from repro.core import scheduler as jsch
from repro.core import structure as jst
from repro.kernels import cell_kernels as jck
from repro.kernels import level_step as jls
from repro.models import rnn as jrnn
from repro.models import treelstm as jtree
from repro_torch.configs import paper as tpaper
from repro_torch.core import scheduler as tsch
from repro_torch.core import structure as tst
from repro_torch.interop import params_from_jax
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import cell_kernels as ck
from repro_torch.kernels import level_step as ls
from repro_torch.models import rnn as trnn
from repro_torch.models import treelstm as ttree
from repro_torch.obs.registry import get_registry

TOL, FLOOR, BF16_TOL = 1e-4, 1e-5, 3e-2
INPUT_DIM, HIDDEN = 5, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x, dtype=np.float32):
    return np.asarray(jnp.asarray(x, jnp.float32)).astype(dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _same(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,h", [(1, 8), (37, 50), (128, 128), (200, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_gates_plain_matches_pallas(m, h, dtype):
    rng = np.random.default_rng(m * 1000 + h)
    g = rng.standard_normal((m, 4 * h))
    c = rng.standard_normal((m, h))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    c1, h1 = jck.lstm_gates(_j(g, jd), _j(c, jd), interpret=True)
    c2, h2 = ref.lstm_gates(_t(g, td), _t(c, td))
    assert c2.dtype == h2.dtype == td and c2.shape == (m, h)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _same(c2, c1, tol, "c")
    _same(h2, h1, tol, "h")


@pytest.mark.parametrize("gates_dtype,state_dtype",
                         [("float32", "bfloat16"), ("bfloat16", "float32")])
def test_lstm_gates_strided_mixed_types(gates_dtype, state_dtype):
    """``c_prev`` the c half of a ``[M, 2H]`` state at another type than
    ``gates``: the outputs come back at ``gates.dtype``, as the Pallas
    kernel's do."""
    rng = np.random.default_rng(3)
    m, h = 33, 24
    g = rng.standard_normal((m, 4 * h))
    state = rng.standard_normal((m, 2 * h))
    gd, sd = getattr(jnp, gates_dtype), getattr(jnp, state_dtype)
    c1, h1 = jck.lstm_gates(_j(g, gd), _j(state, sd)[:, :h], interpret=True)
    tstate = _t(state, getattr(torch, state_dtype))
    c2, h2 = ref.lstm_gates(_t(g, getattr(torch, gates_dtype)),
                            tstate[:, :h])
    assert c2.dtype == getattr(torch, gates_dtype)
    tol = 1e-5 if gates_dtype == "float32" else 2e-2
    _same(c2, c1, tol, "c")
    _same(h2, h1, tol, "h")


def _tree_gate_inputs(m, a, h, seed):
    rng = np.random.default_rng(seed)
    i, o, u = (rng.standard_normal((m, h)) for _ in range(3))
    f = rng.standard_normal((m, a, h))
    cs = rng.standard_normal((m, a, 2 * h))        # [c | h] child states
    mask = (rng.random((m, a)) > 0.3).astype(np.float32)
    return i, f, o, u, cs, mask


@pytest.mark.parametrize("m,a,h", [(5, 2, 16), (64, 3, 40), (130, 2, 128),
                                   (7, 1, 24)])
def test_treelstm_gates_plain_matches_pallas(m, a, h):
    i, f, o, u, cs, mask = _tree_gate_inputs(m, a, h, m + a + h)
    ck_ = cs[..., :h]
    c1, h1 = jck.treelstm_gates(*(_j(x) for x in (i, f, o, u, ck_, mask)),
                                interpret=True)
    c2, h2 = ref.treelstm_gates(*(_t(x) for x in (i, f, o, u, ck_, mask)))
    _same(c2, c1, 2e-5, "c")
    _same(h2, h1, 2e-5, "h")


def test_treelstm_gates_strided_bf16_children():
    """``c_k`` the c half of bf16 ``[M, A, 2H]`` child states and a bf16
    mask, float32 pre-activations: outputs at float32, the math in
    float32 on both sides."""
    m, a, h = 19, 3, 16
    i, f, o, u, cs, mask = _tree_gate_inputs(m, a, h, 5)
    jcs, tcs = _j(cs, jnp.bfloat16), _t(cs, torch.bfloat16)
    c1, h1 = jck.treelstm_gates(_j(i), _j(f), _j(o), _j(u), jcs[..., :h],
                                _j(mask, jnp.bfloat16), interpret=True)
    c2, h2 = ref.treelstm_gates(_t(i), _t(f), _t(o), _t(u), tcs[..., :h],
                                _t(mask, torch.bfloat16))
    assert c2.dtype == torch.float32
    _same(c2, c1, 1e-5, "c")
    _same(h2, h1, 1e-5, "h")


@pytest.mark.parametrize("m,h", [(3, 16), (64, 64), (130, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_level_fused_plain_matches_pallas(m, h, dtype):
    rng = np.random.default_rng(m + h)
    hp, cp = rng.standard_normal((m, h)), rng.standard_normal((m, h))
    ext = rng.standard_normal((m, 4 * h))
    wh = rng.standard_normal((h, 4 * h)) * 0.2
    b = rng.standard_normal(4 * h)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    c1, h1 = jls.lstm_level_fused(*(_j(x, jd) for x in (hp, cp, ext, wh, b)),
                                  block_m=32, interpret=True)
    c2, h2 = ref.lstm_level_fused(*(_t(x, td) for x in (hp, cp, ext, wh, b)))
    assert c2.dtype == h2.dtype == td
    tol = 1e-5 if dtype == "float32" else 3e-2
    _same(c2, c1, tol, "c")
    _same(h2, h1, tol, "h")


def test_lstm_level_fused_strided_bf16_state():
    """The main path's mix: ``h_prev``/``c_prev`` the halves of a bf16
    ``[M, 2H]`` state, float32 ``ext``/``W_h``/``b``; outputs at bf16."""
    rng = np.random.default_rng(11)
    m, h = 21, 24
    state = rng.standard_normal((m, 2 * h))
    ext = rng.standard_normal((m, 4 * h))
    wh = rng.standard_normal((h, 4 * h)) * h ** -0.5
    b = rng.standard_normal(4 * h) * 0.3
    js, ts = _j(state, jnp.bfloat16), _t(state, torch.bfloat16)
    c1, h1 = jls.lstm_level_fused(js[:, h:], js[:, :h], _j(ext), _j(wh),
                                  _j(b), interpret=True)
    c2, h2 = ref.lstm_level_fused(ts[:, h:], ts[:, :h], _t(ext), _t(wh),
                                  _t(b))
    assert c2.dtype == torch.bfloat16
    _same(c2, c1, BF16_TOL, "c")
    _same(h2, h1, BF16_TOL, "h")


# ---------------------------------------------------------------------------
# The cells through execute(fusion_mode="none")
# ---------------------------------------------------------------------------

def _graphs(family, seed):
    def make(mod, r):
        if family == "chains":
            return [mod.chain(int(n)) for n in r.integers(1, 8, size=4)]
        if family == "trees":
            return [mod.random_binary_tree(int(r.integers(1, 9)), r)
                    for _ in range(4)]
        if family == "dags":
            return [mod.random_dag(int(r.integers(3, 9)), r, max_arity=3)
                    for _ in range(3)]
        raise ValueError(family)
    return (make(jst, np.random.default_rng(seed)),
            make(tst, np.random.default_rng(seed)))


def _cells(cell, impl):
    """The same cell in both packages, and the graphs it runs on."""
    if cell == "lstm":
        return (jrnn.LSTMVertex(INPUT_DIM, HIDDEN, cell_impl=impl),
                trnn.LSTMVertex(INPUT_DIM, HIDDEN, cell_impl=impl),
                "chains", {})
    if cell == "gru":
        return (jrnn.GRUVertex(INPUT_DIM, HIDDEN),
                trnn.GRUVertex(INPUT_DIM, HIDDEN), "chains", {})
    if cell == "treefc":
        return (jtree.TreeFCVertex(INPUT_DIM, HIDDEN),
                ttree.TreeFCVertex(INPUT_DIM, HIDDEN), "trees",
                {"pad_arity": 2})
    arity = 3 if cell == "graph_rnn" else 2
    return (jtree.TreeLSTMVertex(INPUT_DIM, HIDDEN, arity=arity,
                                 cell_impl=impl),
            ttree.TreeLSTMVertex(INPUT_DIM, HIDDEN, arity=arity,
                                 cell_impl=impl),
            "dags" if cell == "graph_rnn" else "trees", {})


def _setup(cell, impl, seed):
    """Both packages' cell, params (the JAX init with a seeded nonzero
    bias, carried across as numpy), schedule and packed inputs."""
    jfn, tfn, family, pads = _cells(cell, impl)
    jg, tg = _graphs(family, seed)
    rng = np.random.default_rng(seed + 1)
    xs = [(rng.standard_normal((g.num_nodes, INPUT_DIM)) * 0.5)
          .astype(np.float32) for g in jg]
    jp = jfn.init(jax.random.PRNGKey(seed))
    jp["b"] = jnp.asarray((rng.standard_normal(jp["b"].shape) * 0.3)
                          .astype(np.float32))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    js = jst.pack_batch(jg, **pads)
    ts = tst.pack_batch(tg, **pads)
    ext = jst.pack_external(xs, js, INPUT_DIM)
    return (jfn, jp, js.to_device(), jnp.asarray(ext), tfn, tp,
            ts.to_device("cpu"), torch.from_numpy(ext), jg, tg, xs)


def _close_buf(got, want, tol, what):
    want = _np(want)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=tol,
        atol=max(FLOOR, tol * float(np.abs(want).max(initial=0.0))),
        err_msg=what)


KERNEL_CELLS = [("lstm", "pallas"), ("lstm", "fused"),
                ("tree_lstm", "pallas"), ("graph_rnn", "pallas")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell,impl", KERNEL_CELLS)
def test_execute_none_with_kernel_cells_matches_jax(cell, impl, dtype,
                                                    monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "pallas")   # JAX: Pallas kernels
    jfn, jp, jd, jext, tfn, tp, td, text, *_ = _setup(cell, impl, 7)
    want = jsch.execute(jfn, jp, jd, jext, fusion_mode="none",
                        dtype=getattr(jnp, dtype)).buf
    reg = get_registry()
    reg.reset()
    got = tsch.execute(tfn, tp, td, text, fusion_mode="none",
                       dtype=getattr(torch, dtype)).buf
    assert got.dtype == getattr(torch, dtype)
    op = {"pallas": "treelstm_gates" if cell != "lstm" else "lstm_gates",
          "fused": "lstm_level_fused"}[impl]
    assert reg.counter("kernel.dispatch", op=op, impl="ref") == td.T
    _close_buf(got, want, TOL if dtype == "float32" else BF16_TOL, "buf")


@pytest.mark.parametrize("mode", ["none", "auto"])
@pytest.mark.parametrize("cell", ["lstm", "gru", "tree_lstm", "treefc"])
def test_execute_bf16_buffer_matches_jax(cell, mode):
    """A bf16 node buffer takes the op-by-op leg under "auto" too (the
    fused buffer is float32); float32 params meet bf16 child states as in
    JAX: the masked states and their sum in bf16, each product promoted."""
    jfn, jp, jd, jext, tfn, tp, td, text, *_ = _setup(cell, "jnp", 13)
    want = jsch.execute(jfn, jp, jd, jext, fusion_mode=mode,
                        dtype=jnp.bfloat16).buf
    got = tsch.execute(tfn, tp, td, text, fusion_mode=mode,
                       dtype=torch.bfloat16).buf
    assert got.dtype == torch.bfloat16
    _close_buf(got, want, BF16_TOL, "buf")


def test_pallas_tree_lstm_takes_packed_views_on_both_legs():
    """``ui|uf|uo|uu`` come across as views of one packed ``[H, 4H]``
    tensor: the op-by-op leg's products read the views, the fused leg's
    megastep the tensor behind them, with the same result."""
    *_, tfn, tp, td, text, _jg, _tg, _xs = _setup("tree_lstm", "pallas", 3)
    assert tp["uf"].storage_offset() == tp["ui"].storage_offset() + HIDDEN
    none = tsch.execute(tfn, tp, td, text, fusion_mode="none").buf
    fused = tsch.execute(tfn, tp, td, text, fusion_mode="megastep").buf
    _close_buf(none, fused.numpy(), TOL, "buf")


@pytest.mark.parametrize("name", sorted(tpaper.PAPER_MODELS))
def test_make_vertex_takes_impl_on_every_paper_config(name):
    jcfg, tcfg = jpaper.get_paper_model(name), tpaper.get_paper_model(name)
    for impl in ("jnp", "pallas"):
        jfn = jcfg.make_vertex(hidden=8, input_dim=4, impl=impl)
        tfn = tcfg.make_vertex(hidden=8, input_dim=4, impl=impl)
        assert type(tfn).__name__ == type(jfn).__name__
        assert getattr(tfn, "cell_impl", None) \
            == getattr(jfn, "cell_impl", None)
        assert (tfn.arity, tfn.state_dim) == (jfn.arity, jfn.state_dim)
    assert getattr(tcfg.make_vertex(hidden=8, input_dim=4), "cell_impl",
                   "jnp") == "jnp"


@pytest.mark.parametrize("cell,impl", [("lstm", "pallas"), ("lstm", "fused"),
                                       ("tree_lstm", "pallas"),
                                       ("graph_rnn", "jnp"),
                                       ("treefc", "jnp")])
def test_execute_serial_matches_jax_and_execute(cell, impl):
    jfn, jp, jd, jext, tfn, tp, td, text, jg, tg, xs = _setup(cell, impl, 5)
    want = jsch.execute_serial(jfn, jp, jg, xs)
    got = tsch.execute_serial(tfn, tp, tg, xs)
    nodes = tsch.readout_nodes(
        tsch.execute(tfn, tp, td, text, fusion_mode="none").buf, td).numpy()
    assert len(got) == len(tg)
    for k, g in enumerate(tg):
        assert got[k].shape == (g.num_nodes, tfn.state_dim)
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[k], nodes[k, :g.num_nodes], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("cell,impl", [("lstm", "pallas"), ("lstm", "fused"),
                                       ("tree_lstm", "pallas"),
                                       ("graph_rnn", "pallas")])
def test_kernel_cells_differentiate_like_jnp_on_cpu(cell, impl):
    """On the CPU the kernel ``cell_impl``s run the plain versions, which
    autograd differentiates: ``execute_lazy``'s op-by-op leg gives the
    "jnp" cell's gradients (1e-4 relative)."""
    *_, tfn, tp, td, text, _jg, _tg, _xs = _setup(cell, impl, 9)
    base = _cells(cell, "jnp")[1]
    grads = []
    for fn in (tfn, base):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in tp.items()}
        e = text.clone().requires_grad_()
        buf = tsch.execute_lazy(fn, leaves, e, td, fusion_mode="none")
        (tsch.readout_roots(buf, td) ** 2).sum().backward()
        grads.append({**{k: v.grad for k, v in leaves.items()},
                      "external": e.grad})
    for k in grads[1]:
        _close_buf(grads[0][k], grads[1][k].numpy(), TOL, k)


# ---------------------------------------------------------------------------
# Dispatch and refusals
# ---------------------------------------------------------------------------

def test_ops_dispatch_by_device_and_wrappers_refuse_cpu():
    rng = np.random.default_rng(0)
    m, a, h = 4, 2, 8
    gates, c = _t(rng.standard_normal((m, 4 * h))), _t(rng.random((m, h)))
    i, f, o, u, cs, mask = (_t(x) for x in _tree_gate_inputs(m, a, h, 1))
    wh = _t(rng.standard_normal((h, 4 * h)))
    reg = get_registry()
    reg.reset()
    got = ops.lstm_gates(gates, c)
    want = ref.lstm_gates(gates, c)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    ops.treelstm_gates(i, f, o, u, cs[..., :h], mask)
    ops.lstm_level_fused(c, c, gates, wh, gates[0])
    for op in ("lstm_gates", "treelstm_gates", "lstm_level_fused"):
        assert reg.counter("kernel.dispatch", op=op, impl="ref") == 1
    with pytest.raises(ValueError, match="CUDA"):
        ck.lstm_gates(gates, c)
    with pytest.raises(ValueError, match="CUDA"):
        ck.treelstm_gates(i, f, o, u, cs[..., :h], mask)
    with pytest.raises(ValueError, match="CUDA"):
        ls.lstm_level_fused(c, c, gates, wh, gates[0])


def test_build_table_holds_the_gate_kernels():
    """K8a and K8b share one source; K9 shares K3's (whose product and
    epilogue it runs), and every one is built with the others from the
    checkout."""
    assert _build.KERNELS["lstm_gates"][0] \
        == _build.KERNELS["treelstm_gates"][0] == "cell_gates.cu"
    assert _build.KERNELS["lstm_level_fused"][0] \
        == _build.KERNELS["lstm_megastep"][0] == "cell_megastep_sm90.cu"
    for name in ("lstm_gates", "treelstm_gates", "lstm_level_fused"):
        src, entry, argtypes = _build.KERNELS[name]
        text = (_build._CSRC / src).read_text()
        assert f'extern "C" int {entry}(' in text
        assert argtypes[-1] is _build._P                  # the stream
    assert "gathered_product.cuh" in (_build._CSRC / "cell_megastep_sm90.cu"
                                      ).read_text()
