"""Training with the port against the JAX package: ``execute_lazy``'s
parameter and external gradients on both fusion legs (against
``jax.grad`` of the JAX ``execute_lazy``), AdamW and the warmup-cosine
schedule, and a 5-step loss trajectory of
``examples/torch_treelstm_sentiment.train_step`` against a JAX loop that
mirrors the reference's ``train_step``, from the same NumPy-carried init
and batch order.

Tolerance: 1e-4 relative (with a 1e-5 floor) on buffers and gradients,
the reference's fused-vs-unfused bar (``repro/core/scheduler.py:305``);
1e-4 absolute on the losses of the 5-step trajectory."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import scheduler as jsch
from repro.core import structure as jst
from repro.data import trees as jtrees
from repro.models.treelstm import TreeLSTMVertex as JTreeLSTM
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.core import scheduler as tsch
from repro_torch.core import structure as tst
from repro_torch.data import trees as ttrees
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.kernels import level_megastep as lm
from repro_torch.models.treelstm import TreeLSTMVertex as TTreeLSTM
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule
from repro_torch.pipeline import BucketPolicy, SchedulePipeline

TOL, FLOOR, LOSS_TOL = 1e-4, 1e-5, 1e-4
INPUT_DIM, HIDDEN = 5, 8
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _example():
    path = ROOT / "examples" / "torch_treelstm_sentiment.py"
    spec = importlib.util.spec_from_file_location("torch_treelstm_sentiment",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graphs(kind, seed):
    """The same graphs for both packages."""
    def make(m, r):
        if kind == "trees":
            return [m.random_binary_tree(int(r.integers(1, 10)), r)
                    for _ in range(5)]
        if kind == "dags":                       # shared children, A=3
            return [m.random_dag(int(r.integers(2, 12)), r, max_arity=3)
                    for _ in range(4)]
        if kind == "single_leaf":                # M=1, one level
            return [m.random_binary_tree(1, r)]
        if kind == "chain":                      # singleton levels
            return [m.chain(6)]
        raise ValueError(kind)
    return (make(jst, np.random.default_rng(seed)),
            make(tst, np.random.default_rng(seed)))


def _setup(kind, seed, **pads):
    jg, tg = _graphs(kind, seed)
    rng = np.random.default_rng(seed + 1)
    xs = [(rng.standard_normal((g.num_nodes, INPUT_DIM)) * 0.5)
          .astype(np.float32) for g in jg]
    A = max(max(g.max_arity for g in jg), 1)
    jfn = JTreeLSTM(input_dim=INPUT_DIM, hidden=HIDDEN, arity=A)
    tfn = TTreeLSTM(input_dim=INPUT_DIM, hidden=HIDDEN, arity=A)
    jp = jfn.init(jax.random.PRNGKey(seed))
    jp["b"] = jnp.asarray((rng.standard_normal(4 * HIDDEN) * 0.1)
                          .astype(np.float32))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    js = jst.pack_batch(jg, **pads)
    ts = tst.pack_batch(tg, **pads)
    ext = jst.pack_external(xs, js, INPUT_DIM)
    cot = rng.standard_normal((js.T * js.M + 1, 2 * HIDDEN)) \
        .astype(np.float32)
    return (jfn, jp, js.to_device(), jnp.asarray(ext),
            tfn, tp, ts.to_device("cpu"), torch.from_numpy(ext), cot)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=TOL,
        atol=max(FLOOR, TOL * float(np.abs(want).max(initial=0.0))),
        err_msg=what)


def _torch_grads(run, tp, text, cot):
    """``run(params, external) -> buf``; gradients of ``sum(buf * cot)``
    w.r.t. every param and the external matrix."""
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    ext = text.clone().requires_grad_()
    buf = run(leaves, ext)
    g_buf = torch.from_numpy(cot)
    buf.backward(g_buf)
    # The fused backward sweeps a copy: the cotangent handed in is intact.
    np.testing.assert_array_equal(g_buf.numpy(), cot)
    return buf.detach(), {k: v.grad for k, v in leaves.items()}, ext.grad


def _jax_grads(run, jp, jext, cot):
    def loss(p, e):
        return jnp.sum(run(p, e) * cot)
    buf = run(jp, jext)
    g_p, g_e = jax.grad(loss, argnums=(0, 1))(jp, jext)
    return buf, g_p, g_e


LEGS = ["none", "megastep"]
KINDS = ["trees", "dags", "single_leaf", "chain"]


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("kind", KINDS)
def test_execute_lazy_grads_match_jax(kind, leg):
    jfn, jp, jd, jext, tfn, tp, td, text, cot = _setup(kind, 21)
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


@pytest.mark.parametrize("kind", ["trees", "dags"])
def test_execute_lazy_padded_schedule_grads_match_jax(kind):
    """Bucket-padded levels and slots (what the training pipeline packs)
    on the fused leg."""
    jfn, jp, jd, jext, tfn, tp, td, text, cot = _setup(
        kind, 22, pad_levels=16, pad_width=32)
    _, jg_p, jg_e = _jax_grads(
        lambda p, e: jsch.execute_lazy(jfn, p, e, jd), jp, jext, cot)
    _, tg_p, tg_e = _torch_grads(
        lambda p, e: tsch.execute_lazy(tfn, p, e, td), tp, text, cot)
    for k in jg_p:
        _close(tg_p[k].numpy(), jg_p[k], k)
    _close(tg_e.numpy(), jg_e, "external")


def test_execute_fused_leg_is_differentiable():
    """``execute``'s fused leg goes through the same fused autograd
    function, so its gradients are the JAX ``execute``'s."""
    jfn, jp, jd, jext, tfn, tp, td, text, cot = _setup("trees", 23)
    _, jg_p, jg_e = _jax_grads(
        lambda p, e: jsch.execute(jfn, p, jd, e, fusion_mode="megastep").buf,
        jp, jext, cot)
    _, tg_p, tg_e = _torch_grads(
        lambda p, e: tsch.execute(tfn, p, td, e, fusion_mode="megastep").buf,
        tp, text, cot)
    for k in jg_p:
        _close(tg_p[k].numpy(), jg_p[k], k)
    _close(tg_e.numpy(), jg_e, "external")


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    params = {"cell": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "b": rng.standard_normal(3).astype(np.float32)},
              "head": rng.standard_normal((3, 2)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * s)
                          .astype(np.float32), params)
             for s in (0.3, 2.0, 0.05)]          # the middle one is clipped
    return params, grads


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_matches_jax(weight_decay):
    params, grads = _opt_case(3)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadamw.adamw_init(jp)
    tp = params_from_jax(params, "cpu")
    topt = tadamw.adamw_init(tp)
    before = {k: v.data_ptr() for k, v in tp["cell"].items()}
    for step, g in enumerate(grads):
        lr = 1e-2 * (step + 1)
        jp, jopt, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                           jopt, lr=lr,
                                           weight_decay=weight_decay)
        out, topt, tm = tadamw.adamw_update(tp, params_from_jax(g, "cpu"),
                                            topt, lr=lr,
                                            weight_decay=weight_decay)
        assert out is tp                            # updated in place
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]), "grad_norm")
    assert topt.step == int(jopt.step) == 3
    got = params_to_numpy(tp)
    jax.tree.map(lambda w, g: _close(g, w, "param"), jp, got)
    jax.tree.map(lambda w, g: _close(g, w, "mu"), jopt.mu,
                 params_to_numpy(topt.mu))
    jax.tree.map(lambda w, g: _close(g, w, "nu"), jopt.nu,
                 params_to_numpy(topt.nu))
    assert {k: v.data_ptr() for k, v in tp["cell"].items()} == before


def test_schedules_match_jax():
    pairs = [(jschedule.warmup_cosine(3e-3, 20, 150),
              tschedule.warmup_cosine(3e-3, 20, 150)),
             (jschedule.constant(1e-3), tschedule.constant(1e-3)),
             (jschedule.linear_warmup(1e-3, 10),
              tschedule.linear_warmup(1e-3, 10)),
             (jschedule.cosine_decay(1e-3, 100),
              tschedule.cosine_decay(1e-3, 100))]
    for jf, tf in pairs:
        for step in (0, 1, 5, 19, 20, 21, 80, 149, 150, 400):
            assert tf(step) == pytest.approx(float(jf(step)), rel=1e-6,
                                             abs=1e-12)


def test_clip_by_global_norm_matches_jax():
    _, grads = _opt_case(4)
    g = grads[1]
    jclipped, jnorm = jadamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    tclipped, tnorm = tadamw.clip_by_global_norm(params_from_jax(g, "cpu"),
                                                 1.0)
    _close(float(tnorm), float(jnorm), "norm")
    jax.tree.map(lambda w, t: _close(t, w, "clipped"), jclipped,
                 params_to_numpy(tclipped))


def test_five_step_loss_trajectory_matches_jax():
    """The example's ``train_step`` against a JAX loop mirroring the
    reference's, from the same init (carried as NumPy) and the same FIFO
    batch order; batches packed at the same pow2 pads in both."""
    ex = _example()
    H, X, B, steps = 8, 6, 8, 5
    ds_j = jtrees.sst_like_dataset(48, input_dim=X, seed=0)
    ds_t = ttrees.sst_like_dataset(48, input_dim=X, seed=0)
    jfn = JTreeLSTM(input_dim=X, hidden=H, arity=2)
    tfn = TTreeLSTM(input_dim=X, hidden=H, arity=2)
    jp = {"cell": jfn.init(jax.random.PRNGKey(0)),
          "head": jax.random.normal(jax.random.PRNGKey(1), (H, 2)) * 0.1}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jopt, topt = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    jlr = jschedule.warmup_cosine(3e-3, 20, steps)
    tlr = tschedule.warmup_cosine(3e-3, 20, steps)

    @jax.jit
    def j_train_step(params, opt, ext, labels, dev):
        def loss_fn(p):
            buf = jsch.execute_lazy(jfn, p["cell"], ext, dev)
            root_h = jsch.readout_roots(buf, dev)[:, H:]
            logits = root_h @ p["head"]
            lse = jax.scipy.special.logsumexp(logits, -1)
            nll = lse - jnp.take_along_axis(logits, labels[:, None], 1)[:, 0]
            return jnp.mean(nll)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = jadamw.adamw_update(params, grads, opt,
                                             lr=jlr(opt.step),
                                             weight_decay=0.0)
        return params, opt, loss

    pipe = SchedulePipeline(X, bucket_policy=BucketPolicy(mode="pow2"),
                            with_runs=True, device="cpu")
    jb = ex.fifo_batches(ds_j, B, np.random.default_rng(0))
    tb = ex.fifo_batches(ds_t, B, np.random.default_rng(0))
    j_losses, t_losses = [], []
    for _ in range(steps):
        (jgraphs, jinputs, jlabels), (tgraphs, tinputs, tlabels) = \
            next(jb), next(tb)
        np.testing.assert_array_equal(jlabels, tlabels)
        b = pipe.pack(tgraphs, tinputs)
        s = b.sched
        js = jst.pack_batch(jgraphs, pad_levels=s.T, pad_width=s.M,
                            pad_arity=s.A, pad_nodes=s.N)
        jext = jnp.asarray(jst.pack_external(jinputs, js, X))
        jp, jopt, jloss = j_train_step(jp, jopt, jext, jnp.asarray(jlabels),
                                       js.to_device())
        loss, acc = ex.train_step(tfn, tp, topt, b,
                                  torch.from_numpy(tlabels.astype(np.int64)),
                                  tlr(topt.step))
        j_losses.append(float(jloss))
        t_losses.append(float(loss))
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=LOSS_TOL)
    assert t_losses[0] != t_losses[-1]


def test_packed_views_survive_an_optimizer_step():
    """The recurrent weights stay adjacent column views of one packed
    tensor through a training step, so the fused kernels still take
    them; their values move."""
    ex = _example()
    fn = TTreeLSTM(input_dim=4, hidden=6, arity=2)
    params = ex.init_params(fn, 0, "cpu")
    opt = tadamw.adamw_init(params)
    cell = params["cell"]
    views = [cell[k] for k in ("ui", "uf", "uo", "uu")]
    packed = lm.packed_recurrent(*views)
    before = packed.clone()
    ds = ttrees.sst_like_dataset(8, input_dim=4, seed=1)
    pipe = SchedulePipeline(4, bucket_policy=BucketPolicy(mode="pow2"),
                            device="cpu")
    graphs, inputs, labels = next(ex.fifo_batches(
        ds, 4, np.random.default_rng(0)))
    ex.train_step(fn, params, opt, pipe.pack(graphs, inputs),
                  torch.from_numpy(labels.astype(np.int64)), 1e-2)
    after = lm.packed_recurrent(*(cell[k] for k in ("ui", "uf", "uo", "uu")))
    assert after.data_ptr() == packed.data_ptr()
    assert all(cell[k] is v for k, v in zip(("ui", "uf", "uo", "uu"), views))
    assert not torch.equal(after, before)


def test_example_main_trains_on_cpu():
    losses = _example().main(["--device", "cpu", "--hidden", "8",
                              "--input-dim", "4", "--batch", "4",
                              "--steps", "3", "--no-compose"])
    assert len(losses) == 3 and np.isfinite(losses).all()
