"""The port's readout heads (``repro_torch.models.readout``) against the
JAX package's: logits, log-probs, probabilities, predictions, losses and
gradients (autograd against ``jax.grad``) of the classification and
regression heads; the stable batched softmax at large logits; the token
readout teacher-forced on the JAX run's sampled tokens (every step's
logits and state); the port's own sampling contract; ``apply_unbatched``
and ``LambdaVertex``; ``params_from_jax`` carrying head params.

Tolerances: heads 1e-5 (one small fp32 product, another summation
order); a teacher-forced generation step 1e-4 (a cell step and a
product, compounding over the steps)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import vertex as jvertex
from repro.models import readout as jro
from repro.models import rnn as jrnn
from repro_torch.core import vertex as tvertex
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import readout as tro
from repro_torch.models.rnn import GRUVertex, LSTMVertex
from repro_torch.models.treelstm import TreeLSTMVertex

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _nonzero_bias(p, seed):
    p = dict(p)
    p["b"] = (np.random.default_rng(seed).standard_normal(p["b"].shape)
              * 0.3).astype(np.float32)
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_classification_head_matches_jax(seed):
    jh = jro.ClassificationHead(state_dim=6, num_classes=4)
    p = _nonzero_bias(_np(jh.init(jax.random.PRNGKey(seed))), seed)
    rng = np.random.default_rng(seed)
    roots = rng.standard_normal((5, 6)).astype(np.float32)
    labels = rng.integers(0, 4, 5).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jr, jl = jnp.asarray(roots), jnp.asarray(labels)
    th = tro.ClassificationHead(state_dim=6, num_classes=4)
    tp = {k: v.requires_grad_() for k, v in params_from_jax(p, "cpu")
          .items()}
    tr, tl = torch.from_numpy(roots), torch.from_numpy(labels)
    for name in ("logits", "log_probs", "probs"):
        np.testing.assert_allclose(
            getattr(th, name)(tp, tr).detach().numpy(),
            np.asarray(getattr(jh, name)(jp, jr)), rtol=0, atol=TOL)
    assert np.array_equal(th.predict(tp, tr).numpy(),
                          np.asarray(jh.predict(jp, jr)))
    loss = th.loss(tp, tr, tl)
    np.testing.assert_allclose(loss.item(), float(jh.loss(jp, jr, jl)),
                               rtol=0, atol=TOL)
    loss.backward()
    jg = jax.grad(lambda q: jh.loss(q, jr, jl))(jp)
    for k in ("w", "b"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=0, atol=TOL)
    # The roots' gradient too (the head sits on top of the cell).
    tr2 = tr.clone().requires_grad_()
    th.loss({k: v.detach() for k, v in tp.items()}, tr2, tl).backward()
    jgr = jax.grad(lambda r: jh.loss(jp, r, jl))(jr)
    np.testing.assert_allclose(tr2.grad.numpy(), np.asarray(jgr), rtol=0,
                               atol=TOL)


def test_regression_head_matches_jax():
    jh = jro.RegressionHead(state_dim=5, out_dim=2)
    p = _nonzero_bias(_np(jh.init(jax.random.PRNGKey(1))), 1)
    rng = np.random.default_rng(1)
    roots = rng.standard_normal((7, 5)).astype(np.float32)
    targets = rng.standard_normal((7, 2)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    th = tro.RegressionHead(state_dim=5, out_dim=2)
    tp = {k: v.requires_grad_() for k, v in params_from_jax(p, "cpu")
          .items()}
    tr, tt = torch.from_numpy(roots), torch.from_numpy(targets)
    np.testing.assert_allclose(
        th.predict(tp, tr).detach().numpy(),
        np.asarray(jh.predict(jp, jnp.asarray(roots))), rtol=0, atol=TOL)
    loss = th.loss(tp, tr, tt)
    want = jh.loss(jp, jnp.asarray(roots), jnp.asarray(targets))
    np.testing.assert_allclose(loss.item(), float(want), rtol=0, atol=TOL)
    loss.backward()
    jg = jax.grad(lambda q: jh.loss(q, jnp.asarray(roots),
                                    jnp.asarray(targets)))(jp)
    for k in ("w", "b"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=0, atol=TOL)


def test_heads_init_shapes_and_device():
    g = torch.Generator().manual_seed(0)
    ch = tro.ClassificationHead(8, 3).init(g, device="cpu")
    assert ch["w"].shape == (8, 3) and not ch["b"].any()
    rh = tro.RegressionHead(8).init(g, device="cpu")
    assert rh["w"].shape == (8, 1)
    tp = tro.TokenReadout(LSTMVertex(5, 4), vocab=11).init(g, device="cpu")
    assert tp["w"].shape == (8, 11) and tp["embed"].shape == (11, 5)
    assert tp["w"].device.type == "cpu"


@pytest.mark.parametrize("scale", [1e4, 3e4, -1e4])
def test_batched_softmax_stable_at_large_logits(scale):
    """Naive softmax overflows exp() around logits ~88; the max-subtracted
    one stays finite and normalised far past that, and matches JAX's."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((4, 6)) + scale).astype(np.float32)
    p = tro.batched_softmax(torch.from_numpy(logits)).numpy()
    lp = tro.batched_log_softmax(torch.from_numpy(logits)).numpy()
    assert np.isfinite(p).all() and np.isfinite(lp).all()
    np.testing.assert_allclose(p.sum(axis=-1), np.ones(4), rtol=1e-5)
    assert (lp <= 0).all()
    np.testing.assert_allclose(
        p, np.asarray(jro.batched_softmax(jnp.asarray(logits))), rtol=0,
        atol=TOL)
    np.testing.assert_allclose(
        lp, np.asarray(jro.batched_log_softmax(jnp.asarray(logits))),
        rtol=0, atol=TOL)
    if scale > 0:
        assert not torch.isfinite(torch.exp(torch.from_numpy(logits))).all()


def test_batched_softmax_mixed_extreme_rows_and_gradient():
    logits = torch.tensor([[1e4, -1e4, 0.0], [88.0, 89.0, 90.0],
                           [0.1, 0.2, 0.3]], requires_grad=True)
    p = tro.batched_softmax(logits)
    assert torch.isfinite(p).all() and p[0, 0] > 0.999
    torch.testing.assert_close(p.sum(-1), torch.ones(3))
    tro.batched_log_softmax(logits)[:, 0].sum().backward()
    assert torch.isfinite(logits.grad).all()


# ---------------------------------------------------------------------------
# Token readout
# ---------------------------------------------------------------------------

def _token_pair(cell_cls, jcell_cls, seed):
    jcell = jcell_cls(input_dim=5, hidden=4)
    cp = _nonzero_bias(_np(jcell.init(jax.random.PRNGKey(seed))), seed)
    jtr = jro.TokenReadout(jcell, vocab=17)
    hp = _np(jtr.init(jax.random.PRNGKey(seed + 1)))
    hp["b"] = np.linspace(-0.5, 0.5, 17).astype(np.float32)
    ttr = tro.TokenReadout(cell_cls(input_dim=5, hidden=4), vocab=17)
    return jtr, cp, hp, ttr


@pytest.mark.parametrize("cells", [(LSTMVertex, jrnn.LSTMVertex),
                                   (GRUVertex, jrnn.GRUVertex)])
def test_teacher_forced_steps_match_jax(cells):
    """Feed the JAX run's sampled tokens into the port's step: every
    step's logits and next state within 1e-4 of the JAX step's."""
    jtr, cp, hp, ttr = _token_pair(*cells, seed=2)
    jcp = {k: jnp.asarray(v) for k, v in cp.items()}
    jhp = {k: jnp.asarray(v) for k, v in hp.items()}
    tcp, thp = params_from_jax(cp, "cpu"), params_from_jax(hp, "cpu")
    rng = np.random.default_rng(3)
    state0 = rng.standard_normal(jtr.cell.state_dim).astype(np.float32)
    key = jax.random.PRNGKey(11)
    toks = jtr.generate(jhp, jcp, state0, key, max_tokens=8)
    assert len(toks) == 8
    jstate = jnp.asarray(state0)
    tstate = torch.from_numpy(state0)
    for t, tok in enumerate(toks):
        jlog = np.asarray(jtr.logits(jhp, jstate[None]))[0]
        tlog = ttr.logits(thp, tstate[None])[0]
        np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0, atol=1e-4)
        jtok, jstate = jro._gen_step(jtr.cell, jhp, jcp, jstate,
                                     jax.random.fold_in(key, t))
        assert int(jtok) == tok
        with torch.no_grad():
            tstate = tro._feed(ttr.cell, thp, tcp, tstate, tok)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("cell_cls", [LSTMVertex, GRUVertex])
def test_generation_deterministic_under_a_fixed_key(cell_cls):
    cell = cell_cls(input_dim=5, hidden=4)
    g = torch.Generator().manual_seed(2)
    cp = cell.init(g, device="cpu")
    tr = tro.TokenReadout(cell, vocab=17)
    tp = tr.init(g, device="cpu")
    state = np.random.default_rng(3).standard_normal(cell.state_dim) \
        .astype(np.float32)
    runs = [tr.generate(tp, cp, state, (11, 4), max_tokens=8)
            for _ in range(3)]
    assert runs[0] == runs[1] == runs[2]
    assert len(runs[0]) == 8 and all(0 <= t < 17 for t in runs[0])
    assert tr.generate(tp, cp, state, (12, 4), max_tokens=8) != runs[0]
    # Step t's draw depends on (key, t) alone.
    a = tro.step_generator((11, 4), 3)
    b = tro.step_generator((11, 4), 3)
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))


def test_sampling_follows_the_distribution():
    """The Gumbel-max draw is a categorical draw: over many keys the
    token frequencies track softmax(logits)."""
    logits = torch.tensor([2.0, 0.5, 0.0, -1.0, 1.0])
    n = 4000
    counts = np.bincount([tro._sample(logits, tro.step_generator(k, 0))
                          for k in range(n)], minlength=5) / n
    want = torch.softmax(logits, 0).numpy()
    np.testing.assert_allclose(counts, want, atol=0.03)


def test_generation_stops_at_eos():
    cell = LSTMVertex(input_dim=5, hidden=4)
    g = torch.Generator().manual_seed(4)
    cp = cell.init(g, device="cpu")
    tr = tro.TokenReadout(cell, vocab=9)
    tp = tr.init(g, device="cpu")
    state = np.random.default_rng(4).standard_normal(cell.state_dim) \
        .astype(np.float32)
    free = tr.generate(tp, cp, state, 0, max_tokens=12)
    eos = free[3]
    stopped = tr.generate(tp, cp, state, 0, max_tokens=12, eos_id=eos)
    assert stopped == free[: free.index(eos) + 1] and stopped[-1] == eos
    tr_eos = tro.TokenReadout(cell, vocab=9, eos_id=eos)
    assert tr_eos.generate(tp, cp, state, 0, max_tokens=12) == stopped


def test_token_readout_rejects_tree_cells():
    with pytest.raises(ValueError, match="arity"):
        tro.TokenReadout(TreeLSTMVertex(input_dim=4, hidden=3, arity=2),
                         vocab=5)


def test_batched_logits_are_per_row():
    """Rows of the batched next-token logits are the per-row logits (to
    1e-6; the reference claims bitwise, which its CPU run does not meet
    — ROADMAP queue 3)."""
    cell = LSTMVertex(input_dim=5, hidden=4)
    tr = tro.TokenReadout(cell, vocab=7)
    tp = tr.init(torch.Generator().manual_seed(6), device="cpu")
    states = torch.from_numpy(np.random.default_rng(6)
                              .standard_normal((5, 8)).astype(np.float32))
    batched = tr.logits(tp, states)
    for i in range(5):
        torch.testing.assert_close(batched[i], tr.logits(tp, states[i:i + 1])[0],
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# apply_unbatched, LambdaVertex, params_from_jax
# ---------------------------------------------------------------------------

def test_apply_unbatched_matches_jax():
    jcell = jrnn.LSTMVertex(input_dim=5, hidden=4)
    cp = _nonzero_bias(_np(jcell.init(jax.random.PRNGKey(0))), 0)
    rng = np.random.default_rng(0)
    child = rng.standard_normal((1, 8)).astype(np.float32)
    mask = np.ones(1, np.float32)
    ext = rng.standard_normal(16).astype(np.float32)
    want = jvertex.apply_unbatched(jcell, {k: jnp.asarray(v)
                                           for k, v in cp.items()},
                                   jnp.asarray(child), jnp.asarray(mask),
                                   jnp.asarray(ext))
    got = tvertex.apply_unbatched(LSTMVertex(5, 4), params_from_jax(cp, "cpu"),
                                  torch.from_numpy(child),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(ext))
    assert got.state.shape == (8,) and got.push is None
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               rtol=0, atol=TOL)


def test_lambda_vertex_wraps_plain_functions():
    def init(gen):
        return {"w": torch.randn(3, 2, generator=gen)}

    def apply(params, io):
        s = io.gather_sum() + io.pull()
        return tvertex.VertexOutput(state=s, push=s.sum(-1, keepdim=True))

    bare = tvertex.LambdaVertex(state_dim=2, ext_dim=2, arity=2,
                                init_fn=init, apply_fn=apply)
    assert not tvertex.has_eager_projection(bare)
    with pytest.raises(AttributeError):
        bare.project_inputs({}, torch.zeros(1, 3))
    proj = tvertex.LambdaVertex(state_dim=2, ext_dim=2, arity=2,
                                init_fn=init, apply_fn=apply,
                                project_fn=lambda p, raw: raw @ p["w"])
    assert tvertex.has_eager_projection(proj)
    params = proj.init(torch.Generator().manual_seed(0))
    ext = proj.project_inputs(params, torch.ones(1, 3))[0]
    out = tvertex.apply_unbatched(proj, params, torch.ones(2, 2),
                                  torch.tensor([1.0, 0.0]), ext)
    torch.testing.assert_close(out.state, 1.0 + ext)
    torch.testing.assert_close(out.push, (1.0 + ext).sum(-1, keepdim=True))


def test_params_from_jax_carries_head_and_readout_params():
    jcell = jrnn.LSTMVertex(input_dim=5, hidden=4)
    jtr = jro.TokenReadout(jcell, vocab=7)
    jh = jro.ClassificationHead(8, 3)
    nested = {"cell": _np(jcell.init(jax.random.PRNGKey(0))),
              "head": _np(jh.init(jax.random.PRNGKey(1))),
              "tokens": _np(jtr.init(jax.random.PRNGKey(2)))}
    got = params_from_jax(nested, "cpu")
    assert set(got) == {"cell", "head", "tokens"}
    assert set(got["tokens"]) == {"w", "b", "embed"}
    back = params_to_numpy(got)
    for part, d in nested.items():
        for k, v in d.items():
            np.testing.assert_array_equal(back[part][k], v)
