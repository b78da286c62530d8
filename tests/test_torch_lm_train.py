"""LM training on the port against the JAX package, on the CPU:

  - the optimizer's tree utilities over an LM-shaped tree (``layers`` a
    list of block dicts): leaves in ``jax.tree.leaves`` order, structure
    kept, ``microbatch_grads`` and ``adamw_update`` over a reduced LM;
  - ``TransformerLM.loss`` and every gradient against
    ``jax.value_and_grad`` of the JAX package's ``loss`` at ``reduced()``
    granite-3-8b and stablelm-3b on the JAX package's weights (carried
    across by ``interop.lm_params_from_numpy``, the gradients mapped the
    same way), also with ``loss_chunk`` set and with ``remat`` "full" and
    "dots" on both sides; the remat modes bit for bit the plain pass;
  - the logits' pad columns give the head no gradient;
  - 5 ``Trainer`` steps with ``n_micro=2`` against the JAX ``Trainer``'s;
    a checkpoint of the LM train state resumed bit for bit;
  - ``python -m repro_torch.launch.train --smoke --device cpu`` and
    ``examples/torch_train_lm.py --device cpu`` at a few steps; the full
    config on the card refused naming its ROADMAP item;
  - a config with a Mamba layer refused under grad, naming the K12
    backward's ROADMAP item.

Bars (float32): the loss and each gradient leaf within 1e-4 of JAX's,
relative to |loss| and to the leaf's max |JAX grad| (the same products in
other orders: rtol 1e-4, as the serving slice's logits bar); the
trainer's five losses rtol 1e-4 (``tests/test_torch_trainer.py``'s
trajectory bar)."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.archs import reduced as jreduced
from repro.models.transformer import TransformerLM as JLM
from repro.obs import registry as jregistry
from repro.train import MetricLogger as JMetricLogger
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.configs import get_config
from repro_torch.configs.archs import reduced
from repro_torch.data import lm_batches, synthetic_corpus
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import TransformerLM
from repro_torch.obs import registry as tregistry
from repro_torch.optim import adamw_init, adamw_update, microbatch_grads
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import MetricLogger, TrainConfig, Trainer

RTOL = 1e-4
QUIET = dict(log_fn=lambda *_: None)
ARCHS = ("granite-3-8b", "stablelm-3b")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_registries():
    with tregistry.fresh_registry(), jregistry.fresh_registry():
        yield


def _models(arch, **over):
    """Both packages' reduced model (``over`` replaced in both configs)
    and the JAX package's weights as NumPy arrays."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    jlm = JLM(jcfg)
    np_params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    return jlm, TransformerLM(cfg), np_params


def _batch(cfg, B=4, S=24, seed=0):
    corpus = synthetic_corpus(20_000, cfg.vocab, seed=seed)
    return next(lm_batches(corpus, B, S, seed=seed))


# ---------------------------------------------------------------------------
# The optimizer's tree utilities over an LM's params
# ---------------------------------------------------------------------------

def test_tree_utilities_walk_lists():
    t = torch.ones(2)
    tree = {"embed": t, "layers": [{"w": t * 2, "a": t * 3}, {"w": t * 4}],
            "pair": (t * 5, t * 6)}
    leaves = tree_leaves(tree)
    assert [float(x[0]) for x in leaves] == [1, 3, 2, 4, 5, 6]
    np_tree = jax.tree.map(lambda x: float(x[0]),
                           tree_map(lambda x: x.numpy(), tree))
    assert [float(x[0]) for x in leaves] == jax.tree.leaves(np_tree)
    detached = tree_map(lambda p: p.detach(), tree)
    assert isinstance(detached["layers"], list)
    assert isinstance(detached["pair"], tuple)
    assert float(tree_map(torch.add, tree, tree)["layers"][1]["w"][0]) == 8


def test_microbatch_grads_and_adamw_over_lm_params():
    """Over a reduced LM's params, whose ``layers`` is a list: every leaf
    gets a gradient of its shape and moves under AdamW, and the mean over
    two microbatches is the whole batch's within 1e-6."""
    _, tlm, np_params = _models("granite-3-8b")
    params = lm_params_from_numpy(np_params, tlm.cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tlm.cfg).items()}
    loss1, g1, _ = microbatch_grads(tlm.loss, params, batch, 1)
    loss2, g2, _ = microbatch_grads(tlm.loss, params, batch, 2)
    assert isinstance(g2["layers"], list)
    assert len(tree_leaves(g2)) == len(tree_leaves(params))
    for a, b, p in zip(tree_leaves(g1), tree_leaves(g2), tree_leaves(params)):
        assert a.shape == p.shape
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(a.abs().max()), 1e-30)
    assert abs(float(loss1) - float(loss2)) <= 1e-6 * abs(float(loss1))
    before = [p.clone() for p in tree_leaves(params)]
    opt = adamw_init(params)
    adamw_update(params, g2, opt, lr=1e-3)
    assert opt.step == 1
    assert all(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params)))


# ---------------------------------------------------------------------------
# TransformerLM.loss and its gradients against the JAX package
# ---------------------------------------------------------------------------

def _torch_value_and_grad(tlm, np_params, batch):
    params = lm_params_from_numpy(np_params, tlm.cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return microbatch_grads(tlm.loss, params, tb, 1)


def _check_against_jax(jlm, tlm, np_params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(jlm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params), jb)
    loss, grads, metrics = _torch_value_and_grad(tlm, np_params, batch)
    assert set(metrics) == {"nll", "tokens", "loss"}
    assert float(metrics["tokens"]) == float(jmet["tokens"])
    assert abs(float(loss) - float(jloss)) <= RTOL * abs(float(jloss))
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jgrads), tlm.cfg,
                                device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        err = float((g - w).abs().max())
        assert err <= RTOL * max(float(w.abs().max()), 1e-30), err
    return loss, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    jlm, tlm, np_params = _models(arch)
    _check_against_jax(jlm, tlm, np_params, _batch(tlm.cfg))


@pytest.mark.parametrize("over", [dict(loss_chunk=8), dict(remat="full"),
                                  dict(remat="dots"),
                                  dict(remat="full", loss_chunk=16)],
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_chunk_and_remat_match_jax(arch, over):
    """The same config change on both sides (the JAX package remats each
    pattern repeat with ``jax.checkpoint``; the port through
    ``torch.utils.checkpoint``); remat changes no bit of the port's loss or
    gradients."""
    jlm, tlm, np_params = _models(arch, **over)
    batch = _batch(tlm.cfg, S=36)
    loss, grads = _check_against_jax(jlm, tlm, np_params, batch)
    if "remat" in over:
        plain = TransformerLM(dataclasses.replace(tlm.cfg, remat="none"))
        loss0, grads0, _ = _torch_value_and_grad(plain, np_params, batch)
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                     tree_leaves(grads0)))


def test_pad_columns_give_the_head_no_gradient():
    """The logits' pad columns (written in place, -1e30) carry no gradient
    into the head, with or without remat: at a vocab of 500 padded to 512,
    rows 500.. of the head get none, every real row some."""
    for remat in ("none", "full"):
        cfg = dataclasses.replace(reduced(get_config("granite-3-8b")),
                                  vocab=500, remat=remat)
        tlm = TransformerLM(cfg)
        params = tlm.init(torch.Generator().manual_seed(0), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        _, grads, _ = microbatch_grads(tlm.loss, params, batch, 1)
        head = grads["embed"] if cfg.tie_embeddings else grads["lm_head"]
        assert head.shape[0] == cfg.vocab_padded > cfg.vocab
        assert torch.count_nonzero(head[cfg.vocab:]) == 0
        assert bool((head[:cfg.vocab].abs().sum(-1) > 0).all())


def test_plan_is_the_references():
    jlm, tlm, _ = _models("granite-3-8b")
    assert [len(x) if isinstance(x, list) else x for x in tlm.plan] == [
        len(x) if isinstance(x, list) else x for x in jlm.plan]
    assert tlm.descs == list(tlm.plan[0]) + list(tlm.plan[1]) * tlm.plan[2]


def test_mamba_config_refuses_a_gradient():
    cfg = reduced(get_config("mamba2-370m"))
    tlm = TransformerLM(cfg)
    params = tlm.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B=2, S=8).items()}
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 2, \"K12 backward\""):
        microbatch_grads(tlm.loss, params, batch, 1)
    with torch.no_grad():
        loss, _ = tlm.loss(params, batch)
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# The trainer over an LM
# ---------------------------------------------------------------------------

def _np_batches(cfg, n, B=4, S=16):
    corpus = synthetic_corpus(50_000, cfg.vocab, seed=3)
    it = lm_batches(corpus, B, S, seed=3)
    return [next(it) for _ in range(n)]


def test_trainer_five_steps_match_jax():
    jlm, tlm, np_params = _models("granite-3-8b")
    data = _np_batches(tlm.cfg, 5)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5, n_micro=2,
              log_every=1)
    jt = JTrainer(lambda p, b: jlm.loss(p, b),
                  lambda key: jax.tree.map(jnp.asarray, np_params),
                  JTrainConfig(**kw))
    _, jlog = jt.fit(jt.init_state(jax.random.PRNGKey(0)),
                     iter([{k: jnp.asarray(v) for k, v in b.items()}
                           for b in data]), steps=5,
                     logger=JMetricLogger(**QUIET))
    tr = Trainer(tlm.loss, lambda g: lm_params_from_numpy(
        np_params, tlm.cfg, device="cpu"), TrainConfig(**kw), device="cpu")
    _, log = tr.fit(tr.init_state(0), iter(data), steps=5,
                    logger=MetricLogger(**QUIET))
    jl = [r["loss"] for r in jlog.history]
    tl = [r["loss"] for r in log.history]
    assert len(tl) == len(jl) == 5
    np.testing.assert_allclose(tl, jl, rtol=RTOL)


def test_lm_checkpoint_resumes_bit_for_bit(tmp_path):
    """Two steps, a checkpoint of the LM train state (``layers`` a list),
    a fresh trainer restoring it and two more steps: the losses and the
    final params and moments of four uninterrupted steps, bit for bit."""
    _, tlm, _ = _models("stablelm-3b")
    data = _np_batches(tlm.cfg, 4)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=4, n_micro=2,
              log_every=1)

    def trainer(**extra):
        return Trainer(tlm.loss, lambda g: tlm.init(g, device="cpu"),
                       TrainConfig(**kw, **extra), device="cpu")

    tr = trainer()
    whole, wlog = tr.fit(tr.init_state(0), iter(data), steps=4,
                         logger=MetricLogger(**QUIET))
    tr = trainer(ckpt_dir=str(tmp_path), ckpt_every=2)
    tr.fit(tr.init_state(0), iter(data[:2]), steps=2,
           logger=MetricLogger(**QUIET))
    tr = trainer(ckpt_dir=str(tmp_path), ckpt_every=2)
    state, start = tr.maybe_restore(tr.init_state(1))
    assert start == 2 and isinstance(state.params["layers"], list)
    state, log = tr.fit(state, iter(data[2:]), steps=4,
                        logger=MetricLogger(**QUIET))
    assert [r["loss"] for r in log.history] == [
        r["loss"] for r in wlog.history][2:]
    for a, b in zip(tree_leaves((whole.params, whole.opt.mu, whole.opt.nu)),
                    tree_leaves((state.params, state.opt.mu,
                                 state.opt.nu))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The launcher and the example
# ---------------------------------------------------------------------------

def test_train_launcher_smoke_on_cpu(capsys):
    state, logger = launch_train.main(
        ["--arch", "granite-3-8b", "--smoke", "--device", "cpu", "--steps",
         "3", "--batch", "4", "--seq", "16", "--log-every", "1"])
    assert state.step == 3
    losses = [r["loss"] for r in logger.history]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done: arch=granite-3-8b-smoke step=3" in capsys.readouterr().out


def test_train_launcher_refuses_a_full_config_on_the_card():
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        launch_train.main(["--arch", "granite-3-8b"])


def test_torch_train_lm_example_runs_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    state, logger = ex.main(["--device", "cpu", "--steps", "4", "--batch",
                             "2", "--seq", "16", "--log-every", "1"])
    assert state.step == 4 and len(logger.history) == 4
    out = capsys.readouterr().out
    assert "arch=granite-100m" in out and "over 4 steps" in out
    cfg = ex.model_config()
    assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (8, 512, 8, 4, 64, 1536,
                                                   8192)
