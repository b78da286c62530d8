"""The port's trainer (``repro_torch.train``, ``optim.accum``,
``dist.fault``, ``dist.compress``, the registry's histograms): each test
of ``tests/test_trainer.py`` against the port, and the port held to the
JAX package on the CPU:

  - the toy regression's losses within 1e-5 of JAX's ``Trainer`` (plain,
    microbatched, int8+EF);
  - ``microbatch_grads`` over 4 slices within 1e-6 of the full batch;
  - 5 Tree-LSTM steps through both ``Trainer``\\ s (hidden 8, fusion legs
    ``none`` and ``megastep``) with losses within 1e-4 (the bar of
    ``tests/test_torch_train.py``'s five-step trajectory);
  - resume and fault recovery bit for bit, the skip guard writing
    nothing, the EF residual never checkpointed;
  - ``fit(compose=, pipeline=)``'s riders and chaos bit-identity, modelled
    on ``tests/test_pipeline.py`` and ``tests/test_chaos.py``.

Every test runs with fresh metrics registries in both packages and
writes only under ``tmp_path``."""

import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduler as jsch
from repro.core import structure as jst
from repro.data import trees as jtrees
from repro.models.treelstm import TreeLSTMVertex as JTreeLSTM
from repro.obs import registry as jregistry
from repro.train import MetricLogger as JMetricLogger
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.core import scheduler as tsch
from repro_torch.core.structure import random_binary_tree
from repro_torch.data import trees as ttrees
from repro_torch.dist.compress import (ErrorFeedback, compress_tree,
                                       ef_apply, fake_quant)
from repro_torch.dist.fault import (FaultInjector, HeartbeatMonitor,
                                    RestartPolicy, ScriptedChaos,
                                    SimulatedFailure, install_chaos)
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.kernels import level_megastep as lm
from repro_torch.models.treelstm import TreeLSTMVertex as TTreeLSTM
from repro_torch.obs import registry as tregistry
from repro_torch.obs import trace
from repro_torch.optim import microbatch_grads
from repro_torch.pipeline import (BatchComposer, BucketPolicy, ScheduleCache,
                                  SchedulePersist, SchedulePipeline)
from repro_torch.train import MetricLogger, TrainConfig, Trainer

LOSS_TOL, MICRO_TOL, TREE_TOL = 1e-5, 1e-6, 1e-4
QUIET = dict(log_fn=lambda *_: None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Loggers register providers and histograms in the process-global
    registries: each test gets its own pair, the old ones come back."""
    with tregistry.fresh_registry() as reg, jregistry.fresh_registry():
        yield reg


# ---------------------------------------------------------------------------
# The toy regression of tests/test_trainer.py, in both packages
# ---------------------------------------------------------------------------

def make_problem(seed=0):
    """Learn y = x @ w_true: ``(init_params, loss_fn, batches)``."""
    w_true = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((8, 4)).astype(
            np.float32))

    def init_params(gen):
        return {"w": torch.zeros((8, 4))}

    def loss_fn(p, batch):
        l = torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)
        return l, {"mse": l}

    def batches(seed=0):
        r = np.random.default_rng(seed)
        while True:
            x = torch.from_numpy(r.standard_normal((16, 8)).astype(
                np.float32))
            yield {"x": x, "y": x @ w_true}

    return init_params, loss_fn, batches


def make_jax_problem(seed=0):
    w_true = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (8, 4)).astype(np.float32))

    def loss_fn(p, batch):
        l = jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)
        return l, {"mse": l}

    def batches(seed=0):
        r = np.random.default_rng(seed)
        while True:
            x = r.standard_normal((16, 8)).astype(np.float32)
            yield {"x": jnp.asarray(x), "y": jnp.asarray(x) @ w_true}

    return (lambda key: {"w": jnp.zeros((8, 4), jnp.float32)}, loss_fn,
            batches)


def _cfg(**kw):
    base = dict(lr=0.05, warmup_steps=5, weight_decay=0.0, total_steps=60,
                log_every=100)
    base.update(kw)
    return TrainConfig(**base)


def _trainer(loss_fn, init, **kw):
    return Trainer(loss_fn, init, _cfg(**kw), device="cpu")


def test_loss_decreases():
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init, log_every=1)
    state = tr.init_state(0)
    state, logger = tr.fit(state, batches(), steps=60,
                           logger=MetricLogger(**QUIET))
    assert logger.history[-1]["loss"] < 0.05 * logger.history[0]["loss"]


def test_caller_owned_generator_survives_staged_fits():
    """fit() must not close a caller-owned generator: staged training
    resumes consuming the SAME stream across fit() calls."""
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init, total_steps=40, log_every=1)
    state = tr.init_state(0)
    stream = batches()
    logger = MetricLogger(**QUIET)
    state, logger = tr.fit(state, stream, steps=15, logger=logger)
    state, logger = tr.fit(state, stream, steps=40, logger=logger)
    assert state.step == 40
    next(stream)                           # still open


def test_resume_is_deterministic(tmp_path):
    """run 40 steps straight  ≡  run 20, 'crash', restore, run 20 — bit
    for bit."""
    init, loss_fn, batches = make_problem()

    def fit(ckpt_dir, stop_at, resume=False):
        tr = Trainer(loss_fn, init,
                     TrainConfig(lr=0.05, warmup_steps=5, total_steps=40,
                                 ckpt_dir=ckpt_dir, ckpt_every=20,
                                 log_every=100), device="cpu")
        state = tr.init_state(0)
        start = 0
        if resume:
            state, start = tr.maybe_restore(state)
        stream = batches()
        for _ in range(start):
            next(stream)
        state, _ = tr.fit(state, stream, steps=stop_at,
                          logger=MetricLogger(**QUIET))
        return state

    s_straight = fit(str(tmp_path / "a"), 40)
    fit(str(tmp_path / "b"), 20)
    s_resumed = fit(str(tmp_path / "b"), 40, resume=True)
    assert s_resumed.step == 40
    for tree in ("params", "mu", "nu"):
        a = s_straight.params if tree == "params" else \
            getattr(s_straight.opt, tree)
        b = s_resumed.params if tree == "params" else \
            getattr(s_resumed.opt, tree)
        assert torch.equal(a["w"], b["w"]), tree


def test_failure_injection_recovers(tmp_path):
    """A simulated node failure mid-run must restore the last commit and
    still converge."""
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init, ckpt_dir=str(tmp_path), ckpt_every=10)
    state = tr.init_state(0)
    inj = FaultInjector(fail_at_steps=[25])
    state, logger = tr.fit(state, batches(), steps=60,
                           logger=MetricLogger(**QUIET),
                           fault_injector=inj)
    assert inj.failures == [25]
    assert state.step == 60
    assert logger.history[-1]["loss"] < 0.3


def test_fault_without_checkpoints_raises():
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init)
    with pytest.raises(SimulatedFailure):
        tr.fit(tr.init_state(0), batches(), steps=5,
               fault_injector=FaultInjector([2]))


@pytest.mark.parametrize("seeded_by", ["int", "generator"])
def test_failure_before_first_checkpoint_reinits_params(tmp_path, seeded_by):
    """A crash BEFORE the first checkpoint commit restarts from a fresh
    init from the recorded seed (an int, or a generator's state), not
    from zeros and not from the params the crashed run had moved.  The
    crash at step 3 follows 3 steps and consumes a 4th batch, so the
    fault-free reference skips 4 batches."""
    _, loss_fn, batches = make_problem(3)

    def init_params(gen):
        return {"w": torch.randn((8, 4), generator=gen)}

    def fit(ckpt_dir, fail_at, skip):
        tr = Trainer(loss_fn, init_params,
                     TrainConfig(lr=0.05, warmup_steps=5, total_steps=12,
                                 weight_decay=0.0, ckpt_dir=ckpt_dir,
                                 ckpt_every=100, log_every=100),
                     device="cpu")
        if seeded_by == "int":
            seed = 5
        else:
            seed = torch.Generator().manual_seed(5)
            torch.randn((3,), generator=seed)   # a generator mid-stream
        state = tr.init_state(seed)
        stream = batches()
        for _ in range(skip):
            next(stream)
        inj = FaultInjector(fail_at_steps=fail_at)
        state, _ = tr.fit(state, stream, steps=12, fault_injector=inj)
        assert inj.failures == fail_at
        return state.params["w"].clone()

    clean = fit(str(tmp_path / "clean"), [], skip=4)
    crashed = fit(str(tmp_path / "crash"), [3], skip=0)
    assert torch.equal(clean, crashed)
    assert not torch.equal(crashed, torch.zeros_like(crashed))


def test_nonfinite_batch_skips_step_and_counts():
    """A NaN batch must not touch params/moments: the guard drops the
    batch, the host counts the skip, and training still converges."""
    init, loss_fn, batches = make_problem()

    def poisoned(seed=0):
        for i, b in enumerate(batches(seed)):
            if i == 3:
                b = dict(b, x=b["x"].clone())
                b["x"][0, 0] = float("nan")
            yield b

    tr = _trainer(loss_fn, init, log_every=1)
    state = tr.init_state(0)
    state, logger = tr.fit(state, poisoned(), steps=60,
                           logger=MetricLogger(**QUIET))
    assert logger.counters["nonfinite_skips"] == 1
    assert state.step == 60
    assert torch.isfinite(state.params["w"]).all()
    assert logger.history[-1]["loss"] < 0.05 * logger.history[0]["loss"]
    assert [r["skipped"] for r in logger.history][2:5] == [0.0, 1.0, 0.0]


def test_skipped_step_writes_nothing():
    """The port updates in place, so the guard decides before any write:
    params and both moments keep their bits, the step counter moves."""
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init)
    stream = batches()
    state, _ = tr.fit(tr.init_state(0), stream, steps=4)
    before = [t.clone() for t in (state.params["w"], state.opt.mu["w"],
                                  state.opt.nu["w"])]
    good = next(stream)
    bad = {"x": good["x"] * float("inf"), "y": good["y"]}
    state, _ = tr.fit(state, iter([bad]), steps=5)
    assert state.step == 5
    after = (state.params["w"], state.opt.mu["w"], state.opt.nu["w"])
    for a, b in zip(after, before):
        assert torch.equal(a, b)


def test_nonfinite_streak_aborts():
    """More than max_skip_steps consecutive non-finite steps aborts."""
    init, loss_fn, batches = make_problem()

    def all_nan(seed=0):
        for b in batches(seed):
            yield {"x": b["x"] * float("nan"), "y": b["y"]}

    tr = _trainer(loss_fn, init, max_skip_steps=4)
    logger = MetricLogger(**QUIET)
    with pytest.raises(RuntimeError, match="consecutive non-finite"):
        tr.fit(tr.init_state(0), all_nan(), steps=60, logger=logger)
    assert logger.counters["nonfinite_skips"] == 5


def test_compressed_grads_still_converge():
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init, total_steps=80, compress_grads=True)
    state, logger = tr.fit(tr.init_state(0), batches(), steps=80,
                           logger=MetricLogger(**QUIET))
    assert logger.history[-1]["loss"] < 0.1


def test_ef_residual_in_state_makes_gradient_sums_converge():
    """With the residual carried in TrainState, the sum of EMITTED
    (quantized) gradients converges to the true sum; naive per-step
    quantization drifts by T·|Q(c)-c|.  A linear loss (grad ≡ c) and
    b1=0, so ``opt.mu`` IS the emitted gradient after each step."""
    c = torch.from_numpy((np.random.default_rng(0).standard_normal((8, 4))
                          * 1e-4).astype(np.float32))

    def init(gen):
        return {"w": torch.zeros((8, 4))}

    def loss_fn(p, batch):
        return torch.sum(p["w"] * batch["c"]), {}

    steps = 50
    tr = Trainer(loss_fn, init,
                 TrainConfig(lr=1e-6, warmup_steps=1, total_steps=steps,
                             b1=0.0, weight_decay=0.0, max_grad_norm=1e9,
                             log_every=1000, compress_grads=True),
                 device="cpu")
    state = tr.init_state(0)
    assert state.ef is not None            # residual lives in the state
    stream = itertools.repeat({"c": c})
    emitted_sum = torch.zeros((8, 4), dtype=torch.float64)
    for t in range(steps):
        state, _ = tr.fit(state, stream, steps=t + 1)
        emitted_sum += state.opt.mu["w"].double()
    true = steps * c.double()
    err_ef = float(torch.linalg.norm(emitted_sum - true))
    err_naive = float(torch.linalg.norm(steps * fake_quant(c).double()
                                        - true))
    assert err_naive > 0                   # quantization actually bites
    assert err_ef < err_naive * 0.5
    assert float(state.ef["w"].abs().sum()) > 0


def test_ef_absent_without_compression():
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init, total_steps=5)
    state = tr.init_state(0)
    assert state.ef is None
    state, _ = tr.fit(state, batches(), steps=5)
    assert state.ef is None


def test_skipped_step_leaves_ef_residual_untouched():
    """Skip-step safety: a skipped non-finite step emitted nothing, so the
    EF residual comes out bit-identical; a normal step moves it again."""
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init, total_steps=10, compress_grads=True)
    stream = batches()
    state, _ = tr.fit(tr.init_state(0), stream, steps=3)
    ef_before = state.ef["w"].clone()
    assert float(ef_before.abs().sum()) > 0
    good = next(stream)
    x = good["x"].clone()
    x[0, 0] = float("nan")
    logger = MetricLogger(**QUIET)
    state, logger = tr.fit(state, itertools.chain(
        [{"x": x, "y": good["y"]}], stream), steps=4, logger=logger)
    assert logger.counters["nonfinite_skips"] == 1
    assert torch.equal(state.ef["w"], ef_before)
    state, _ = tr.fit(state, stream, steps=5)
    assert not torch.equal(state.ef["w"], ef_before)


def test_checkpoint_strips_and_reinits_ef(tmp_path):
    """Checkpoints never carry the EF residual; restore re-initializes
    zeros."""
    init, loss_fn, batches = make_problem()

    def trainer():
        return _trainer(loss_fn, init, total_steps=10,
                        ckpt_dir=str(tmp_path), ckpt_every=5,
                        compress_grads=True)

    tr = trainer()
    state, _ = tr.fit(tr.init_state(0), batches(), steps=10)
    assert float(state.ef["w"].abs().sum()) > 0
    import json
    manifest = json.loads((tmp_path / "step_000000010" / "manifest.json")
                          .read_text())
    assert not any(k.startswith("ef") for k in manifest["leaves"])
    tr2 = trainer()
    restored, step = tr2.maybe_restore(tr2.init_state(0))
    assert step == 10
    assert torch.equal(restored.ef["w"], torch.zeros((8, 4)))
    assert torch.equal(restored.params["w"], state.params["w"])


def test_microbatched_trainer_matches_full():
    init, loss_fn, batches = make_problem()

    def run(n_micro):
        tr = Trainer(loss_fn, init,
                     TrainConfig(lr=0.05, warmup_steps=5, total_steps=10,
                                 n_micro=n_micro, log_every=100),
                     device="cpu")
        state, _ = tr.fit(tr.init_state(0), batches(), steps=10)
        return state.params["w"].numpy()

    np.testing.assert_allclose(run(1), run(4), rtol=1e-5, atol=MICRO_TOL)


def test_microbatch_grads_match_full_batch():
    """``microbatch_grads`` over 4 slices: mean loss, f32 gradients and
    metrics within 1e-6 of one pass over the whole batch."""
    init, loss_fn, batches = make_problem()
    params = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 4)).astype(np.float32))}
    batch = next(batches())
    full = microbatch_grads(loss_fn, params, batch, 1)
    micro = microbatch_grads(loss_fn, params, batch, 4)
    assert micro[1]["w"].dtype == torch.float32
    np.testing.assert_allclose(float(micro[0]), float(full[0]),
                               rtol=MICRO_TOL)
    np.testing.assert_allclose(micro[1]["w"].numpy(), full[1]["w"].numpy(),
                               rtol=MICRO_TOL, atol=MICRO_TOL)
    np.testing.assert_allclose(float(micro[2]["mse"]),
                               float(full[2]["mse"]), rtol=MICRO_TOL)
    assert not params["w"].requires_grad
    with pytest.raises(ValueError, match="divisible"):
        microbatch_grads(loss_fn, params, batch, 3)


def test_restart_policy_backoff():
    rp = RestartPolicy(max_restarts=3, base_delay=1.0, max_delay=10.0)
    assert rp.next_delay() == 1.0
    assert rp.next_delay() == 2.0
    rp.record_success()
    assert rp.next_delay() == 1.0
    rp.next_delay()
    rp.next_delay()
    assert rp.next_delay() is None      # budget exhausted


def test_heartbeat_rejoin():
    t = [0.0]
    hm = HeartbeatMonitor(["a", "b"], timeout=5.0, clock=lambda: t[0])
    t[0] = 10.0
    assert set(hm.sweep()) == {"a", "b"}
    hm.rejoin("a")
    assert hm.alive == ["a"]
    hm.beat("b")                       # dead workers can't silently beat
    assert "b" in hm.dead


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leg", ["plain", "micro", "int8_ef"])
def test_toy_losses_match_jax(leg):
    """The same problem, data and init through both ``Trainer``\\ s:
    every step's loss within 1e-5."""
    kw = {"plain": {}, "micro": {"n_micro": 4},
          "int8_ef": {"compress_grads": True}}[leg]
    cfg = dict(lr=0.05, warmup_steps=5, weight_decay=0.1, total_steps=20,
               log_every=1, **kw)
    jinit, jloss, jbatches = make_jax_problem()
    jt = JTrainer(jloss, jinit, JTrainConfig(**cfg))
    _, jlog = jt.fit(jt.init_state(jax.random.PRNGKey(0)), jbatches(),
                     steps=20, logger=JMetricLogger(**QUIET))
    init, loss_fn, batches = make_problem()
    tr = Trainer(loss_fn, init, TrainConfig(**cfg), device="cpu")
    _, log = tr.fit(tr.init_state(0), batches(), steps=20,
                    logger=MetricLogger(**QUIET))
    want = [r["loss"] for r in jlog.history]
    got = [r["loss"] for r in log.history]
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got[-1] < got[0]


def test_compress_matches_jax():
    """``fake_quant``, ``compress_tree``, ``ef_apply`` and
    ``ErrorFeedback`` against the JAX package on the same tree."""
    from repro.dist import compress as jc
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((16, 8)).astype(np.float32),
            "b": {"c": (rng.standard_normal(5) * 1e-3).astype(np.float32),
                  "z": np.zeros(3, np.float32)}}
    res = {"a": (rng.standard_normal((16, 8)) * 1e-2).astype(np.float32),
           "b": {"c": np.full(5, 1e-5, np.float32),
                 "z": np.zeros(3, np.float32)}}
    jt, jr = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, res)
    tt, tr_ = params_from_jax(tree, "cpu"), params_from_jax(res, "cpu")

    def close(got, want):
        jax.tree.map(lambda w, g: np.testing.assert_allclose(
            g, np.asarray(w), rtol=1e-6, atol=1e-9), want,
            params_to_numpy(got))

    close(compress_tree(tt), jc.compress_tree(jt))
    emitted, new_res = ef_apply(tt, tr_)
    jemitted, jnew = jc.ef_apply(jt, jr)
    close(emitted, jemitted)
    close(new_res, jnew)
    out, ef2 = ErrorFeedback(tr_).apply(tt)
    close(out, jemitted)
    close(ef2.residual, jnew)
    assert torch.equal(ErrorFeedback.init(tt).residual["a"],
                       torch.zeros((16, 8)))
    assert torch.equal(tr_["a"], torch.from_numpy(res["a"]))   # not written


H, X, B = 8, 6, 8


def _tree_batches(steps):
    """The same FIFO batches of SST-like parses for both packages, packed
    at the same pow2 pads: ``(jax batch dicts, port batch dicts)``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_treelstm_sentiment.py"
    spec = importlib.util.spec_from_file_location("tts", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    ds_j = jtrees.sst_like_dataset(48, input_dim=X, seed=0)
    ds_t = ttrees.sst_like_dataset(48, input_dim=X, seed=0)
    pipe = SchedulePipeline(X, bucket_policy=BucketPolicy(mode="pow2"),
                            with_runs=True, device="cpu")
    jb = ex.fifo_batches(ds_j, B, np.random.default_rng(0))
    tb = ex.fifo_batches(ds_t, B, np.random.default_rng(0))
    jout, tout = [], []
    for _ in range(steps):
        (jg, jx, jy), (tg, tx, ty) = next(jb), next(tb)
        b = pipe.pack(tg, tx)
        s = b.sched
        js = jst.pack_batch(jg, pad_levels=s.T, pad_width=s.M,
                            pad_arity=s.A, pad_nodes=s.N)
        jout.append({"dev": js.to_device(),
                     "ext": jnp.asarray(jst.pack_external(jx, js, X)),
                     "labels": jnp.asarray(jy)})
        tout.append({"dev": b.dev, "ext": b.ext,
                     "labels": ty.astype(np.int64)})
    return jout, tout


def _jax_tree_loss(fn, leg):
    def loss_fn(p, batch):
        buf = jsch.execute_lazy(fn, p["cell"], batch["ext"], batch["dev"],
                                fusion_mode=leg)
        root_h = jsch.readout_roots(buf, batch["dev"])[:, H:]
        logits = root_h @ p["head"]
        lse = jax.scipy.special.logsumexp(logits, -1)
        nll = lse - jnp.take_along_axis(
            logits, batch["labels"][:, None], 1)[:, 0]
        return jnp.mean(nll), {}
    return loss_fn


def _tree_loss(fn, leg):
    def loss_fn(p, batch):
        buf = tsch.execute_lazy(fn, p["cell"], batch["ext"], batch["dev"],
                                fusion_mode=leg)
        root_h = tsch.readout_roots(buf, batch["dev"])[:, H:]
        logits = root_h @ p["head"]
        y = batch["labels"]
        nll = torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]
        acc = torch.mean((torch.argmax(logits, -1) == y).float())
        return torch.mean(nll), {"acc": acc}
    return loss_fn


def _tree_params():
    jfn = JTreeLSTM(input_dim=X, hidden=H, arity=2)
    jp = {"cell": jfn.init(jax.random.PRNGKey(0)),
          "head": jax.random.normal(jax.random.PRNGKey(1), (H, 2)) * 0.1}
    return jfn, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("leg", ["none", "megastep"])
def test_tree_lstm_trainer_matches_jax(leg):
    """5 Tree-LSTM steps through both ``Trainer``\\ s from the same init
    (carried as NumPy) on the same batches: losses within 1e-4; the
    port's recurrent weights stay packed views."""
    steps = 5
    jfn, jp, np_params = _tree_params()
    tfn = TTreeLSTM(input_dim=X, hidden=H, arity=2)
    jbatches, tbatches = _tree_batches(steps)
    cfg = dict(lr=3e-3, warmup_steps=20, total_steps=steps,
               weight_decay=0.0, log_every=1)
    jt = JTrainer(_jax_tree_loss(jfn, leg), lambda key: jp,
                  JTrainConfig(**cfg))
    _, jlog = jt.fit(jt.init_state(jax.random.PRNGKey(0)), iter(jbatches),
                     steps=steps, logger=JMetricLogger(**QUIET))
    tr = Trainer(_tree_loss(tfn, leg),
                 lambda g: params_from_jax(np_params, "cpu"),
                 TrainConfig(**cfg), device="cpu")
    state, log = tr.fit(tr.init_state(0), iter(tbatches), steps=steps,
                        logger=MetricLogger(**QUIET))
    want = [r["loss"] for r in jlog.history]
    got = [r["loss"] for r in log.history]
    np.testing.assert_allclose(got, want, rtol=0, atol=TREE_TOL)
    assert got[0] != got[-1]
    cell = state.params["cell"]
    lm.packed_recurrent(*(cell[k] for k in ("ui", "uf", "uo", "uu")))


def _replaying(batches, inj, tr):
    """Batch ``i`` at the trainer's step ``i``: after the injector fires,
    the stream goes back to the step the trainer restored (a loader that
    checkpoints its position)."""
    i, fired = 0, 0
    while True:
        if len(inj.failures) > fired:
            fired = len(inj.failures)
            i = tr.ckpt.latest_step()
        yield batches[i]
        i += 1


def test_tree_lstm_fault_recovery_is_bitwise(tmp_path):
    """A fault at step 7 restores step 5 (recurrent weights packed again)
    and, with the data replayed from there, ends bit for bit where the
    clean run ends."""
    steps = 10
    _, _, np_params = _tree_params()
    tfn = TTreeLSTM(input_dim=X, hidden=H, arity=2)
    _, tbatches = _tree_batches(steps)

    def run(ckpt_dir, fail_at):
        tr = Trainer(_tree_loss(tfn, "megastep"),
                     lambda g: params_from_jax(np_params, "cpu"),
                     TrainConfig(lr=3e-3, warmup_steps=3, total_steps=steps,
                                 weight_decay=0.0, ckpt_dir=ckpt_dir,
                                 ckpt_every=5, ckpt_keep=2, log_every=100),
                     device="cpu")
        inj = FaultInjector(fail_at)
        state, _ = tr.fit(tr.init_state(0), _replaying(tbatches, inj, tr),
                          steps=steps, fault_injector=inj)
        assert inj.failures == fail_at
        return state

    clean = run(str(tmp_path / "clean"), [])
    faulted = run(str(tmp_path / "fault"), [7])
    assert faulted.step == clean.step == steps
    a = params_to_numpy({"p": clean.params, "mu": clean.opt.mu,
                         "nu": clean.opt.nu})
    b = params_to_numpy({"p": faulted.params, "mu": faulted.opt.mu,
                         "nu": faulted.opt.nu})
    jax.tree.map(np.testing.assert_array_equal, a, b)
    cell = faulted.params["cell"]
    lm.packed_recurrent(*(cell[k] for k in ("ui", "uf", "uo", "uu")))


# ---------------------------------------------------------------------------
# fit() with the schedule pipeline
# ---------------------------------------------------------------------------

INPUT_DIM = 3


def test_trainer_consumes_async_packer_and_closes():
    """An ``AsyncPacker`` source is consumed and closed by fit()."""
    from repro_torch.pipeline import AsyncPacker
    init, loss_fn, _ = make_problem()
    w_true = np.random.default_rng(0).standard_normal((8, 4)).astype(
        np.float32)

    def raw():
        r = np.random.default_rng(0)
        for _ in range(40):
            x = r.standard_normal((16, 8)).astype(np.float32)
            yield {"x": x, "y": x @ w_true}

    packer = AsyncPacker(raw(), lambda b: b, depth=2)
    tr = _trainer(loss_fn, init, total_steps=30, log_every=1)
    state, logger = tr.fit(tr.init_state(0), packer, steps=30,
                           logger=MetricLogger(**QUIET))
    assert logger.history[-1]["loss"] < logger.history[0]["loss"]
    packer._bg._thread.join(timeout=10)
    assert not packer._bg._thread.is_alive()   # fit closed the producer


def test_trainer_compose_reorders_with_aligned_riders():
    """``Trainer.fit(compose=...)``: epoch corpora are re-composed into
    cache-friendly batches, labels ride the reordering aligned with their
    samples, every batch dict carries sample_ids, the caller's source is
    closed and the packer's thread is gone."""
    rng = np.random.default_rng(0)
    fn = TTreeLSTM(input_dim=INPUT_DIM, hidden=4, arity=2)
    hot = random_binary_tree(4, np.random.default_rng(1))
    corpus = [hot if i % 2 == 0 else
              random_binary_tree(int(rng.integers(2, 6)), rng)
              for i in range(12)]
    inputs = [rng.standard_normal((g.num_nodes, INPUT_DIM))
              .astype(np.float32) * 0.3 for g in corpus]
    labels = list(range(12))           # the label IS the sample id
    seen = []

    def loss_fn(p, batch):
        seen.append((batch["sample_ids"].numpy().copy(),
                     batch["labels"].numpy().copy()))
        buf = tsch.execute(fn, p["cell"], batch["dev"], batch["ext"]).buf
        return torch.mean(tsch.readout_roots(buf, batch["dev"]) ** 2), {}

    class EpochSource:
        """Closable epoch stream: fit(compose=) must close the CALLER's
        source, not only its internal composed stream."""

        def __init__(self):
            self.closed = False

        def __iter__(self):
            return self

        def __next__(self):
            return corpus, inputs, {"labels": labels}

        def close(self):
            self.closed = True

    pipe = SchedulePipeline(INPUT_DIM, bucket_policy=BucketPolicy(),
                            cache=ScheduleCache(enabled=True, persist=False),
                            device="cpu")
    tr = Trainer(loss_fn,
                 lambda g: {"cell": fn.init(g, device="cpu")},
                 TrainConfig(lr=0.01, warmup_steps=2, weight_decay=0.0,
                             total_steps=6, log_every=1), device="cpu")
    state = tr.init_state(0)
    threads = set(threading.enumerate())
    src = EpochSource()
    tr.fit(state, src, steps=6, logger=MetricLogger(**QUIET),
           compose=BatchComposer(4, bucket_policy=pipe.bucket_policy),
           pipeline=pipe)
    assert src.closed
    for t in set(threading.enumerate()) - threads:
        t.join(timeout=10)
        assert not t.is_alive(), t
    assert len(seen) == 6
    for ids, labs in seen:
        np.testing.assert_array_equal(ids, labs)   # riders stay aligned
    epoch1 = np.concatenate([ids for ids, _ in seen[:3]])
    assert sorted(epoch1.tolist()) == list(range(12))  # lossless epoch
    assert epoch1.tolist() != list(range(12))          # actually reordered
    assert pipe.cache.hits + pipe.cache.misses >= 6

    with pytest.raises(ValueError, match="compose= requires pipeline="):
        tr.fit(state, EpochSource(), steps=7, compose=BatchComposer(4))
    with pytest.raises(ValueError, match="BatchComposer"):
        tr.fit(state, EpochSource(), steps=7, compose=object(),
               pipeline=pipe)


def _chaos_batches(seed, n_batches, bs=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        graphs = [random_binary_tree(int(rng.integers(2, 6)), rng)
                  for _ in range(bs)]
        inputs = [rng.standard_normal((g.num_nodes, INPUT_DIM))
                  .astype(np.float32) * 0.3 for g in graphs]
        out.append((graphs, inputs))
    return out


def test_training_under_transient_chaos_is_bit_identical(tmp_path):
    """Prefetch retries and persist faults are ABSORBED: a run whose
    pipeline is being faulted ends in exactly the fault-free run's
    params."""
    fn = TTreeLSTM(input_dim=INPUT_DIM, hidden=4, arity=2)
    source = _chaos_batches(6, 12)

    def loss_fn(p, batch):
        buf = tsch.execute(fn, p, batch["dev"], batch["ext"],
                           fusion_mode="none").buf
        l = torch.mean(tsch.readout_roots(buf, batch["dev"]) ** 2)
        return l, {"root_norm": l}

    def run(persist_dir, hook):
        pipe = SchedulePipeline(
            INPUT_DIM, bucket_policy=BucketPolicy(mode="pow2"),
            cache=ScheduleCache(capacity=32,
                                persist=SchedulePersist(persist_dir)),
            device="cpu")
        tr = Trainer(loss_fn, lambda g: fn.init(g, device="cpu"),
                     TrainConfig(lr=0.02, warmup_steps=3, total_steps=12,
                                 weight_decay=0.0, log_every=100),
                     device="cpu")
        state = tr.init_state(0)

        def stream():
            for pb in pipe.prefetch(iter(source), depth=2):
                yield {"dev": pb.dev, "ext": pb.ext}

        import contextlib
        ctx = install_chaos(hook) if hook else contextlib.nullcontext()
        with ctx:
            state, _ = tr.fit(state, stream(), steps=12,
                              logger=MetricLogger(**QUIET))
        return params_to_numpy(state.params)

    clean = run(str(tmp_path / "clean"), None)
    hook = ScriptedChaos(fail={"prefetch": [0, 5], "persist_store": [1],
                               "persist_load": [2]})
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # warn-once store
        chaotic = run(str(tmp_path / "chaos"), hook)
    assert hook.fired.get("prefetch") == [0, 5]
    jax.tree.map(np.testing.assert_array_equal, clean, chaotic)


# ---------------------------------------------------------------------------
# What waits for the mesh; the card by default; metrics and spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["mesh", "policy", "dp_shard", "grad_specs"])
def test_mesh_paths_are_not_ported(what):
    init, loss_fn, batches = make_problem()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        if what == "grad_specs":
            microbatch_grads(loss_fn, init(None), next(batches()), 1,
                             grad_specs={"w": None})
        elif what == "dp_shard":
            Trainer(loss_fn, init, TrainConfig(dp_shard=True))
        else:
            Trainer(loss_fn, init, TrainConfig(), **{what: object()})


def test_trainer_runs_on_the_card_by_default():
    init, loss_fn, _ = make_problem()
    assert Trainer(loss_fn, init, TrainConfig()).device == \
        torch.device("cuda")


def test_metric_logger_writes_through_to_the_registry(_fresh_registries):
    """Windowed metrics as ``train.<key>`` histograms, counters as
    ``train.<key>`` counters, the logger as the ``metrics`` provider;
    0-d tensors read at log time; a bounded history."""
    reg = _fresh_registries
    logger = MetricLogger(window=4, history_cap=3, **QUIET)
    for s in range(1, 6):
        logger.train_tick(0.01 * s)
        logger.log(s, {"loss": torch.tensor(float(s)), "lr": 0.5})
    logger.count("nonfinite_skips")
    snap = reg.snapshot()
    assert snap["histograms"]["train.loss"]["count"] == 5
    assert snap["histograms"]["train.loss"]["max"] == 5.0
    assert snap["histograms"]["train.train_sec_per_step"]["count"] == 5
    assert snap["histograms"]["train.sec_per_step"]["count"] == 4
    assert snap["counters"]["train.nonfinite_skips"] == 1
    prov = snap["providers"]["metrics"]
    assert prov["loss"] == np.mean([2.0, 3.0, 4.0, 5.0])   # window of 4
    assert prov["counters"] == {"nonfinite_skips": 1} and prov["rows"] == 3
    assert [r["step"] for r in logger.history] == [3.0, 4.0, 5.0]
    assert logger.mean("train_sec_per_step") == pytest.approx(0.035)
    assert np.isnan(logger.mean("absent"))


def test_registry_histograms_and_swaps():
    reg = tregistry.MetricsRegistry(hist_window=3)
    for v in (1.0, 5.0, 2.0, 4.0):
        reg.observe("h", v, kind="x")
    st = reg.hist_stats("h", kind="x")
    assert st == {"count": 4, "window": 3, "mean": 11.0 / 3, "p50": 4.0,
                  "max": 5.0, "total": 11.0}
    assert reg.hist_stats("absent") is None
    reg.inc("c")
    reg.set_gauge("g", 2.0)
    name = reg.register_provider("p", lambda: {"ok": 1})
    snap = reg.snapshot()
    assert snap["histograms"] == {"h{kind=x}": st}
    assert snap["providers"] == {"p": {"ok": 1}}
    reg.unregister_provider(name)
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}, "providers": {}}
    outer = tregistry.get_registry()
    with tregistry.fresh_registry(hist_window=7) as fresh:
        assert tregistry.get_registry() is fresh is not outer
        assert fresh.hist_window == 7
    assert tregistry.get_registry() is outer
    other = tregistry.MetricsRegistry()
    try:
        assert tregistry.set_registry(other) is other
        assert tregistry.get_registry() is other
    finally:
        tregistry.set_registry(outer)


def test_fit_emits_the_train_spans(tmp_path):
    """Under a tracer the loop's spans and the fault's instant appear,
    each step's spans stamped with its step."""
    init, loss_fn, batches = make_problem()
    tr = _trainer(loss_fn, init, total_steps=8, log_every=4,
                  ckpt_dir=str(tmp_path), ckpt_every=4)
    with trace.install_tracer(trace.Tracer()) as t:
        tr.fit(tr.init_state(0), batches(), steps=8,
               logger=MetricLogger(**QUIET),
               fault_injector=FaultInjector([6]))
    names = [s.name for s in t.snapshot()]
    for n in ("train.step", "train.h2d", "train.fwd_bwd", "train.log",
              "train.checkpoint", "train.fault", "train.restore"):
        assert n in names, n
    steps = [s.cid["step"] for s in t.snapshot() if s.name == "train.step"]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 4, 5, 6, 7]
    assert trace.get_tracer() is None
