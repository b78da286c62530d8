"""The port's examples against the JAX package on the CPU:
``examples/torch_treelstm_sentiment.main`` on its default (composed,
prefetched) leg gives 5 losses within 1e-4 of a JAX loop mirroring the
reference example's composed leg (``ComposedBatchSource`` →
``SchedulePipeline.prefetch``), from the same init carried by
``interop``; ``examples/torch_encoder_decoder`` gives outputs within
1e-4 of the reference computation (``examples/encoder_decoder.py``'s,
in JAX) on the same weights and data; ``examples/torch_quickstart``
runs through its five steps."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import scheduler as jsch
from repro.core import structure as jst
from repro.data import ComposedBatchSource as JSource
from repro.data import trees as jtrees
from repro.models.rnn import LSTMVertex as JLSTM
from repro.models.treelstm import TreeLSTMVertex as JTreeLSTM
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.pipeline import BucketPolicy as JPolicy
from repro.pipeline import SchedulePipeline as JPipeline
from repro_torch.interop import params_from_jax, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _load(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sentiment_composed_leg_matches_jax(monkeypatch):
    ex = _load("torch_treelstm_sentiment")
    H, X, B, steps = 8, 6, 8, 5
    jfn = JTreeLSTM(input_dim=X, hidden=H, arity=2)
    jp = {"cell": jfn.init(jax.random.PRNGKey(0)),
          "head": jax.random.normal(jax.random.PRNGKey(1), (H, 2)) * 0.1}
    monkeypatch.setattr(ex, "init_params", lambda fn, seed, device:
                        params_from_jax(jax.tree.map(np.asarray, jp),
                                        device))
    t_losses = ex.main(["--device", "cpu", "--hidden", str(H),
                        "--input-dim", str(X), "--batch", str(B),
                        "--steps", str(steps)])

    # The reference example's composed leg, step for step.
    ds = jtrees.sst_like_dataset(512, input_dim=X, seed=0)
    pipe = JPipeline(X, bucket_policy=JPolicy(mode="pow2"))
    opt = jadamw.adamw_init(jp)
    lr = jschedule.warmup_cosine(3e-3, 20, steps)

    @jax.jit
    def j_step(params, opt, ext, labels, dev):
        def loss_fn(p):
            buf = jsch.execute_lazy(jfn, p["cell"], ext, dev)
            logits = jsch.readout_roots(buf, dev)[:, H:] @ p["head"]
            lse = jax.scipy.special.logsumexp(logits, -1)
            return jnp.mean(lse - jnp.take_along_axis(
                logits, labels[:, None], 1)[:, 0])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = jadamw.adamw_update(params, grads, opt,
                                             lr=lr(opt.step),
                                             weight_decay=0.0)
        return params, opt, loss

    source = JSource(ds.graphs, ds.inputs, {"labels": list(ds.labels)},
                     composer=pipe.composer(B))
    batches = pipe.prefetch(source, depth=2)
    j_losses, params = [], jp
    try:
        for _ in range(steps):
            b = next(batches)
            labels = jnp.asarray(np.asarray(b.aux["labels"]))
            params, opt, loss = j_step(params, opt, b.ext, labels, b.dev)
            j_losses.append(float(loss))
    finally:
        batches.close()
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=TOL)
    assert t_losses[0] != t_losses[-1]


def test_encoder_decoder_matches_the_reference_computation():
    ex = _load("torch_encoder_decoder")
    D, H, B = 5, 6, 3
    enc, dec, params = ex.make_model(D, H, "cpu")
    src, tgt = ex.make_data(B, D)
    got = ex.encode_decode(enc, dec, params, src, tgt, "cpu")
    assert got["outs"].shape == (B, ex.TGT_LEN, H)

    # examples/encoder_decoder.py's computation, on the same weights.
    jp = {k: {n: jnp.asarray(a) for n, a in v.items()}
          for k, v in params_to_numpy(params).items()}
    jenc, jdec = JLSTM(input_dim=D, hidden=H), \
        JLSTM(input_dim=D + 2 * H, hidden=H)
    es = jst.pack_batch([jst.chain(ex.SRC_LEN) for _ in range(B)])
    edev = es.to_device()
    ebuf = jsch.execute(jenc, jp["enc"], edev, jnp.asarray(
        jst.pack_external(src, es, D))).buf
    context = np.asarray(jsch.readout_roots(ebuf, edev))
    ds = jst.pack_batch([jst.chain(ex.TGT_LEN) for _ in range(B)])
    ddev = ds.to_device()
    dec_inputs = [np.concatenate(
        [tgt[k], np.repeat(context[k][None], ex.TGT_LEN, 0)], axis=1)
        for k in range(B)]
    dbuf = jsch.execute(jdec, jp["dec"], ddev, jnp.asarray(
        jst.pack_external(dec_inputs, ds, D + 2 * H))).buf
    want = np.asarray(jsch.readout_nodes(dbuf, ddev))[:, :, H:]
    np.testing.assert_allclose(got["context"].numpy(), context,
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got["outs"].numpy(), want, rtol=0, atol=TOL)
    out = ex.main(["--device", "cpu"])
    assert out["outs"].shape == (4, ex.TGT_LEN, 24)


def test_quickstart_runs():
    out = _load("torch_quickstart").main(["--device", "cpu"])
    assert np.isfinite([out["loss"], out["loss2"]]).all()
    assert out["predicted_hit_rate"] == 0.5
    assert 0.0 < out["hit_rate"] <= out["predicted_hit_rate"]
