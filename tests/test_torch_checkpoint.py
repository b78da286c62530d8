"""The port's checkpoint manager (``repro_torch.checkpoint``): each test of
``tests/test_checkpoint.py`` against the port (atomicity, keep-k, async,
bf16 round-trip, restore into a structure, the newest commit), the async
save's host copy taken before the caller's next in-place step, and the
format shared with the JAX package: a tree or a whole train state saved
by either package restores in the other with every leaf equal, bit for
bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as jrestore_tree
from repro.checkpoint import save_tree as jsave_tree
from repro.models.treelstm import TreeLSTMVertex as JTreeLSTM
from repro.optim import adamw_init as jadamw_init
from repro.train.trainer import TrainState as JTrainState
from repro.train.trainer import _ckpt_view as j_ckpt_view
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.checkpoint.manager import latest_step
from repro_torch.interop import params_from_jax
from repro_torch.kernels import level_megastep as lm
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import TrainState, _ckpt_view


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16),
                       "c": [torch.zeros((2, 2), dtype=torch.int32),
                             torch.full((1,), 7.0)]}}


def jtree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "nested": {"b": jnp.ones((5,), jnp.bfloat16) * 1.5,
                       "c": [jnp.arange(4, dtype=jnp.int32).reshape(2, 2),
                             jnp.full((1,), 7.0)]}}


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an integer array (bf16 and NaN compared by
    bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().reshape(-1).view(np.uint8)
    a = np.asarray(x)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _to_torch(t):
    """A JAX tree as the same tree of CPU tensors (bf16 kept)."""
    if isinstance(t, dict):
        return {k: _to_torch(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_torch(c) for c in t]
    return params_from_jax({"x": np.asarray(t)}, "cpu")["x"]


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for c in t for x in _leaves(c)]
    return [t]


def _zeros_like(t):
    if isinstance(t, dict):
        return {k: _zeros_like(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_zeros_like(c) for c in t]
    return torch.zeros_like(t)


def test_roundtrip(tmp_path):
    t = tree()
    save_tree(t, str(tmp_path), step=3)
    restored, step = restore_tree(str(tmp_path), _zeros_like(t),
                                  device="cpu")
    assert step == 3
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert isinstance(restored["nested"]["c"], list)


def test_atomicity_tmp_ignored(tmp_path):
    save_tree(tree(), str(tmp_path), step=1)
    # simulate a crash mid-save: a stale .tmp dir
    os.makedirs(tmp_path / "step_000000002.tmp")
    assert latest_step(str(tmp_path)) == 1
    CheckpointManager(str(tmp_path))        # purges tmp on startup
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_keep_k(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, save_interval_steps=1)
    for s in (1, 2, 3, 4):
        cm.save(tree(), s, blocking=True)
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004"]


def test_async_save_then_restore(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    t = tree()
    cm.save(t, 10, blocking=False)
    cm.wait()
    restored, step = cm.restore(_zeros_like(t), device="cpu")
    assert step == 10
    np.testing.assert_array_equal(_bits(restored["a"]), _bits(t["a"]))


def test_async_save_copies_before_the_next_in_place_step(tmp_path,
                                                         monkeypatch):
    """The trainer's next step overwrites params and moments in place
    while the save is still writing: ``save(blocking=False)`` must have
    taken its host copy before it returned.  The writer thread is held
    until the step is done."""
    import threading

    from repro_torch.checkpoint import manager
    gate, write = threading.Event(), manager.save_tree

    def held(*a, **k):
        assert gate.wait(30)
        return write(*a, **k)

    monkeypatch.setattr(manager, "save_tree", held)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=gen),
              "b": torch.randn((32,), generator=gen)}
    opt = adamw_init(params)
    state = TrainState(params=params, opt=opt)
    before = {k: v.clone() for k, v in params.items()}
    cm = CheckpointManager(str(tmp_path))
    cm.save(_ckpt_view(state), 1, blocking=False)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    adamw_update(params, grads, opt, lr=0.1)          # in place
    assert not torch.equal(params["w"], before["w"])
    gate.set()
    cm.wait()
    restored, step = cm.restore(
        TrainState(params=_zeros_like(params), opt=adamw_init(params)),
        device="cpu")
    assert step == 1 and restored.opt.step == 0
    for k in before:
        assert torch.equal(restored.params[k], before[k]), k
        assert torch.equal(restored.opt.mu[k], torch.zeros_like(before[k]))


def test_shape_mismatch_raises(tmp_path):
    save_tree({"a": torch.ones((2, 2))}, str(tmp_path), step=1)
    with pytest.raises(ValueError):
        restore_tree(str(tmp_path), {"a": torch.ones((3, 3))}, device="cpu")


def test_missing_leaf_raises(tmp_path):
    save_tree({"a": torch.ones((2,))}, str(tmp_path), step=1)
    with pytest.raises(KeyError):
        restore_tree(str(tmp_path), {"a": torch.ones((2,)),
                                     "b": torch.ones((2,))}, device="cpu")


def test_restore_picks_latest(tmp_path):
    save_tree({"a": torch.zeros((2,))}, str(tmp_path), step=1)
    save_tree({"a": torch.ones((2,))}, str(tmp_path), step=5)
    restored, step = restore_tree(str(tmp_path), {"a": torch.zeros((2,))},
                                  device="cpu")
    assert step == 5
    np.testing.assert_array_equal(restored["a"].numpy(), np.ones(2))


def test_should_save_interval(tmp_path):
    cm = CheckpointManager(str(tmp_path), save_interval_steps=50)
    assert not cm.should_save(0)
    assert cm.should_save(50)
    assert not cm.should_save(51)


def test_restore_places_leaves_on_the_requested_device(tmp_path):
    """The counterpart of the reference's reshard-on-restore: leaves go
    where ``device`` says (the card by default; ``meta`` here, which
    needs no card), Python-scalar leaves stay Python scalars."""
    t = {"w": torch.arange(64.0).reshape(8, 8), "n": 7}
    save_tree({"w": t["w"], "n": np.int32(7)}, str(tmp_path), step=7)
    restored, step = restore_tree(str(tmp_path), t, device="meta")
    assert step == 7 and restored["w"].device.type == "meta"
    assert restored["w"].shape == (8, 8) and restored["n"] == 7
    assert isinstance(restored["n"], int)
    import inspect
    for fn in (restore_tree, CheckpointManager.restore):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_layout_is_the_reference_one(tmp_path):
    """``step_%09d`` committed by rename, one ``shard_00000.npz``, a
    ``format: 1`` manifest whose keys are the JAX package's paths, the
    step a 0-d int32 and bf16 stored as uint16."""
    params = {"cell": {"ui": torch.ones((2, 2)), "b": torch.zeros(3)},
              "head": torch.ones((2, 2), dtype=torch.bfloat16)}
    state = TrainState(params=params, opt=adamw_init(params))
    state.opt.step = 4
    save_tree(_ckpt_view(state), str(tmp_path), step=4)
    d = tmp_path / "step_000000004"
    assert sorted(os.listdir(d)) == ["manifest.json", "shard_00000.npz"]
    m = json.loads((d / "manifest.json").read_text())
    assert m["format"] == 1 and m["step"] == 4
    assert list(m["leaves"]) == [
        "params/cell/b", "params/cell/ui", "params/head", "opt/step",
        "opt/mu/cell/b", "opt/mu/cell/ui", "opt/mu/head",
        "opt/nu/cell/b", "opt/nu/cell/ui", "opt/nu/head"]
    assert m["leaves"]["opt/step"] == {"array": "a000003", "shape": [],
                                       "dtype": "int32"}
    assert m["leaves"]["params/head"]["dtype"] == "bfloat16"
    with np.load(d / "shard_00000.npz") as z:
        assert z["a000003"].dtype == np.int32 and int(z["a000003"]) == 4
        assert z["a000002"].dtype == np.uint16


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tree_crosses_between_packages(tmp_path, writer):
    """A tree saved by one package restores in the other, every leaf
    bit for bit (bf16, int32, a list)."""
    jt = jtree()
    tt = _to_torch(jt)
    if writer == "jax":
        jsave_tree(jt, str(tmp_path), step=2)
        got, step = restore_tree(str(tmp_path), _zeros_like(tt),
                                 device="cpu")
        want = tt
    else:
        save_tree(tt, str(tmp_path), step=2)
        got, step = jrestore_tree(str(tmp_path),
                                  jax.tree.map(jnp.zeros_like, jt))
        want = jt
    assert step == 2
    assert len(_leaves(want)) == len(_leaves(got)) == 4
    for a, b in zip(_leaves(want), _leaves(got)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _tree_lstm_states(seed=0):
    """The same Tree-LSTM train state (params, moments, step 7) in both
    packages, moments made non-zero."""
    fn = JTreeLSTM(input_dim=3, hidden=4, arity=2)
    jp = {"cell": fn.init(jax.random.PRNGKey(seed)),
          "head": jax.random.normal(jax.random.PRNGKey(seed + 1), (4, 2))}
    jopt = jadamw_init(jp)
    jopt = type(jopt)(step=jnp.asarray(7, jnp.int32),
                      mu=jax.tree.map(lambda p: p * 0.5, jp),
                      nu=jax.tree.map(lambda p: p * p, jp))
    js = JTrainState(params=jp, opt=jopt)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    topt = adamw_init(tp)
    topt.step = 7
    topt.mu = params_from_jax(jax.tree.map(np.asarray, jopt.mu), "cpu")
    topt.nu = params_from_jax(jax.tree.map(np.asarray, jopt.nu), "cpu")
    return js, TrainState(params=tp, opt=topt)


def _flat_state(s):
    if isinstance(s, TrainState):
        return [s.opt.step] + [x.detach().numpy() for x in _leaves(
            {"p": s.params, "mu": s.opt.mu, "nu": s.opt.nu})]
    return [int(s.opt.step)] + [np.asarray(x) for x in jax.tree.leaves(
        {"p": s.params, "mu": s.opt.mu, "nu": s.opt.nu})]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_train_state_crosses_between_packages(tmp_path, writer):
    """A Tree-LSTM train state checkpointed by either package's trainer
    view restores in the other exactly; the port's ``maybe_restore``
    packs the recurrent weights again, as K1 takes them."""
    js, ts = _tree_lstm_states()
    if writer == "jax":
        jsave_tree(j_ckpt_view(js), str(tmp_path), step=7)
        tr = Trainer(lambda p, b: None, lambda g: _zeros_like(ts.params),
                     TrainConfig(ckpt_dir=str(tmp_path)), device="cpu")
        blank = tr.init_state(0)
        got, step = tr.maybe_restore(blank)
        cell = got.params["cell"]
        lm.packed_recurrent(*(cell[k] for k in ("ui", "uf", "uo", "uu")))
        want = js
    else:
        save_tree(_ckpt_view(ts), str(tmp_path), step=7)
        like = jax.tree.map(jnp.zeros_like, j_ckpt_view(js))
        got, step = jrestore_tree(str(tmp_path), like)
        want = ts
    assert step == 7
    a, b = _flat_state(want), _flat_state(got)
    assert a[0] == b[0] == 7 and len(a) == len(b)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
