"""The port's scheduler (``repro_torch.core.scheduler.execute``) against
the JAX package's ``execute`` on both fusion legs: node buffers and
``readout_roots`` on the same graphs, inputs and params (carried over by
``params_from_jax``), at 1e-4 — the reference's own fused-vs-unfused
bar (``repro/core/scheduler.py:305``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import scheduler as jsch
from repro.core import structure as jst
from repro.models.treelstm import TreeLSTMVertex as JTreeLSTM
from repro_torch.core import scheduler as tsch
from repro_torch.core import structure as tst
from repro_torch.interop import params_from_jax
from repro_torch.models.treelstm import TreeLSTMVertex as TTreeLSTM

TOL = 1e-4
INPUT_DIM, HIDDEN = 5, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graphs(kind, seed):
    """The same graphs for both packages."""
    def make(m, r):
        if kind == "trees":
            return [m.random_binary_tree(int(r.integers(1, 10)), r)
                    for _ in range(5)]
        if kind == "dags":                       # shared children
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
    return (jfn, jp, js.to_device(), jnp.asarray(ext),
            tfn, tp, ts.to_device("cpu"), torch.from_numpy(ext))


LEGS = ["none", "megastep"]
KINDS = ["trees", "dags", "single_leaf", "chain"]


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("kind", KINDS)
def test_execute_matches_jax(kind, leg):
    jfn, jp, jd, jext, tfn, tp, td, text = _setup(kind, 11)
    want = jsch.execute(jfn, jp, jd, jext, fusion_mode=leg).buf
    got = tsch.execute(tfn, tp, td, text, fusion_mode=leg).buf
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(
        tsch.readout_roots(got, td).numpy(),
        np.asarray(jsch.readout_roots(want, jd)), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tsch.readout_nodes(got, td).numpy(),
        np.asarray(jsch.readout_nodes(want, jd)), rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_fused_matches_opbyop_padded(kind):
    """Bucket-padded schedules (padding slots, absent children at the
    sentinel): fused ≡ op-by-op within the port."""
    *_, tfn, tp, td, text = _setup(kind, 12, pad_levels=12, pad_width=64,
                                   pad_nodes=32)
    a = tsch.execute(tfn, tp, td, text, fusion_mode="megastep").buf
    b = tsch.execute(tfn, tp, td, text, fusion_mode="none").buf
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)
    assert torch.equal(a[-1], torch.zeros_like(a[-1]))     # sentinel


def test_hoist_off_matches_jax():
    jfn, jp, jd, jext, tfn, tp, td, text = _setup("trees", 13)
    want = jsch.execute(jfn, jp, jd, jext, hoist=False).buf
    got = tsch.execute(tfn, tp, td, text, hoist=False).buf
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_fusion_resolution_matches_jax(monkeypatch):
    jfn = JTreeLSTM(input_dim=3, hidden=4)
    tfn = TTreeLSTM(input_dim=3, hidden=4)
    for mode, hoist in [("auto", True), ("none", True), ("auto", False)]:
        js = jsch.resolve_fusion(jfn, mode, hoist=hoist)
        ts = tsch.resolve_fusion(tfn, mode, hoist=hoist)
        assert (js is None) == (ts is None)
        if ts is not None:
            assert (ts.kind, ts.weight_names, ts.state_dim, ts.gate_dim) \
                == (js.kind, js.weight_names, js.state_dim, js.gate_dim)
    monkeypatch.setenv("REPRO_FUSION", "none")
    assert tsch.resolve_fusion(tfn) is None
    with pytest.raises(ValueError, match="megastep"):
        tsch.resolve_fusion(tfn, "megastep", hoist=False)
    with pytest.raises(ValueError, match="fusion_mode"):
        tsch.resolve_fusion(tfn, "bogus")


def test_vertex_apply_and_projection_match_jax():
    jfn, jp, jd, jext, tfn, tp, td, text = _setup("dags", 14)
    np.testing.assert_allclose(
        tfn.project_inputs(tp, text).numpy(),
        np.asarray(jfn.project_inputs(jp, jext)), rtol=0, atol=1e-5)


def test_init_packs_recurrent_weights():
    fn = TTreeLSTM(input_dim=3, hidden=4)
    p = fn.init(torch.Generator().manual_seed(0), device="cpu")
    assert set(p) == {"wx", "ui", "uf", "uo", "uu", "b"}
    assert p["wx"].shape == (3, 16) and p["ui"].shape == (4, 4)
    assert p["uf"].data_ptr() == p["ui"].data_ptr() + 4 * 4  # one tensor
    q = fn.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)          # seeded
