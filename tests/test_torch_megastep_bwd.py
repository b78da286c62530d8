"""The port's reverse megastep and scatter-add against the JAX package:
the analytic ``level_bwd`` / ``level_param_grads``, the plain
``bwd_megastep`` (against JAX ``ref.bwd_megastep`` and against the JAX
Pallas ``bwd_megastep`` in interpret mode) and the plain
``scatter_add_rows`` (against the JAX Pallas ``scatter_add_rows`` in
interpret mode), plus the dispatch rules of ``ops``.  The CUDA kernels
are held against the plain versions on the card by
``tests/test_torch_train_card.py``.

Tolerance: 1e-5 absolute on unit-scale inputs (the same fp32 math in
another summation order), the bar of the JAX package's own
kernel-against-oracle tests (``tests/test_megastep_bwd.py``); rows a
level does not touch are compared bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import level_megastep as jlm
from repro.kernels import level_megastep_bwd as jlmb
from repro.kernels import ref as jref
from repro_torch.core.structure import pack_batch, random_dag
from repro_torch.interop import params_from_jax
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.obs.registry import get_registry

TOL = 1e-5
WEIGHTS = ("ui", "uf", "uo", "uu", "b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(rng, h):
    p = {k: (rng.standard_normal((h, h)) * h ** -0.5).astype(np.float32)
         for k in WEIGHTS[:4]}
    p["b"] = (rng.standard_normal(4 * h) * 0.1).astype(np.float32)
    return p


def _jw(p):
    return tuple(jnp.asarray(p[k]) for k in WEIGHTS)


def _tw(p):
    t = params_from_jax(p, "cpu")
    return tuple(t[k] for k in WEIGHTS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _level_case(seed, n=7, a=2, h=6):
    """Random cotangents and gathered child rows for ``n`` slots, some
    children masked."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, 2 * h)).astype(np.float32)
    child = rng.standard_normal((n, a, 2 * h)).astype(np.float32)
    rows = rng.standard_normal((n, 4 * h)).astype(np.float32)
    cmask = (rng.random((n, a)) > 0.3).astype(np.float32)
    return g, child, rows, cmask, _weights(rng, h)


@pytest.mark.parametrize("seed,a", [(0, 2), (1, 3), (2, 1)])
def test_level_bwd_and_param_grads_match_jax(seed, a):
    g, child, rows, cmask, p = _level_case(seed, a=a)
    jg_child, jd, jaux = jlm.level_bwd("treelstm", jnp.asarray(g),
                                       jnp.asarray(child), jnp.asarray(rows),
                                       jnp.asarray(cmask), _jw(p))
    jgrads = jlm.level_param_grads("treelstm", jd, jaux, _jw(p))
    tg_child, td, taux = lm.level_bwd("treelstm", _t(g), _t(child), _t(rows),
                                      _t(cmask), _tw(p))
    tgrads = lm.level_param_grads("treelstm", td, taux, _tw(p))
    np.testing.assert_allclose(tg_child.numpy(), np.asarray(jg_child),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    for name, want, got in zip(WEIGHTS, jgrads, tgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=name)


def test_level_bwd_matches_autodiff_oracle():
    """The analytic backward against JAX's plain ``jax.vjp`` of the naive
    cell (``ref.level_bwd``), the oracle of the JAX package."""
    g, child, rows, cmask, p = _level_case(3, a=2)
    want_child, want_rows, want_w = jref.level_bwd(
        "treelstm", jnp.asarray(g), jnp.asarray(child), jnp.asarray(rows),
        jnp.asarray(cmask), _jw(p))
    g_child, d_gates, aux = lm.level_bwd("treelstm", _t(g), _t(child),
                                         _t(rows), _t(cmask), _tw(p))
    grads = lm.level_param_grads("treelstm", d_gates, aux, _tw(p))
    np.testing.assert_allclose(g_child.numpy(), np.asarray(want_child),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(d_gates.numpy(), np.asarray(want_rows),
                               rtol=0, atol=TOL)
    for name, want, got in zip(WEIGHTS, want_w, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=name)


def test_other_kinds_are_not_ported_yet():
    """Every kind of the reference is ported now (their parity is in
    ``tests/test_torch_megastep_kinds.py``); what is not a kind of the
    reference raises ``ValueError``, as it does there."""
    g, child, rows, cmask, p = _level_case(4)
    for kind in ("bogus", "treelstm "):
        with pytest.raises(ValueError, match="unknown megastep gate kind"):
            lm.level_bwd(kind, _t(g), _t(child), _t(rows), _t(cmask), _tw(p))
        with pytest.raises(ValueError, match="unknown megastep gate kind"):
            lm.level_param_grads(kind, _t(rows), (), _tw(p))
        with pytest.raises(ValueError, match="unknown megastep gate kind"):
            lmb.workspace_numel(kind, 6, 2, 5)


def _bwd_case(seed, h=5, a=2):
    """One reverse level as in ``tests/test_megastep_bwd.py``: duplicate
    children across slots, a sentinel child, a masked slot."""
    rng = np.random.default_rng(seed)
    T, M, t = 4, 6, 2
    buf = rng.standard_normal((T * M + 1, 2 * h)).astype(np.float32)
    buf[-1] = 0.0
    g = rng.standard_normal((T * M + 1, 2 * h)).astype(np.float32)
    cids = rng.integers(0, t * M, size=(M, a)).astype(np.int32)
    cids[0, :] = cids[1, :]                 # duplicates across slots
    cids[2, -1] = T * M                     # sentinel child
    cmask = (cids != T * M).astype(np.float32)
    eids = rng.integers(0, 10, size=(M,)).astype(np.int32)
    ext = rng.standard_normal((11, 4 * h)).astype(np.float32)
    nm = np.ones((M,), np.float32)
    nm[-1] = 0.0                            # masked slot
    return dict(g=g, buf=buf, cids=cids, cmask=cmask, eids=eids, ext=ext,
                nm=nm, off=t * M, p=_weights(rng, h))


def _plain_bwd(c):
    g = _t(c["g"])
    out = tref.bwd_megastep("treelstm", g, _t(c["buf"]), _t(c["cids"]),
                            _t(c["cmask"]), _t(c["eids"]), _t(c["nm"]),
                            c["off"], _t(c["ext"]), _tw(c["p"]))
    assert out is g                         # written in place
    return out.numpy()


def _assert_untouched(c, got):
    untouched = np.setdiff1d(np.arange(c["g"].shape[0]), c["cids"])
    np.testing.assert_array_equal(got[untouched].view(np.int32),
                                  c["g"][untouched].view(np.int32))


@pytest.mark.parametrize("seed,a", [(13, 2), (14, 3)])
def test_plain_bwd_megastep_matches_jax_ref(seed, a):
    c = _bwd_case(seed, a=a)
    want = jref.bwd_megastep("treelstm", jnp.asarray(c["g"]),
                             jnp.asarray(c["buf"]), jnp.asarray(c["cids"]),
                             jnp.asarray(c["cmask"]), jnp.asarray(c["eids"]),
                             jnp.asarray(c["nm"]), c["off"],
                             jnp.asarray(c["ext"]), _jw(c["p"]))
    got = _plain_bwd(c)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    _assert_untouched(c, got)


@pytest.mark.parametrize("seed,a", [(13, 2), (15, 3)])
def test_plain_bwd_megastep_matches_jax_pallas_interpret(seed, a):
    c = _bwd_case(seed, a=a)
    want = jlmb.bwd_megastep("treelstm", jnp.asarray(c["g"]),
                             jnp.asarray(c["buf"]), jnp.asarray(c["cids"]),
                             jnp.asarray(c["eids"]), jnp.asarray(c["nm"]),
                             jnp.int32(c["off"]), jnp.asarray(c["ext"]),
                             _jw(c["p"]), interpret=True)
    got = _plain_bwd(c)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    _assert_untouched(c, got)
    _assert_untouched(c, np.asarray(want))


@pytest.mark.parametrize("r,d,n,seed", [(10, 5, 7, 0), (40, 24, 90, 1),
                                        (9, 3, 30, 2)])
def test_plain_scatter_add_rows_matches_jax_pallas_interpret(r, d, n, seed):
    rng = np.random.default_rng(seed)
    dst = rng.standard_normal((r, d)).astype(np.float32)
    idx = rng.integers(0, r, size=n).astype(np.int32)
    idx[: n // 3] = r - 1                   # a heavy duplicate (sentinel)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows[: n // 6] = 0.0                    # masked rows: zeros at it
    want = jlmb.scatter_add_rows(jnp.asarray(dst), jnp.asarray(idx),
                                 jnp.asarray(rows), block_r=8,
                                 interpret=True)
    got_t = _t(dst.copy())
    out = tref.scatter_add_rows(got_t, _t(idx), _t(rows))
    assert out is got_t
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    untouched = np.setdiff1d(np.arange(r), idx)
    np.testing.assert_array_equal(out.numpy()[untouched], dst[untouched])


def test_ops_dispatch_by_device_and_wrappers_refuse_cpu():
    """On CPU tensors ``ops`` runs the plain versions (counted on the
    registry) and launches nothing; the kernels' own wrappers refuse CPU
    tensors, so the choice is made in one place."""
    c = _bwd_case(16)
    reg = get_registry()
    before = reg.counter("kernel.dispatch", op="bwd_megastep", impl="ref")
    lm.reset_launches()
    got = tops.bwd_megastep("treelstm", _t(c["g"]), _t(c["buf"]),
                            _t(c["cids"]), _t(c["cmask"]), _t(c["eids"]),
                            _t(c["nm"]), c["off"], _t(c["ext"]),
                            _tw(c["p"]))
    np.testing.assert_array_equal(got.numpy(), _plain_bwd(c))
    assert reg.counter("kernel.dispatch", op="bwd_megastep",
                       impl="ref") == before + 1
    assert tops.bwd_workspace("treelstm", got, 6, 2, 5) is None
    dst = torch.zeros(4, 3)
    tops.scatter_add_rows(dst, torch.tensor([1, 1, 3], dtype=torch.int32),
                          torch.ones(3, 3))
    assert dst[:, 0].tolist() == [0.0, 2.0, 0.0, 1.0]
    assert sum(lm.LAUNCHES.values()) == 0
    sp = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lmb.bwd_megastep("treelstm", _t(c["g"]), _t(c["buf"]), _t(c["cids"]),
                         _t(c["eids"]), _t(c["nm"]), c["off"], _t(c["ext"]),
                         _tw(c["p"]), sort_perm=sp, sorted_child_ids=sp,
                         run_head=sp)
    with pytest.raises(ValueError, match="CUDA"):
        lmb.scatter_add_rows(dst, torch.zeros(1, dtype=torch.int32),
                             torch.ones(1, 3))
    assert sum(lm.LAUNCHES.values()) == 0


def test_sorted_runs_cover_each_destination_once():
    """The runs the reverse kernel walks: within a level every destination
    row is one contiguous run, in the order of the flat child ids."""
    rng = np.random.default_rng(5)
    s = pack_batch([random_dag(int(rng.integers(4, 14)), rng, max_arity=3)
                    for _ in range(6)])
    for t in range(s.T):
        flat = s.child_ids[t].reshape(-1)
        perm, sc, head = s.sort_perm[t], s.sorted_child_ids[t], s.run_head[t]
        np.testing.assert_array_equal(flat[perm], sc)
        starts = np.flatnonzero(head)
        assert len(starts) == len(np.unique(flat))
        for lo, hi in zip(starts, list(starts[1:]) + [len(sc)]):
            assert (sc[lo:hi] == sc[lo]).all()
            assert (np.diff(perm[lo:hi]) > 0).all()     # stable
