"""The port's ``lstm``, ``gru`` and ``treefc`` megasteps against the JAX
package, at the kernel layer: the plain forward
(``repro_torch.kernels.ref.level_megastep``) against JAX
``ref.level_megastep`` and the Pallas K3/K4/K5 in interpret mode; the
analytic ``level_bwd`` / ``level_param_grads`` against the JAX ones and
against JAX's autodiff oracle ``ref.level_bwd``; the plain reverse
megastep against JAX ``ref.bwd_megastep`` and the Pallas K2 in interpret
mode; the dispatch rules of ``ops`` and the wrappers' refusals on the
CPU; the workspace sizes and the kernel build table.  The CUDA kernels
are held against the plain versions on the card by
``tests/test_torch_cells_card.py``.

Every case draws a NONZERO bias (the reference's ``init`` sets ``b = 0``,
which would hide a bias in the wrong place).  Tolerance: 1e-5 absolute on
unit-scale inputs (the same fp32 math in another summation order), the
bar of the JAX package's own kernel-against-oracle tests; rows a level
does not touch are compared bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import level_megastep as jlm
from repro.kernels import level_megastep_bwd as jlmb
from repro.kernels import ref as jref
from repro_torch.core.structure import (balanced_binary_tree, chain,
                                        pack_batch, random_binary_tree)
from repro_torch.interop import params_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.obs.registry import get_registry

TOL = 1e-5
KINDS = ["lstm", "gru", "treefc"]
SM = {"lstm": 2, "gru": 1, "treefc": 1}
GM = {"lstm": 4, "gru": 3, "treefc": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(kind, rng, h, a):
    """``(w, b)`` as NumPy: ``wh`` ``[H, G]`` or ``wc`` ``[A*H, H]``, and a
    nonzero ``b``."""
    rows = a * h if kind == "treefc" else h
    cols = h if kind == "treefc" else GM[kind] * h
    w = (rng.standard_normal((rows, cols)) * rows ** -0.5).astype(np.float32)
    b = (rng.standard_normal(GM[kind] * h) * 0.3).astype(np.float32)
    return {"wc" if kind == "treefc" else "wh": w, "b": b}


def _names(kind):
    return ("wc", "b") if kind == "treefc" else ("wh", "b")


def _jw(kind, p):
    return tuple(jnp.asarray(p[k]) for k in _names(kind))


def _tw(kind, p):
    t = params_from_jax(p, "cpu")
    return tuple(t[k] for k in _names(kind))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _graphs(kind, family, rng):
    if kind == "treefc":
        if family == "balanced":
            return [balanced_binary_tree(8) for _ in range(3)], {}
        return ([random_binary_tree(int(rng.integers(1, 10)), rng)
                 for _ in range(5)], {})
    if family == "chains":                       # variable-length chains
        return [chain(int(n)) for n in rng.integers(1, 9, size=6)], {}
    return ([chain(int(n)) for n in rng.integers(1, 6, size=4)],
            {"pad_levels": 8, "pad_width": 16})


def _schedule_case(kind, family, seed, h=6):
    """A packed schedule (``pack_batch`` is byte-identical across the
    packages; Tree-FC packs at ``pad_arity=2``) with a random buffer,
    gradient buffer and ext rows (sentinels zero), all NumPy."""
    rng = np.random.default_rng(seed)
    graphs, pads = _graphs(kind, family, rng)
    if kind == "treefc":
        pads["pad_arity"] = 2
    s = pack_batch(graphs, **pads)
    R, S, G = s.T * s.M + 1, SM[kind] * h, GM[kind] * h
    buf = (rng.standard_normal((R, S)) * 0.5).astype(np.float32)
    buf[-1] = 0.0
    g = rng.standard_normal((R, S)).astype(np.float32)
    ext = (rng.standard_normal((s.K * s.N + 1, G)) * 0.5).astype(np.float32)
    ext[-1] = 0.0
    return s, dict(buf=buf, g=g, ext=ext, p=_weights(kind, rng, h, s.A))


def _level(s, c, t):
    return dict(cids=s.child_ids[t], cmask=s.child_mask[t],
                eids=s.ext_ids[t], nm=s.node_mask[t], off=t * s.M, **c)


CASES = [(k, f, seed) for k in KINDS
         for f, seed in ((("balanced", 0), ("random", 1)) if k == "treefc"
                         else (("chains", 0), ("padded", 1)))]


def _plain_fwd(kind, c):
    buf = _t(c["buf"].copy())
    out = tref.level_megastep(kind, buf, _t(c["cids"]), _t(c["cmask"]),
                              _t(c["eids"]), _t(c["nm"]), c["off"],
                              _t(c["ext"]), _tw(kind, c["p"]))
    assert out is buf                           # written in place
    return out.numpy()


@pytest.mark.parametrize("kind,family,seed", CASES)
def test_plain_forward_matches_jax_ref(kind, family, seed):
    s, c0 = _schedule_case(kind, family, seed)
    for t in range(s.T):
        c = _level(s, c0, t)
        want = jref.level_megastep(kind, jnp.asarray(c["buf"]),
                                   jnp.asarray(c["cids"]),
                                   jnp.asarray(c["cmask"]),
                                   jnp.asarray(c["eids"]),
                                   jnp.asarray(c["nm"]), c["off"],
                                   jnp.asarray(c["ext"]), _jw(kind, c["p"]))
        np.testing.assert_allclose(_plain_fwd(kind, c), np.asarray(want),
                                   rtol=0, atol=TOL, err_msg=f"level {t}")


@pytest.mark.parametrize("kind", KINDS)
def test_plain_forward_matches_jax_pallas_interpret(kind):
    """The JAX Pallas K3/K4/K5 run in interpret mode, as the JAX
    package's own tests run them on the CPU."""
    s, c0 = _schedule_case(kind, "padded" if kind != "treefc" else "random",
                           2)
    kernel = {"lstm": jlm.lstm_megastep, "gru": jlm.gru_megastep,
              "treefc": jlm.treefc_megastep}[kind]
    for t in (0, 1, s.T - 1):
        c = _level(s, c0, t)
        want = kernel(jnp.asarray(c["buf"]), jnp.asarray(c["cids"]),
                      jnp.asarray(c["eids"]), jnp.asarray(c["nm"]),
                      jnp.int32(c["off"]), jnp.asarray(c["ext"]),
                      *_jw(kind, c["p"]), interpret=True)
        np.testing.assert_allclose(_plain_fwd(kind, c), np.asarray(want),
                                   rtol=0, atol=TOL, err_msg=f"level {t}")


def test_lstm_gates_match_jax():
    """The plain LSTM gate math (forget gate +1.0) against JAX
    ``ref.lstm_gates``."""
    rng = np.random.default_rng(8)
    gates = rng.standard_normal((9, 4 * 6)).astype(np.float32)
    c_prev = rng.standard_normal((9, 6)).astype(np.float32)
    jc, jh = jref.lstm_gates(jnp.asarray(gates), jnp.asarray(c_prev))
    tc, th = tref.lstm_gates(_t(gates), _t(c_prev))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=TOL)


def _bwd_inputs(kind, seed, n=7, a=None, h=6):
    """Random cotangents and gathered child rows for ``n`` slots, some
    children masked (their rows zero, as the sentinel gives them)."""
    rng = np.random.default_rng(seed)
    a = a or (2 if kind == "treefc" else 1)
    S, G = SM[kind] * h, GM[kind] * h
    g = rng.standard_normal((n, S)).astype(np.float32)
    cmask = (rng.random((n, a)) > 0.3).astype(np.float32)
    child = (rng.standard_normal((n, a, S)).astype(np.float32)
             * cmask[..., None])
    rows = rng.standard_normal((n, G)).astype(np.float32)
    return g, child, rows, cmask, _weights(kind, rng, h, a)


@pytest.mark.parametrize("kind,seed,a", [
    ("lstm", 0, 1), ("lstm", 1, 2), ("gru", 2, 1), ("gru", 3, 3),
    ("treefc", 4, 2), ("treefc", 5, 3)])
def test_level_bwd_and_param_grads_match_jax(kind, seed, a):
    g, child, rows, cmask, p = _bwd_inputs(kind, seed, a=a)
    jg_child, jd, jaux = jlm.level_bwd(kind, jnp.asarray(g),
                                       jnp.asarray(child), jnp.asarray(rows),
                                       jnp.asarray(cmask), _jw(kind, p))
    jgrads = jlm.level_param_grads(kind, jd, jaux, _jw(kind, p))
    tg_child, td, taux = lm.level_bwd(kind, _t(g), _t(child), _t(rows),
                                      _t(cmask), _tw(kind, p))
    tgrads = lm.level_param_grads(kind, td, taux, _tw(kind, p))
    np.testing.assert_allclose(tg_child.numpy(), np.asarray(jg_child),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    assert len(tgrads) == len(jgrads) == 2
    for name, want, got in zip(_names(kind), jgrads, tgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_level_bwd_matches_autodiff_oracle(kind):
    """The analytic backward against JAX's plain ``jax.vjp`` of the naive
    cell (``ref.level_bwd``), the oracle of the JAX package (arity 1 for
    the sequence cells, whose analytic backward broadcasts the
    predecessor's cotangent over every existing child)."""
    g, child, rows, cmask, p = _bwd_inputs(kind, 6)
    want_child, want_rows, want_w = jref.level_bwd(
        kind, jnp.asarray(g), jnp.asarray(child), jnp.asarray(rows),
        jnp.asarray(cmask), _jw(kind, p))
    g_child, d_gates, aux = lm.level_bwd(kind, _t(g), _t(child), _t(rows),
                                         _t(cmask), _tw(kind, p))
    grads = lm.level_param_grads(kind, d_gates, aux, _tw(kind, p))
    np.testing.assert_allclose(g_child.numpy(), np.asarray(want_child),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(d_gates.numpy(), np.asarray(want_rows),
                               rtol=0, atol=TOL)
    for name, want, got in zip(_names(kind), want_w, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=name)


def _plain_bwd(kind, c):
    g = _t(c["g"].copy())
    out = tref.bwd_megastep(kind, g, _t(c["buf"]), _t(c["cids"]),
                            _t(c["cmask"]), _t(c["eids"]), _t(c["nm"]),
                            c["off"], _t(c["ext"]), _tw(kind, c["p"]))
    assert out is g                             # written in place
    return out.numpy()


def _assert_untouched(c, got):
    untouched = np.setdiff1d(np.arange(c["g"].shape[0]), c["cids"])
    np.testing.assert_array_equal(got[untouched].view(np.int32),
                                  c["g"][untouched].view(np.int32))


@pytest.mark.parametrize("kind,family,seed", CASES)
def test_plain_bwd_megastep_matches_jax_ref(kind, family, seed):
    s, c0 = _schedule_case(kind, family, seed + 10)
    for t in range(s.T):
        c = _level(s, c0, t)
        want = jref.bwd_megastep(kind, jnp.asarray(c["g"]),
                                 jnp.asarray(c["buf"]),
                                 jnp.asarray(c["cids"]),
                                 jnp.asarray(c["cmask"]),
                                 jnp.asarray(c["eids"]),
                                 jnp.asarray(c["nm"]), c["off"],
                                 jnp.asarray(c["ext"]), _jw(kind, c["p"]))
        got = _plain_bwd(kind, c)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL,
                                   err_msg=f"level {t}")
        _assert_untouched(c, got)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_bwd_megastep_matches_jax_pallas_interpret(kind):
    s, c0 = _schedule_case(kind, "random" if kind == "treefc" else "chains",
                           13)
    for t in (1, s.T - 1):
        c = _level(s, c0, t)
        want = jlmb.bwd_megastep(kind, jnp.asarray(c["g"]),
                                 jnp.asarray(c["buf"]),
                                 jnp.asarray(c["cids"]),
                                 jnp.asarray(c["eids"]),
                                 jnp.asarray(c["nm"]), jnp.int32(c["off"]),
                                 jnp.asarray(c["ext"]), _jw(kind, c["p"]),
                                 interpret=True)
        got = _plain_bwd(kind, c)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL,
                                   err_msg=f"level {t}")
        _assert_untouched(c, np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_ops_dispatch_cpu_to_plain_and_wrappers_refuse_cpu(kind):
    """On CPU tensors ``ops`` runs the plain versions (counted on the
    registry) and launches nothing; the kernels' own wrappers refuse CPU
    tensors, so the choice is made in one place."""
    s, c0 = _schedule_case(kind, "chains" if kind != "treefc" else "random",
                           20)
    c = _level(s, c0, 1)
    args = (_t(c["cids"]), _t(c["cmask"]), _t(c["eids"]), _t(c["nm"]),
            c["off"], _t(c["ext"]), _tw(kind, c["p"]))
    reg = get_registry()
    before = reg.counter("kernel.dispatch", op="level_megastep", impl="ref")
    lm.reset_launches()
    got = tops.level_megastep(kind, _t(c["buf"].copy()), *args)
    np.testing.assert_array_equal(got.numpy(), _plain_fwd(kind, c))
    assert reg.counter("kernel.dispatch", op="level_megastep",
                       impl="ref") == before + 1
    gb = tops.bwd_megastep(kind, _t(c["g"].copy()), _t(c["buf"]), *args)
    np.testing.assert_array_equal(gb.numpy(), _plain_bwd(kind, c))
    assert tops.bwd_workspace(kind, gb, s.M, s.A, 6) is None
    w, b = _tw(kind, c["p"])
    with pytest.raises(ValueError, match="CUDA"):
        lm.MEGASTEPS[kind](_t(c["buf"]), _t(c["cids"]), _t(c["eids"]),
                           _t(c["nm"]), c["off"], _t(c["ext"]), w, b)
    runs = torch.zeros(s.M * s.A, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lmb.bwd_megastep(kind, _t(c["g"]), _t(c["buf"]), _t(c["cids"]),
                         _t(c["eids"]), _t(c["nm"]), c["off"], _t(c["ext"]),
                         (w, b), sort_perm=runs, sorted_child_ids=runs,
                         run_head=runs)
    assert sum(lm.LAUNCHES.values()) == 0


def test_workspace_is_sized_by_kind():
    M, A, H = 10, 3, 8
    assert lmb.workspace_numel("treelstm", M, A, H) == M * (3 + 3 * A) * H
    assert lmb.workspace_numel("lstm", M, A, H) == M * (4 + 2) * H
    assert lmb.workspace_numel("gru", M, A, H) == M * (3 + 1) * H
    assert lmb.workspace_numel("treefc", M, A, H) == M * (1 + A) * H
    assert lmb.bwd_workspace("treefc", M, A, H, "cpu").numel() \
        == M * (1 + A) * H


def test_kind_widths_and_the_treefc_weight_check():
    assert lm.widths("lstm", 5) == (10, 20)
    assert lm.widths("gru", 5) == (5, 15)
    assert lm.widths("treefc", 5) == (5, 5)
    with pytest.raises(ValueError, match="unknown megastep gate kind"):
        lm.widths("bogus", 5)
    wc, b = torch.zeros(15, 5), torch.zeros(5)
    assert lm.cell_hidden("treefc", wc, 3) == 5
    assert lm.cell_hidden("gru", torch.zeros(5, 15), 3) == 5
    with pytest.raises(ValueError, match="A\\*H=2\\*5 rows, got 15"):
        lm.cell_hidden("treefc", wc, 2)
    # The reference refuses the same weight.
    with pytest.raises(ValueError, match="A\\*H=2\\*5 rows, got 15"):
        jlm.treefc_megastep(jnp.zeros((9, 5)), jnp.zeros((4, 2), jnp.int32),
                            jnp.zeros(4, jnp.int32), jnp.ones(4),
                            jnp.int32(0), jnp.zeros((3, 5)),
                            jnp.asarray(wc.numpy()), jnp.asarray(b.numpy()),
                            interpret=True)


def test_build_table_covers_every_kind(tmp_path, monkeypatch):
    """Each kind has a forward and a reverse kernel; kernels that share a
    source share its library; the library's name covers the shared
    headers its source includes, so an edited header is never served by a
    stale library and rebuilds no library that does not read it; and a
    build that fails raises instead of falling back."""
    for kind in ("treelstm", "lstm", "gru", "treefc"):
        for name in (f"{kind}_megastep", f"{kind}_bwd_megastep"):
            src = _build.KERNELS[name][0]
            assert (_build._CSRC / src).is_file(), name
    assert _build.library_path("lstm_megastep") \
        == _build.library_path("gru_megastep") \
        == _build.library_path("treefc_megastep")
    assert _build.library_path("lstm_megastep") \
        != _build.library_path("lstm_bwd_megastep")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build._CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    names = ("gru_bwd_megastep", "treelstm_megastep", "lstm_megastep",
             "treefc_megastep", "flash_attention_tf32", "lstm_gates")
    before = {n: _build.library_path(n) for n in names}
    (csrc / "cell_megastep_sm90.cu").write_text(
        (csrc / "cell_megastep_sm90.cu").read_text() + "\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["treefc_megastep"] != before["treefc_megastep"]
    for n in ("gru_bwd_megastep", "treelstm_megastep",
              "flash_attention_tf32"):
        assert after[n] == before[n], n
    (csrc / "gathered_product.cuh").write_text(
        (csrc / "gathered_product.cuh").read_text() + "\n")
    for n in ("gru_bwd_megastep", "treelstm_megastep", "lstm_megastep",
              "treefc_megastep"):
        assert _build.library_path(n) != after[n], n
    for n in ("flash_attention_tf32", "lstm_gates"):
        assert _build.library_path(n) == after[n], n
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="build failed"):
        _build.load("gru_megastep")
    assert not list((tmp_path / "build").glob("*.so"))
