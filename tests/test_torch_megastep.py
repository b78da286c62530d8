"""The port's Tree-LSTM level megastep against the JAX package: the plain
version (``repro_torch.kernels.ref.level_megastep``) against JAX
``repro.kernels.ref.level_megastep`` and against the JAX Pallas kernel
``treelstm_megastep`` in interpret mode, plus the port's dispatch rules.
The hand-written CUDA kernel itself is held against the plain version
by the ``gpu``-marked tests, which skip where there is no card (and need
no JAX: the GPU machine has none, so the JAX tests skip there).

Tolerance: 1e-5 on the CPU (same fp32 math, summation order differs
only inside the matmuls); 1e-4 for the kernel on the card, the
reference's fused-vs-unfused bar (``repro/core/scheduler.py:305``)."""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:     # the GPU machine has no JAX: only the gpu tests run
    jnp = jops = jref = None

from repro_torch.core.structure import (pack_batch, random_binary_tree,
                                        random_dag)
from repro_torch.interop import pack_recurrent, params_from_jax
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.obs.registry import get_registry

CPU_TOL = 1e-5
CARD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_jax():
    if jref is None:
        pytest.skip("needs JAX (the reference package)")


def _case(kind, seed, hidden=8, level=1):
    """One level of a real packed schedule (``pack_batch`` is
    byte-identical across the packages) with a random buffer (sentinel
    row zero) and random weights, all NumPy."""
    rng = np.random.default_rng(seed)
    if kind == "tree":
        graphs = [random_binary_tree(int(rng.integers(2, 9)), rng)
                  for _ in range(4)]
    else:
        graphs = [random_dag(int(rng.integers(4, 12)), rng, max_arity=3)
                  for _ in range(4)]
    s = pack_batch(graphs)
    level = min(level, s.T - 1)
    R = s.T * s.M + 1
    buf = (rng.standard_normal((R, 2 * hidden)) * 0.5).astype(np.float32)
    buf[R - 1] = 0.0
    ext = (rng.standard_normal((s.K * s.N + 1, 4 * hidden)) * 0.5
           ).astype(np.float32)
    ext[-1] = 0.0
    p = {k: (rng.standard_normal((hidden, hidden)) * hidden ** -0.5)
         .astype(np.float32) for k in ("ui", "uf", "uo", "uu")}
    p["b"] = (rng.standard_normal(4 * hidden) * 0.1).astype(np.float32)
    return dict(buf=buf, cids=s.child_ids[level], cmask=s.child_mask[level],
                eids=s.ext_ids[level], nmask=s.node_mask[level],
                off=level * s.M, ext=ext, params=p)


def _jax_weights(c):
    return tuple(jnp.asarray(c["params"][k])
                 for k in ("ui", "uf", "uo", "uu", "b"))


def _torch_args(c, device="cpu"):
    p = params_from_jax(c["params"], device)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    return (t(c["buf"]), t(c["cids"]), t(c["cmask"]), t(c["eids"]),
            t(c["nmask"]), c["off"], t(c["ext"]),
            tuple(p[k] for k in ("ui", "uf", "uo", "uu", "b")))


CASES = [("tree", 0, 1), ("tree", 1, 2), ("dag", 2, 1), ("dag", 3, 3),
         ("tree", 4, 0)]


@pytest.mark.parametrize("kind,seed,level", CASES)
def test_plain_matches_jax_ref(kind, seed, level):
    _need_jax()
    c = _case(kind, seed, level=level)
    want = jref.level_megastep("treelstm", jnp.asarray(c["buf"]),
                               jnp.asarray(c["cids"]),
                               jnp.asarray(c["cmask"]),
                               jnp.asarray(c["eids"]),
                               jnp.asarray(c["nmask"]), c["off"],
                               jnp.asarray(c["ext"]), _jax_weights(c))
    buf, *rest = _torch_args(c)
    got = tref.level_megastep("treelstm", buf, *rest)
    assert got is buf                          # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=0, atol=CPU_TOL)


@pytest.mark.parametrize("kind,seed,level", [("tree", 5, 1), ("dag", 6, 2)])
def test_plain_matches_jax_pallas_kernel_interpret(kind, seed, level,
                                                   monkeypatch):
    """The JAX Pallas ``treelstm_megastep`` runs in interpret mode, as the
    JAX package's own tests run it on the CPU."""
    _need_jax()
    c = _case(kind, seed, level=level)
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "pallas")
    want = jops.level_megastep("treelstm", jnp.asarray(c["buf"]),
                               jnp.asarray(c["cids"]),
                               jnp.asarray(c["cmask"]),
                               jnp.asarray(c["eids"]),
                               jnp.asarray(c["nmask"]), c["off"],
                               jnp.asarray(c["ext"]), _jax_weights(c))
    buf, cids, cmask, eids, nmask, off, ext, w = _torch_args(c)
    got = tref.level_megastep("treelstm", buf, cids, cmask, eids, nmask,
                              off, ext, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=0, atol=CPU_TOL)


@pytest.mark.parametrize("kind,seed,level", CASES)
def test_wrapper_on_cpu_is_the_plain_version(kind, seed, level):
    """On a CPU tensor the op the scheduler calls
    (``ops.level_megastep``) runs the plain version and launches nothing;
    the kernel's own wrapper refuses a CPU tensor, so the choice is made
    in one place."""
    c = _case(kind, seed, level=level)
    buf, cids, cmask, eids, nmask, off, ext, w = _torch_args(c)
    want = tref.level_megastep("treelstm", buf.clone(), cids, cmask, eids,
                               nmask, off, ext, w)
    lm.reset_launches()
    got = tops.level_megastep("treelstm", buf.clone(), cids, cmask, eids,
                              nmask, off, ext, w)
    assert lm.LAUNCHES["treelstm_megastep"] == 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=CPU_TOL)
    with pytest.raises(ValueError, match="CUDA"):
        lm.treelstm_megastep(buf, cids, eids, nmask, off, ext, *w)
    assert lm.LAUNCHES["treelstm_megastep"] == 0


def test_ops_dispatch_by_device_and_counts():
    c = _case("tree", 7)
    buf, cids, cmask, eids, nmask, off, ext, w = _torch_args(c)
    reg = get_registry()
    before = reg.counter("kernel.dispatch", op="level_megastep", impl="ref")
    want = tref.level_megastep("treelstm", buf.clone(), cids, cmask, eids,
                               nmask, off, ext, w)
    got = tops.level_megastep("treelstm", buf.clone(), cids, cmask, eids,
                              nmask, off, ext, w)
    assert torch.equal(got, want)
    assert reg.counter("kernel.dispatch", op="level_megastep",
                       impl="ref") == before + 1
    # Every megastep kind is ported; an unknown kind raises on either
    # device, as the reference does.
    with pytest.raises(ValueError, match="bogus"):
        tops.level_megastep("bogus", buf, cids, cmask, eids, nmask, off, ext,
                            w)


def test_packed_recurrent_is_a_view_of_packed_params():
    p = params_from_jax(_case("tree", 0)["params"], "cpu")
    u = lm.packed_recurrent(p["ui"], p["uf"], p["uo"], p["uu"])
    assert u.shape == (8, 32) and u.is_contiguous()
    assert u.data_ptr() == p["ui"].data_ptr()           # no copy
    np.testing.assert_array_equal(
        u.numpy(), np.concatenate([p[k].numpy() for k in
                                   ("ui", "uf", "uo", "uu")], axis=1))
    loose = [p[k].clone() for k in ("ui", "uf", "uo", "uu")]
    with pytest.raises(ValueError, match="pack_recurrent"):
        lm.packed_recurrent(*loose)
    repacked = pack_recurrent(dict(zip(("ui", "uf", "uo", "uu"), loose)))
    assert torch.equal(lm.packed_recurrent(
        *(repacked[k] for k in ("ui", "uf", "uo", "uu"))), u)


# ---------------------------------------------------------------------------
# On the card (skipped where there is none)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,seed,level", CASES)
def test_kernel_matches_plain_on_card(kind, seed, level):
    _need_card()
    c = _case(kind, seed, hidden=72, level=level)
    buf, cids, cmask, eids, nmask, off, ext, w = _torch_args(c, "cuda")
    want = tref.level_megastep("treelstm", buf.clone(), cids, cmask, eids,
                               nmask, off, ext, w)
    lm.reset_launches()
    got = lm.treelstm_megastep(buf.clone(), cids, eids, nmask, off, ext, *w)
    torch.cuda.synchronize()
    assert lm.LAUNCHES["treelstm_megastep"] == 1
    assert float((got - want).abs().max()) <= CARD_TOL
    M = cids.shape[0]
    keep = torch.ones(buf.shape[0], dtype=torch.bool, device="cuda")
    keep[off:off + M] = False
    assert torch.equal(got[keep], buf[keep])


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    _need_card()
    c = _case("tree", 8)
    buf, cids, cmask, eids, nmask, off, ext, w = _torch_args(c, "cuda")
    with pytest.raises(TypeError):
        lm.treelstm_megastep(buf.double(), cids, eids, nmask, off, ext, *w)
    with pytest.raises(TypeError):
        lm.treelstm_megastep(buf, cids.long(), eids, nmask, off, ext, *w)
    with pytest.raises(ValueError):
        lm.treelstm_megastep(buf, cids, eids, nmask, buf.shape[0], ext, *w)
