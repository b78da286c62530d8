"""The port's Tree-LSTM level megastep against the JAX package: the plain
version (``repro_torch.kernels.ref.level_megastep``) against JAX
``repro.kernels.ref.level_megastep`` and against the JAX Pallas kernel
``treelstm_megastep`` in interpret mode, plus the port's dispatch rules.
The hand-written CUDA kernel itself is held against the plain version
by the ``gpu``-marked tests, which skip where there is no card (and need
no JAX: the GPU machine has none, so the JAX tests skip there): the
schedules' levels, and ``EDGE_LEVELS`` (live counts at and across a
tile's edge, leaves only, all padding, no live count), which
``tests/test_torch_fwd_sm90.py`` also feeds to its emulation of the
kernel.

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


#: K1's edge levels: name → (M, live, real slots, child slot ranges);
#: live None: the level is given no live count (the continuous
#: frontier's case).  Tiles are 64 slots, so 63, 64 and 65 cross a tile's
#: edge and "gap_tile" has a tile of no child between two with children.
EDGE_LEVELS = {
    "leaves": (70, 0, 60, ()),
    "all_padding": (70, 0, 0, ()),
    "live1": (70, 1, 70, ((0, 1),)),
    "live63": (130, 63, 130, ((0, 63),)),
    "live64": (130, 64, 130, ((0, 64),)),
    "live65": (130, 65, 100, ((0, 65),)),
    "liveM": (130, 130, 130, ((0, 130),)),
    "gap_tile": (130, 130, 130, ((0, 10), (128, 130))),
    "no_live_count": (130, None, 120, ((0, 20), (70, 90))),
}


def edge_level(name, a, h, seed=0):
    """NumPy level ``name`` of ``EDGE_LEVELS`` at offset ``off`` of a
    buffer whose rows below hold the children and whose last row is the
    zero sentinel: slots in the child ranges get ``a`` children (a fifth
    of them the sentinel, never all of a slot's), the first ``real`` slots
    are real, the rest padding (ext rows at the zero sentinel row);
    ``params`` as ``_case``'s."""
    M, live, real, ranges = EDGE_LEVELS[name]
    rng = np.random.default_rng(seed + 1000 * a + h)
    off = 3 * M
    R = off + M + 1
    buf = (rng.standard_normal((R, 2 * h)) * 0.5).astype(np.float32)
    buf[R - 1] = 0.0
    cids = np.full((M, a), R - 1, np.int32)
    for lo, hi in ranges:
        cids[lo:hi] = rng.integers(0, off, size=(hi - lo, a))
        miss = rng.random((hi - lo, a)) < 0.2
        miss[:, 0] = False
        cids[lo:hi][miss] = R - 1
    n_ext = M + 8
    ext = (rng.standard_normal((n_ext + 1, 4 * h)) * 0.5).astype(np.float32)
    ext[n_ext] = 0.0
    eids = rng.integers(0, n_ext, size=M).astype(np.int32)
    eids[real:] = n_ext
    nm = np.zeros(M, np.float32)
    nm[:real] = 1.0
    p = {k: (rng.standard_normal((h, h)) * h ** -0.5).astype(np.float32)
         for k in ("ui", "uf", "uo", "uu")}
    p["b"] = (rng.standard_normal(4 * h) * 0.1).astype(np.float32)
    return dict(buf=buf, cids=cids, cmask=(cids != R - 1).astype(np.float32),
                eids=eids, nmask=nm, off=off, ext=ext, params=p, live=live)


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
@pytest.mark.parametrize("a,h", [(1, 72), (2, 72), (3, 5), (4, 72),
                                 (2, 512)])
@pytest.mark.parametrize("name", list(EDGE_LEVELS))
def test_kernel_edge_levels_on_card(name, a, h):
    """Every edge level through K1 with its live count: within the card's
    bar of the plain version, two launches bitwise equal, rows outside
    the block (the sentinel among them) bit-unchanged, and the CUDA
    launches the design makes: the product where a slot has a child, the
    leaf launch where the slots past ``live`` are, never more than 2."""
    _need_card()
    c = edge_level(name, a, h)
    buf, cids, cmask, eids, nmask, off, ext, w = _torch_args(c, "cuda")
    M = cids.shape[0]
    live = M if c["live"] is None else c["live"]
    want = tref.level_megastep("treelstm", buf.clone(), cids, cmask, eids,
                               nmask, off, ext, w)
    lm.reset_launches()
    got = lm.treelstm_megastep(buf.clone(), cids, eids, nmask, off, ext, *w,
                               live=c["live"])
    made = lm.CUDA_LAUNCHES["treelstm_megastep"]
    again = lm.treelstm_megastep(buf.clone(), cids, eids, nmask, off, ext,
                                 *w, live=c["live"])
    torch.cuda.synchronize()
    assert lm.LAUNCHES["treelstm_megastep"] == 2
    assert made == (live > 0) + (live < M) <= 2
    assert float((got - want).abs().max()) <= CARD_TOL
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    keep = torch.ones(buf.shape[0], dtype=torch.bool, device="cuda")
    keep[off:off + M] = False
    assert torch.equal(got[keep].view(torch.int32),
                       buf[keep].view(torch.int32))
    pad = c["nmask"] == 0
    assert not got[off:off + M][torch.from_numpy(pad).cuda()].any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind,seed", [("tree", 9), ("dag", 10)])
def test_kernel_with_the_schedules_live_counts_on_card(kind, seed):
    """Each level of a packed schedule with the live count ``to_device``
    gives it, as the scheduler launches it: within the bar, and at most
    two CUDA launches a level."""
    _need_card()
    rng = np.random.default_rng(seed)
    graphs = [random_binary_tree(int(rng.integers(2, 40)), rng)
              if kind == "tree" else
              random_dag(int(rng.integers(4, 30)), rng, max_arity=3)
              for _ in range(12)]
    s = pack_batch(graphs, with_runs=False, pad_width=256)
    d = s.to_device("cuda")
    H = 72
    R = s.T * s.M + 1
    g = torch.Generator().manual_seed(seed)
    buf = (torch.randn(R, 2 * H, generator=g) * 0.5).cuda()
    buf[R - 1] = 0.0
    ext = (torch.randn(s.K * s.N + 1, 4 * H, generator=g) * 0.5).cuda()
    ext[-1] = 0.0
    p = params_from_jax({k: (rng.standard_normal((H, H)) * H ** -0.5)
                         .astype(np.float32) for k in ("ui", "uf", "uo", "uu")}
                        | {"b": (rng.standard_normal(4 * H) * 0.1)
                           .astype(np.float32)}, "cuda")
    w = tuple(p[k] for k in ("ui", "uf", "uo", "uu", "b"))
    for t in range(s.T):
        args = (d.child_ids[t], d.ext_ids[t], d.node_mask[t], t * s.M, ext)
        want = tref.level_megastep("treelstm", buf.clone(), args[0],
                                   d.child_mask[t], *args[1:], w)
        lm.reset_launches()
        got = lm.treelstm_megastep(buf.clone(), *args, *w, live=d.live[t])
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= CARD_TOL, t
        assert lm.CUDA_LAUNCHES["treelstm_megastep"] == \
            (d.live[t] > 0) + (d.live[t] < s.M)


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
    with pytest.raises(ValueError, match="live"):
        lm.treelstm_megastep(buf, cids, eids, nmask, off, ext, *w,
                             live=cids.shape[0] + 1)
    with pytest.raises(ValueError, match="sentinel"):    # covers it
        lm.treelstm_megastep(buf, cids, eids, nmask,
                             buf.shape[0] - cids.shape[0], ext, *w)
