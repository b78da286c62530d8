"""K1, the Tree-LSTM forward megastep (``csrc/treelstm_megastep_sm90.cu``),
where no card is present: the per-level live count the schedule carries,
the depth split, the wrapper's launch arguments, the keyword the
scheduler and ``ops`` pass, and the kernel's arithmetic emulated in plain
PyTorch against the plain version, JAX's reference and the Pallas K1.

- ``emulate_fwd_tf32x3`` repeats what the kernels compute on a level: the
  product grid over the slots ``[0, live)`` (``live`` the host's, or M
  without one), in tiles of ``K2_BM`` slots; a tile with no child other
  than the sentinel takes the leaf formula, as do the slots ``[live, M)``
  (the leaf launch); in a tile with a child, each product's depth in
  chunks of ``K2_BK`` dealt to the ranks of the cluster as ``k1_split``
  and ``k2_chunks`` deal them, every k-step of 8 as three TF32 products
  (``cvt.rna`` on int32 bit views; small·big, big·small, big·big) into
  the chunk's fp32 sum, which is added to the rank's, the ranks' sums
  added in rank order; hsum summed
  in child order; the epilogue in the kernel's order; padding written as
  zeros.  The product's helpers are ``tests/test_torch_bwd_sm90.py``'s
  (K2's pass (a) runs the same product), the levels
  ``tests/test_torch_megastep.py``'s ``EDGE_LEVELS``, which the ``gpu``
  tests run through the kernel.
- At A 1–4 and H 5 and 72, on levels with live 0 (leaves only), 1, 63,
  64, 65 and M, a level with a tile of no child between two with
  children, an all-padding level and a level given no live count, slots
  with a sentinel child among real ones: the emulation within 1e-5 of max
  |plain| of JAX's ``ref.level_megastep`` and (at fewer shapes) of the
  Pallas K1 in interpret mode.  Measured: 2.4e-8 to 1.9e-7 of max |JAX
  ref|.  One TF32 product a k-step without the split gives 1.9e-4 to
  3.3e-4 at H 72 and misses that bar, as
  ``test_unsplit_tf32_misses_the_bar`` shows.  The
  emulation's sums round as IEEE fp32 does; the tensor core's cut, which
  ``chip_smoke.py`` and the ``gpu`` tests hold to the card's bar of 1e-4.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import level_megastep as jlm
from repro.kernels import ref as jref
from repro_torch.configs.paper import get_paper_model
from repro_torch.core import scheduler as tsch
from repro_torch.core.structure import (balanced_binary_tree, chain,
                                        level_live, pack_batch,
                                        random_binary_tree, random_dag)
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.kernels import ops
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
SMS = 132                                 # an H100 SXM's SMs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _test_module(name):
    """Another test file of this directory, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rank_sums = _test_module("test_torch_bwd_sm90").rank_sums
_megastep_tests = _test_module("test_torch_megastep")
LEVELS = _megastep_tests.EDGE_LEVELS


# ---------------------------------------------------------------------------
# The kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

def emulate_fwd_tf32x3(buf, cids, eids, nm, off, ext, weights, *, live=None,
                       sms=SMS, split3=True):
    """What K1 leaves in ``buf`` (a copy; the inputs are left as they are)
    for one level, its depth split as the kernel splits it on a card of
    ``sms`` SMs."""
    out = buf.clone()
    M, A = cids.shape
    sent = buf.shape[0] - 1
    L = M if live is None else live
    ui, uf, uo, uu, b = weights
    H = ui.shape[0]
    sig = torch.sigmoid
    x = ext[eids.long()]
    xi, xf, xo, xu = (x[:, q * H:(q + 1) * H] for q in range(4))
    bi, bf, bo, bu = (b[q * H:(q + 1) * H] for q in range(4))
    # The leaf formula: no product, no child.
    ig = sig(xi + bi)
    og = sig(xo + bo)
    c = ig * torch.tanh(xu + bu)
    h = og * torch.tanh(c)
    if L:
        ids = cids[:L].long()
        has = ids != sent
        tiles = has.any(1)
        tiles = torch.nn.functional.pad(tiles, (0, -L % lm.K2_BM))
        use = tiles.reshape(-1, lm.K2_BM).any(1).repeat_interleave(
            lm.K2_BM)[:L]
        rows = torch.where(has[..., None], buf[ids], torch.zeros(()))
        hk, ck = rows[..., H:], rows[..., :H]
        hs = hk[:, 0]
        for k in range(1, A):
            hs = hs + hk[:, k]
        p = rank_sums([[(0, hs, ui), (1, hs, uo), (2, hs, uu)]
                       + [(3 + k, hk[:, k], uf) for k in range(A)]],
                      H, lm.k1_split(L, H, sms), 3 + A, split3,
                      chunk_sums=True)
        ig = sig(xi[:L] + p[0] + bi)
        og = sig(xo[:L] + p[1] + bo)
        ug = torch.tanh(xu[:L] + p[2] + bu)
        fc = torch.zeros(L, H)
        for k in range(A):
            fc = fc + sig(xf[:L] + p[3 + k] + bf) * ck[:, k]
        cp = ig * ug + fc
        hp = og * torch.tanh(cp)
        c[:L] = torch.where(use[:, None], cp, c[:L])
        h[:L] = torch.where(use[:, None], hp, h[:L])
    keep = (nm != 0)[:, None]
    out[off:off + M] = torch.cat([torch.where(keep, c * nm[:, None], 0.0),
                                  torch.where(keep, h * nm[:, None], 0.0)],
                                 1)
    return out


# ---------------------------------------------------------------------------
# Levels
# ---------------------------------------------------------------------------

def _level(name, a, h, seed=0):
    """``test_torch_megastep.edge_level``, its weights in
    ``GateSpec.weights`` order as ``w``."""
    c = _megastep_tests.edge_level(name, a, h, seed)
    p = c.pop("params")
    c["w"] = [p[k] for k in ("ui", "uf", "uo", "uu", "b")]
    c["nm"] = c.pop("nmask")
    if c["live"] is not None:
        assert level_live(c["cids"], c["buf"].shape[0] - 1) == c["live"]
    return c


def _torch(c):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    packed = t(np.concatenate(c["w"][:4], axis=1))
    H = packed.shape[0]
    w = tuple(packed[:, q * H:(q + 1) * H] for q in range(4)) + (t(c["w"][4]),)
    return (t(c["buf"]), t(c["cids"]), t(c["eids"]), t(c["nm"]), c["off"],
            t(c["ext"]), w)


def _emulate(c, **kw):
    return emulate_fwd_tf32x3(*_torch(c), live=c["live"], **kw).numpy()


def _jax_ref(c):
    return np.asarray(jref.level_megastep(
        "treelstm", jnp.asarray(c["buf"]), jnp.asarray(c["cids"]),
        jnp.asarray(c["cmask"]), jnp.asarray(c["eids"]),
        jnp.asarray(c["nm"]), c["off"], jnp.asarray(c["ext"]),
        tuple(jnp.asarray(w) for w in c["w"])))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _outside_kept(c, got):
    M = c["cids"].shape[0]
    keep = np.ones(c["buf"].shape[0], bool)
    keep[c["off"]:c["off"] + M] = False
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  c["buf"][keep].view(np.int32))


CASES = [(n, a, h) for n in LEVELS for a in (1, 2, 3, 4) for h in (5, 72)]


@pytest.mark.parametrize("name,a,h", CASES, ids=str)
def test_emulation_matches_jax_ref(name, a, h):
    c = _level(name, a, h)
    got = _emulate(c)
    want = _jax_ref(c)
    if c["nm"].any():
        assert _rel(got, want) <= TOL
    else:
        np.testing.assert_array_equal(got, want)  # zeros
    _outside_kept(c, got)


@pytest.mark.parametrize("name,a,h", [("live65", a, 5) for a in (1, 2, 3, 4)]
                         + [("gap_tile", 2, 24), ("leaves", 3, 24)], ids=str)
def test_emulation_matches_jax_pallas_interpret(name, a, h):
    c = _level(name, a, h)
    want = np.asarray(jlm.treelstm_megastep(
        jnp.asarray(c["buf"]), jnp.asarray(c["cids"]), jnp.asarray(c["eids"]),
        jnp.asarray(c["nm"]), jnp.int32(c["off"]), jnp.asarray(c["ext"]),
        *(jnp.asarray(w) for w in c["w"]), interpret=True))
    assert _rel(_emulate(c), want) <= TOL


@pytest.mark.parametrize("name", ["live65", "gap_tile", "no_live_count"])
def test_emulation_matches_plain_and_split_does_not_matter(name):
    """The emulation against the port's plain version, with the depth
    split of a card of 132 SMs and with none (``sms=1``): both within the
    bar, so the split only reorders fp32 sums."""
    c = _level(name, 2, 72)
    buf, cids, eids, nm, off, ext, w = _torch(c)
    want = ref.level_megastep("treelstm", buf.clone(), cids,
                              torch.from_numpy(c["cmask"]), eids, nm, off,
                              ext, w)
    assert lm.k1_split(c["live"] or cids.shape[0], 72, SMS) > 1
    for sms in (SMS, 1):
        got = emulate_fwd_tf32x3(buf, cids, eids, nm, off, ext, w,
                                 live=c["live"], sms=sms)
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("a", [1, 2])
def test_unsplit_tf32_misses_the_bar(a):
    """One TF32 product a k-step, as a plain TF32 kernel would do, misses
    1e-5 of max |JAX ref|: the reason for the split."""
    c = _level("liveM", a, 72)
    err = _rel(_emulate(c, split3=False), _jax_ref(c))
    assert err > TOL, err
    assert _rel(_emulate(c), _jax_ref(c)) <= TOL


def test_leaf_rows_take_no_product():
    """Slots past ``live`` and the slots of a tile with no child get the
    leaf formula: the same values whatever the weights' recurrent
    blocks hold."""
    c = _level("gap_tile", 2, 24)
    got = _emulate(c)
    for w in c["w"][:4]:
        w[...] = np.nan
    again = _emulate(c)
    M = c["cids"].shape[0]
    rows = slice(c["off"] + 64, c["off"] + 128)   # the tile of no child
    np.testing.assert_array_equal(again[rows], got[rows])
    assert np.isnan(again[c["off"]:c["off"] + M]).any()


# ---------------------------------------------------------------------------
# The schedule's live counts and the depth split
# ---------------------------------------------------------------------------

def _recount(cids, sent):
    live = 0
    for m in range(cids.shape[0]):
        if any(v != sent for v in cids[m]):
            live = m + 1
    return live


def _schedule(name, with_runs):
    rng = np.random.default_rng(5)
    trees = [random_binary_tree(int(rng.integers(1, 30)), rng)
             for _ in range(8)]
    chains = [chain(int(n)) for n in rng.integers(1, 20, size=12)]
    dags = [random_dag(int(rng.integers(5, 20)), rng, max_arity=3)
            for _ in range(6)]
    graphs = {"trees": trees, "chains": chains, "dags": dags,
              "padded": trees + [balanced_binary_tree(8)]}[name]
    pads = {"pad_levels": 12, "pad_width": 256} if name == "padded" else {}
    return pack_batch(graphs, with_runs=with_runs, **pads)


@pytest.mark.parametrize("with_runs", [True, False])
@pytest.mark.parametrize("name", ["trees", "chains", "dags", "padded"])
def test_to_device_carries_live(name, with_runs):
    """Every schedule, packed with or without the backward's runs, carries
    each level's live count to the device as host values; K2's plan reads
    the same tuple."""
    s = _schedule(name, with_runs)
    d = s.to_device("cpu")
    want = tuple(_recount(s.child_ids[t], s.sentinel_slot)
                 for t in range(s.T))
    assert d.live == want and all(type(n) is int for n in d.live)
    assert tuple(level_live(s.child_ids, s.sentinel_slot)) == want
    assert want[0] == 0                        # leaves have no child
    if with_runs:
        assert tuple(p[0] for p in s.bwd_plans()) == want
    else:
        assert d.bwd_single is None
    if name == "padded":
        assert want[-1] == 0 and s.node_mask[-1].sum() == 0


def test_k1_split_is_k2_pass_a_split():
    """K1's product is K2's treelstm pass (a): the same tiles, chunks,
    warps and split at every level size."""
    for live in (1, 16, 64, 65, 343, 2048):
        for H in (5, 72, 512):
            assert lm.k1_grid(live, H) == lmb.k2_grid("treelstm", live, 2,
                                                      H)[0]
            assert lm.k1_split(live, H, SMS) == lmb.k2_splits(
                "treelstm", live, 2, H, SMS)[0]
    assert lm.k1_split(0, 512, SMS) == 1
    # A served level of 30 live slots at H 512: 32 tiles, split 4.
    assert lm.k1_grid(30, 512) == (32, 16, 8) and lm.k1_split(30, 512, SMS) == 4


# ---------------------------------------------------------------------------
# The wrapper's launch, stubbed; the keyword through the scheduler and ops
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """K1's wrapper on CPU tensors with the launch recorded: the fake
    entry point reports 1 CUDA launch where the level has a live count of
    0 or M and 2 else, as the kernel does."""
    calls = []

    def fake_launch(op, dev, *args, counts=()):
        calls.append((op, args))
        M, live = args[7], args[14]
        ctypes.c_int.from_address(args[-1]).value = \
            (live > 0) + (live < M)
        for key in counts or (op,):
            lm.LAUNCHES[key] += 1

    monkeypatch.setattr(lm, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(lm, "launch_kernel", fake_launch)
    monkeypatch.setattr(lm, "_sm_count", lambda dev: SMS)
    lm.reset_launches()
    yield calls
    lm.reset_launches()


def test_wrapper_passes_live_split_and_sentinel(fake_card):
    c = _level("live65", 2, 72)
    buf, cids, eids, nm, off, ext, w = _torch(c)
    R, M = buf.shape[0], cids.shape[0]
    assert lm.treelstm_megastep(buf, cids, eids, nm, off, ext, *w,
                                live=65) is buf
    lm.treelstm_megastep(buf, cids, eids, nm, off, ext, *w)
    lm.treelstm_megastep(buf, cids, eids, nm, off, ext, *w, live=0)
    (_, a1), (_, a2), (_, a3) = fake_card
    assert a1[0] == buf.data_ptr() and a1[5] == w[0].data_ptr()
    assert a1[7:16] == (M, 2, 72, off, R - 1, 144, 288, 65,
                        lm.k1_split(65, 72, SMS))
    assert a2[14] == M                         # no count: every slot
    assert a3[14:16] == (0, 1)
    assert lm.LAUNCHES["treelstm_megastep"] == 3
    assert lm.CUDA_LAUNCHES["treelstm_megastep"] == 2 + 1 + 1
    with pytest.raises(ValueError, match="live"):
        lm.treelstm_megastep(buf, cids, eids, nm, off, ext, *w, live=M + 1)
    with pytest.raises(ValueError, match="sentinel"):    # covers R - 1
        lm.treelstm_megastep(buf, cids, eids, nm, R - M, ext, *w)
    assert lm.LAUNCHES["treelstm_megastep"] == 3


def test_scheduler_and_ops_pass_live_to_the_card(monkeypatch):
    """``_megastep_forward`` hands each level's live count through
    ``ops.level_megastep`` to K1 on the card; on CPU tensors the plain
    version runs whatever it says."""
    rng = np.random.default_rng(3)
    s = pack_batch([random_binary_tree(int(rng.integers(2, 12)), rng)
                    for _ in range(6)], with_runs=False)
    d = s.to_device("cpu")
    fn = get_paper_model("tree_lstm").make_vertex(hidden=8, input_dim=4)
    params = fn.init(torch.Generator().manual_seed(0), device="cpu")
    spec = tsch.resolve_fusion(fn, "megastep", sched_arity=s.A)
    ext = torch.randn(s.K * s.N + 1, 32, generator=torch.Generator()
                      .manual_seed(1))
    ext[-1] = 0.0
    want = tsch._megastep_forward(spec, spec.weights(params), d, ext)
    seen = []

    def k1(buf, cids, eids, nm, off, ext_, *w, live=None):
        seen.append((off, live))
        cmask = (cids != buf.shape[0] - 1).float()
        return ref.level_megastep("treelstm", buf, cids, cmask, eids, nm,
                                  off, ext_, w)

    monkeypatch.setitem(lm.MEGASTEPS, "treelstm", k1)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    got = tsch._megastep_forward(spec, spec.weights(params), d, ext)
    monkeypatch.undo()
    assert seen == [(t * s.M, d.live[t]) for t in range(s.T)]
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)
    # On the CPU the keyword is ignored.
    c = _level("live65", 2, 5)
    buf, cids, eids, nm, off, ext, w = _torch(c)
    cmask = torch.from_numpy(c["cmask"])
    plain = ref.level_megastep("treelstm", buf.clone(), cids, cmask, eids,
                               nm, off, ext, w)
    got = ops.level_megastep("treelstm", buf.clone(), cids, cmask, eids, nm,
                             off, ext, w, live=0)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("kind,passed", [("lstm", {"live": 1}),
                                         ("gru", {"live": 1}),
                                         ("treefc", {"live": 1})])
def test_ops_passes_no_live_to_the_cell_kinds(monkeypatch, kind, passed):
    """``ops.level_megastep`` hands the level's live count to K3, K4 and
    K5, which stop their product there, as K1 does."""
    seen = []

    def kernel(buf, *args, **kw):
        seen.append(kw)
        return buf

    monkeypatch.setitem(lm.MEGASTEPS, kind, kernel)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    buf = torch.zeros(5, 8)
    ops.level_megastep(kind, buf, torch.zeros(2, 1, dtype=torch.int32),
                       torch.zeros(2, 1), torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2), 0, torch.zeros(3, 16),
                       (torch.zeros(4, 16), torch.zeros(16)), live=1)
    monkeypatch.undo()
    assert seen == [passed]
