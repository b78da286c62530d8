"""K3, K4 and K5, the LSTM, GRU and Tree-FC forward megasteps, and K9,
the fused LSTM level step (all in ``csrc/cell_megastep_sm90.cu``), where
no card is present: the depth split, the wrappers' launch arguments, the
keyword ``ops`` passes, and the kernels' arithmetic emulated in plain
PyTorch against the plain version, JAX's reference and the Pallas
K3/K4/K5/K9.

- ``emulate_cell_tf32x3`` repeats what K3-K5 compute on a level: the
  product grid over the slots ``[0, live)`` (``live`` the host's, or M
  without one), in tiles of ``K2_BM`` slots; a tile with no child other
  than the sentinel takes the formula of a slot with no child, as do the
  slots ``[live, M)`` (the elementwise launch); in a tile with a child,
  the predecessor's h (its whole row for gru) against each lane of
  ``W_h``, or (treefc) each child's row against its segment of ``wc``,
  the depth in chunks of ``K2_BK`` (treefc: A segments of H) dealt to the
  ranks of the cluster as ``cell_split`` and ``k2_chunks`` deal them,
  every k-step of 8 as three TF32 products (``cvt.rna`` on int32 bit
  views; small·big, big·small, big·big) into the chunk's fp32 sum,
  which is added to the rank's, the ranks' sums added in rank order; the epilogue in the kernel's order;
  padding written as zeros.  The product's helpers are
  ``tests/test_torch_bwd_sm90.py``'s (K2's lstm, gru and treefc pass (a)
  runs the same product), the levels ``tests/test_torch_cells_card.py``'s
  ``CELL_EDGES``, which the ``gpu`` tests run through the kernels.
- For lstm, gru and treefc (A 2) at H 5 and 72, on levels of M 1, 63, 64,
  65 and 128 with live 0, 1, 63, 64, M and none, padding slots, a second
  child column, and a continuous frontier's tick storing its rows at
  ``out_ids`` (pad lanes storing nothing): the emulation
  within 1e-5 of max |plain| of JAX's ``ref.level_megastep`` and (at
  fewer shapes) of the Pallas K3/K4/K5 in interpret mode.  Measured: 1.6e-8
  to 1.7e-7 of max |JAX ref| (treefc 5.2e-8 to 1.9e-7).  One TF32
  product a k-step without the split gives 1.1e-4 to 2.0e-4 at H 72 and
  misses that bar, as ``test_unsplit_tf32_misses_the_bar`` shows.
- ``emulate_k9_tf32x3`` repeats K9: its M rows read in place (strided
  views), the product as K3's with ``cell_split(M, H)``, K3's LSTM
  epilogue; bf16 rows widened (exact in TF32) and multiplied by the bf16
  route's two TF32 products a k-step, which give the three products'
  bits.  Against JAX's ``ref.lstm_level_fused`` and the Pallas K9 in
  interpret mode at 1e-5 of max |JAX| (bf16: the f32 values before the
  rounding, then the rounded outputs within one bf16 rounding), at M 3,
  7, 64 and 130 (partial tiles) and H 5, 16, 64 and 72.  Measured: 8.2e-8
  to 3.8e-7; one unsplit TF32 product 5.9e-4 at M 128, H 72.
- The emulations' sums round as IEEE fp32 does; the tensor core's cut,
  which ``chip_smoke.py`` and the ``gpu`` tests hold to the card's bar of
  1e-4.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import level_megastep as jlm
from repro.kernels import level_step as jls
from repro.kernels import ref as jref
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.kernels import level_step as ls
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
SMS = 132                                 # an H100 SXM's SMs
KINDS = ("lstm", "gru", "treefc")


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
_card_tests = _test_module("test_torch_cells_card")
EDGES = _card_tests.CELL_EDGES


# ---------------------------------------------------------------------------
# The kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

def emulate_cell_tf32x3(kind, buf, cids, eids, nm, off, ext, weights, *,
                        live=None, out_ids=None, sms=SMS, split3=True):
    """What K3 (``kind`` "lstm"), K4 ("gru") or K5 ("treefc") leaves in
    ``buf`` (a copy; the inputs are left as they are) for one level, its
    depth split as the kernel splits it on a card of ``sms`` SMs; with
    ``out_ids`` slot ``m``'s row is stored at row ``out_ids[m]`` (nowhere
    for an id outside the buffer) instead of at ``off + m``."""
    out = buf.clone()
    M, A = cids.shape
    sent = buf.shape[0] - 1
    L = M if live is None else live
    wh, b = weights
    H = wh.shape[1] if kind == "treefc" else wh.shape[0]
    nq = {"lstm": 4, "gru": 3, "treefc": 1}[kind]
    sig = torch.sigmoid
    x = ext[eids.long()]
    xl = [x[:, q * H:(q + 1) * H] for q in range(nq)]
    bl = [b[q * H:(q + 1) * H] for q in range(nq)]

    def state(v, pv, rows):
        """The epilogue at the slots ``rows`` from the products ``v`` (None:
        no product) and the predecessor's c or h ``pv`` (None: zero)."""
        xs = [xq[rows] for xq in xl]
        if kind == "lstm":
            if v is None:                     # f meets p_c = 0
                ig = sig(xs[0] + bl[0])
                og = sig(xs[2] + bl[2])
                c = ig * torch.tanh(xs[3] + bl[3])
            else:
                ig = sig(xs[0] + v[0] + bl[0])
                fg = sig(xs[1] + v[1] + bl[1] + 1.0)
                og = sig(xs[2] + v[2] + bl[2])
                ug = torch.tanh(xs[3] + v[3] + bl[3])
                c = fg * pv + ig * ug
            return torch.cat([c, og * torch.tanh(c)], 1)
        if kind == "treefc":
            return torch.tanh((xs[0] if v is None else v[0] + xs[0])
                              + bl[0])
        if v is None:
            z = sig(xs[0] + bl[0])
            r = sig(xs[1] + bl[1])
            return (1.0 - z) * torch.tanh(xs[2] + r * bl[2])
        z = sig(xs[0] + (v[0] + bl[0]))
        r = sig(xs[1] + (v[1] + bl[1]))
        n = torch.tanh(xs[2] + r * (v[2] + bl[2]))
        return (1.0 - z) * n + z * pv

    st = state(None, None, slice(0, M))
    if L:
        ids = cids[:L].long()
        has = ids != sent
        tiles = torch.nn.functional.pad(has.any(1), (0, -L % lm.K2_BM))
        use = tiles.reshape(-1, lm.K2_BM).any(1).repeat_interleave(
            lm.K2_BM)[:L]
        rows = torch.where(has[..., None], buf[ids], torch.zeros(()))
        prev = rows[:, 0]
        if kind == "treefc":               # child a against wc's segment a
            segs = [[(0, rows[:, a], wh[a * H:(a + 1) * H])]
                    for a in range(A)]
        else:
            opnd = prev[:, H:] if kind == "lstm" else prev
            segs = [[(q, opnd, wh[:, q * H:(q + 1) * H])
                     for q in range(nq)]]
        p = rank_sums(segs, H, lm.cell_split(L, H, sms, kind, A), nq, split3,
                      chunk_sums=True)
        got = state(p, prev[:, :H], slice(0, L))
        st[:L] = torch.where(use[:, None], got, st[:L])
    keep = (nm != 0)[:, None]
    st = torch.where(keep, st * nm[:, None], 0.0)
    if out_ids is None:
        out[off:off + M] = st
    else:
        ok = (out_ids >= 0) & (out_ids < out.shape[0])
        out[out_ids[ok].long()] = st[ok]
    return out


def emulate_k9_tf32x3(h_prev, c_prev, ext, wh, b, *, sms=SMS, split3=True):
    """What K9 computes for ``(h_prev, c_prev, ext, wh, b)``, in f32
    before the outputs are rounded to ``h_prev``'s type: every row's
    ``h_prev`` (widened: a bf16 value is exact in TF32) against W_h's four
    lanes, the depth split as the kernel splits it on a card of ``sms``
    SMs, bf16 rows by the bf16 route's two products a k-step (``split3``
    False: one unsplit TF32 product), then K3's epilogue in its order.
    Returns ``(c, h)``."""
    M, H = h_prev.shape
    x = h_prev.float()
    if split3 and h_prev.dtype == torch.bfloat16:
        split3 = "bf16"
    p = rank_sums([[(q, x, wh[:, q * H:(q + 1) * H]) for q in range(4)]],
                  H, lm.cell_split(M, H, sms), 4, split3, chunk_sums=True)
    xs = [ext[:, q * H:(q + 1) * H] for q in range(4)]
    bl = [b[q * H:(q + 1) * H] for q in range(4)]
    ig = torch.sigmoid(xs[0] + p[0] + bl[0])
    fg = torch.sigmoid(xs[1] + p[1] + bl[1] + 1.0)
    og = torch.sigmoid(xs[2] + p[2] + bl[2])
    ug = torch.tanh(xs[3] + p[3] + bl[3])
    c = fg * c_prev.float() + ig * ug
    return c, og * torch.tanh(c)


# ---------------------------------------------------------------------------
# Levels
# ---------------------------------------------------------------------------

def _level(kind, name, h, seed=0):
    return _card_tests.cell_edge_level(kind, name, h, seed)


def _torch(c):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return (t(c["buf"]), t(c["cids"]), t(c["eids"]), t(c["nm"]), c["off"],
            t(c["ext"]), tuple(t(w) for w in c["w"]))


def _out_ids(c):
    return None if c["out_ids"] is None else torch.from_numpy(c["out_ids"])


def _emulate(kind, c, **kw):
    return emulate_cell_tf32x3(kind, *_torch(c), live=c["live"],
                               out_ids=_out_ids(c), **kw).numpy()


def _stored(c, level):
    """What the reference leaves in level ``c``'s buffer, ``level(buf,
    off)`` its level megastep writing rows ``[off, off + M)``: for a fold
    level, the reference's composition, into a block past the buffer,
    then those rows stored at ``out_ids`` (an id outside the buffer
    dropped)."""
    if c["out_ids"] is None:
        return np.asarray(level(c["buf"], c["off"]))
    buf = c["buf"]
    R, M = buf.shape[0], c["cids"].shape[0]
    block = np.asarray(level(np.concatenate(
        [buf, np.zeros((M, buf.shape[1]), buf.dtype)]), R))[R:]
    out, ids = buf.copy(), c["out_ids"]
    ok = (ids >= 0) & (ids < R)
    out[ids[ok]] = block[ok]
    return out


def _jax_ref(kind, c):
    return _stored(c, lambda buf, off: jref.level_megastep(
        kind, jnp.asarray(buf), jnp.asarray(c["cids"]),
        jnp.asarray(c["cmask"]), jnp.asarray(c["eids"]),
        jnp.asarray(c["nm"]), off, jnp.asarray(c["ext"]),
        tuple(jnp.asarray(w) for w in c["w"])))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _outside_kept(c, got):
    keep = np.ones(c["buf"].shape[0], bool)
    keep[_card_tests.stored_rows(c)] = False
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  c["buf"][keep].view(np.int32))


@pytest.mark.parametrize("h", [5, 72])
@pytest.mark.parametrize("name", list(EDGES))
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_jax_ref(kind, name, h):
    c = _level(kind, name, h)
    got = _emulate(kind, c)
    want = _jax_ref(kind, c)
    assert _rel(got, want) <= TOL
    _outside_kept(c, got)
    pads = _card_tests.stored_rows(c, int(c["nm"].sum()))
    assert not got[pads].any()                             # padding: zeros


@pytest.mark.parametrize("kind,name,h", [
    ("lstm", "M65_live64", 5), ("gru", "M65_live64", 5),
    ("lstm", "M65_none", 24), ("gru", "fold_M64", 24),
    ("lstm", "M1_live1", 5), ("gru", "M63_liveM", 5),
    ("treefc", "M65_live64", 5), ("treefc", "M63_none", 24),
    ("treefc", "fold_M64", 5), ("treefc", "M1_live0", 5)], ids=str)
def test_emulation_matches_jax_pallas_interpret(kind, name, h):
    c = _level(kind, name, h)
    fn = {"lstm": jlm.lstm_megastep, "gru": jlm.gru_megastep,
          "treefc": jlm.treefc_megastep}[kind]
    want = _stored(c, lambda buf, off: fn(
        jnp.asarray(buf), jnp.asarray(c["cids"]), jnp.asarray(c["eids"]),
        jnp.asarray(c["nm"]), jnp.int32(off), jnp.asarray(c["ext"]),
        *(jnp.asarray(w) for w in c["w"]), interpret=True))
    assert _rel(_emulate(kind, c), want) <= TOL


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["M128_liveM", "M128_none", "fold_M64"])
def test_emulation_matches_plain_and_split_does_not_matter(kind, name):
    """The emulation against the port's plain version, with the depth
    split of a card of 132 SMs and with none (``sms=1``): both within the
    bar, so the split only reorders fp32 sums."""
    c = _level(kind, name, 72)
    buf, cids, eids, nm, off, ext, w = _torch(c)
    want = _card_tests.plain_level(kind, c)
    assert lm.cell_split(c["live"] or cids.shape[0], 72, SMS, kind,
                         cids.shape[1]) > 1
    for sms in (SMS, 1):
        got = emulate_cell_tf32x3(kind, buf, cids, eids, nm, off, ext, w,
                                  live=c["live"], out_ids=_out_ids(c),
                                  sms=sms)
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_unsplit_tf32_misses_the_bar(kind):
    """One TF32 product a k-step, as a plain TF32 kernel would do, misses
    1e-5 of max |JAX ref|: the reason for the split."""
    c = _level(kind, "M128_liveM", 72)
    err = _rel(_emulate(kind, c, split3=False), _jax_ref(kind, c))
    assert err > TOL, err
    assert _rel(_emulate(kind, c), _jax_ref(kind, c)) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_slots_with_no_predecessor_take_no_product(kind):
    """Slots past ``live`` and the slots of a tile with no child get the
    formula of no predecessor: the same values whatever ``W_h`` holds, and
    the same bits as the product path gives a slot whose predecessor is
    the sentinel."""
    c = _level(kind, "M128_none", 24)
    got = _emulate(kind, c)
    c["w"][0][...] = np.nan
    again = _emulate(kind, c)
    rows = slice(c["off"] + 64, c["off"] + 128)   # the tile of no child
    np.testing.assert_array_equal(again[rows], got[rows])
    assert np.isnan(again[c["off"]:c["off"] + 64]).any()
    # A slot of a product tile whose predecessor (treefc: every child) is
    # the sentinel.
    c = _level(kind, "M128_liveM", 24)
    sent = (c["cids"] if kind == "treefc" else c["cids"][:, :1]) \
        == c["sentinel"]
    sent = sent.all(1)
    assert sent.any()
    buf, cids, eids, nm, off, ext, w = _torch(c)
    prod = emulate_cell_tf32x3(kind, buf, cids, eids, nm, off, ext, w,
                               live=128)
    leaf = emulate_cell_tf32x3(kind, buf, cids, eids, nm, off, ext, w,
                               live=0)
    rows = torch.from_numpy(np.flatnonzero(sent)) + off
    assert torch.equal(prod[rows].view(torch.int32),
                       leaf[rows].view(torch.int32))


# ---------------------------------------------------------------------------
# The depth split
# ---------------------------------------------------------------------------

def test_cell_split_is_k2_pass_a_split():
    """K3's, K4's and K5's products are K2's lstm, gru and treefc pass
    (a): the same tiles, chunks, warps and split at every level size and
    (treefc) arity."""
    for kind in KINDS:
        for A in ((1, 2, 3, 4) if kind == "treefc" else (1,)):
            for live in (1, 16, 44, 64, 65, 128, 2048, 8192):
                for H in (5, 72, 512):
                    assert lm.cell_grid(live, H, kind, A) == lmb.k2_grid(
                        kind, live, A, H)[0]
                    assert lm.cell_split(live, H, SMS, kind, A) == \
                        lmb.k2_splits(kind, live, A, H, SMS)[0]
        assert lm.cell_split(0, 512, SMS, kind) == 1
    # A Var-LSTM level (128 slots) at H 512: 64 tiles, split 4 (256
    # CTAs); 64 slots: 32 tiles, split 8.
    assert lm.cell_grid(128, 512) == (64, 16, 4)
    assert lm.cell_split(128, 512, SMS) == 4
    assert lm.cell_grid(64, 512)[0] == 32 and lm.cell_split(64, 512, SMS) == 8


# ---------------------------------------------------------------------------
# The wrapper's launch, stubbed
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """K3-K5's and K9's wrappers on CPU tensors with the launch recorded:
    the
    fake entry point reports 1 CUDA launch where the level has a live
    count of 0 or M and 2 else, as the kernel does."""
    calls = []

    def fake_launch(op, dev, *args, counts=()):
        calls.append((op, args))
        if op != "lstm_level_fused":
            M, live = args[7], args[14]
            ctypes.c_int.from_address(args[-1]).value = \
                (live > 0) + (live < M)
        for key in counts or (op,):
            lm.LAUNCHES[key] += 1

    monkeypatch.setattr(lm, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(lm, "launch_kernel", fake_launch)
    monkeypatch.setattr(lm, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(ls, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(ls, "launch_kernel", fake_launch)
    monkeypatch.setattr(ls, "_sm_count", lambda dev: SMS)
    lm.reset_launches()
    yield calls
    lm.reset_launches()


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_passes_live_split_and_sentinel(fake_card, kind):
    c = _level(kind, "M65_live64", 72)
    buf, cids, eids, nm, off, ext, w = _torch(c)
    R, (M, A) = buf.shape[0], cids.shape
    S, G = lm.widths(kind, 72)
    op = f"{kind}_megastep"
    fn = lm.MEGASTEPS[kind]
    assert fn(buf, cids, eids, nm, off, ext, *w, live=64) is buf
    fn(buf, cids, eids, nm, off, ext, *w)
    fn(buf, cids, eids, nm, off, ext, *w, live=0)
    (o1, a1), (_, a2), (_, a3) = fake_card
    assert o1 == op
    assert a1[0] == buf.data_ptr() and a1[5] == w[0].data_ptr()
    assert a1[6] == w[1].data_ptr()
    assert a1[7:16] == (M, A, 72, off, R - 1, S, G, 64,
                        lm.cell_split(64, 72, SMS, kind, A))
    assert a2[14] == M                         # no count: every slot
    assert a3[11] == c["sentinel"] and a3[14:16] == (0, 1)
    assert lm.LAUNCHES[op] == 3
    assert lm.CUDA_LAUNCHES[op] == 2 + 1 + 1
    with pytest.raises(ValueError, match="live"):
        fn(buf, cids, eids, nm, off, ext, *w, live=M + 1)
    with pytest.raises(ValueError, match="sentinel"):     # covers R - 1
        fn(buf, cids, eids, nm, R - M, ext, *w)
    assert lm.LAUNCHES[op] == 3


def test_treefc_wrapper_takes_no_live(fake_card):
    """K5's wrapper takes the level's live count, as K1, K3 and K4 do: it
    passes ``live`` (M without one), the zero row ``sentinel`` and the
    depth split of K2's treefc pass (a) on K5's tiles and A segments of
    chunks; a count outside ``[0, M]`` raises before any launch.  At
    Tree-FC's shapes (H 512, A 2) the split fills the card at the top
    levels and leaves the big ones alone."""
    rng = np.random.default_rng(0)
    H, M, A = 8, 4, 2
    buf = torch.from_numpy(rng.standard_normal((3 * M + 1, H))
                           .astype(np.float32))
    cids = torch.full((M, A), 3 * M, dtype=torch.int32)
    args = (buf, cids, torch.zeros(M, dtype=torch.int32), torch.ones(M),
            M, torch.zeros(M + 1, H), torch.zeros(A * H, H), torch.zeros(H))
    lm.treefc_megastep(*args)
    lm.treefc_megastep(*args, live=0)
    (op, a), (_, b) = fake_card
    assert op == "treefc_megastep" and len(a) == 19
    assert a[7:16] == (M, A, H, M, 3 * M, H, H, M, 2)   # 2 chunks: 2 ranks
    assert b[14:16] == (0, 1)
    assert lm.CUDA_LAUNCHES[op] == 1 + 1
    with pytest.raises(ValueError, match="live"):
        lm.treefc_megastep(*args, live=M + 1)
    assert lm.LAUNCHES[op] == 2
    assert lm.cell_split(8192, 512, SMS, "treefc", 2) == 1
    assert lm.cell_split(64, 512, SMS, "treefc", 2) == 8
    assert lm.cell_grid(64, 512, "treefc", 2) == (8, 32, 4)


# ---------------------------------------------------------------------------
# K9, the fused LSTM level step
# ---------------------------------------------------------------------------

K9_CASES = [(3, 16), (7, 5), (64, 64), (130, 72)]


def _k9_inputs(m, h, dtype, seed=0):
    """K9's operands as the op-by-op leg gives them: ``h_prev``/``c_prev``
    the strided halves of one gathered ``[M, 2H]`` state at ``dtype``,
    float32 ``ext`` ``[M, 4H]``, ``wh`` ``[H, 4H]`` and a nonzero bias."""
    rng = np.random.default_rng(seed + 7 * m + h)
    f32 = lambda *s, k=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * k).astype(np.float32))
    state = f32(m, 2 * h).to(dtype)
    return (state[:, h:], state[:, :h], f32(m, 4 * h, k=0.5),
            f32(h, 4 * h, k=h ** -0.5), f32(4 * h, k=0.3))


def _jax_k9(args):
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in
            jref.lstm_level_fused(*(jnp.asarray(a.float().numpy()) for a in
                                    args))]


@pytest.mark.parametrize("m,h", K9_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_emulation_matches_jax_ref(m, h, dtype):
    """The emulated K9 within 1e-5 of max |JAX ref| (in f32 before the
    outputs are rounded; JAX on the same values, bf16 ones widened); the
    rounded bf16 outputs within one bf16 rounding of JAX's at bf16."""
    args = _k9_inputs(m, h, getattr(torch, dtype))
    assert args[0].stride() == (2 * h, 1)               # read in place
    got = emulate_k9_tf32x3(*args)
    for g, w in zip(got, _jax_k9(args)):
        assert _rel(g.numpy(), w) <= TOL
    if dtype == "bfloat16":
        jb = [jnp.asarray(a.float().numpy(), jnp.bfloat16)
              if a.dtype == torch.bfloat16 else jnp.asarray(a.numpy())
              for a in args]
        for g, w in zip(got, jref.lstm_level_fused(*jb)):
            w = np.asarray(w.astype(jnp.float32))
            g = g.to(torch.bfloat16).float().numpy()
            assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-30).all()
            assert (g == w).mean() >= 0.99


@pytest.mark.parametrize("m,h", [(3, 16), (130, 72)])
def test_k9_emulation_matches_jax_pallas_interpret(m, h):
    args = _k9_inputs(m, h, torch.float32)
    want = jls.lstm_level_fused(*(jnp.asarray(a.numpy()) for a in args),
                                interpret=True)
    for g, w in zip(emulate_k9_tf32x3(*args), want):
        assert _rel(g.numpy(), np.asarray(w)) <= TOL


def test_k9_split_does_not_matter_and_unsplit_tf32_misses_the_bar():
    """The depth split of a card of 132 SMs and none (``sms=1``) both
    within the bar; one TF32 product a k-step misses it."""
    args = _k9_inputs(128, 72, torch.float32)
    want = _jax_k9(args)
    assert lm.cell_split(128, 72, SMS) > 1
    for sms in (SMS, 1):
        for g, w in zip(emulate_k9_tf32x3(*args, sms=sms), want):
            assert _rel(g.numpy(), w) <= TOL
    err = max(_rel(g.numpy(), w) for g, w in
              zip(emulate_k9_tf32x3(*args, split3=False), want))
    assert err > TOL, err


def test_k9_bf16_route_is_two_products_with_three_products_bits():
    """bf16 rows are exact in TF32: the bf16 route's two products a k-step
    give the bits of the three-product split on the widened rows."""
    args = _k9_inputs(130, 72, torch.bfloat16)
    two = emulate_k9_tf32x3(*args)
    three = emulate_k9_tf32x3(args[0].float(), *args[1:])
    for a, b in zip(two, three):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_wrapper_passes_views_strides_and_split(fake_card, dtype):
    """K9's wrapper reads the strided halves in place (their addresses and
    row strides go to the kernel), picks the bf16 route by type, passes
    the split of K3's product over its M rows, and allocates fresh ``[M,
    H]`` outputs at the state's type; an empty level launches nothing."""
    m, h = 130, 72
    hp, cp, ext, wh, b = _k9_inputs(m, h, getattr(torch, dtype))
    c, hy = ls.lstm_level_fused(hp, cp, ext, wh, b)
    (op, a), = fake_card
    assert op == "lstm_level_fused" and len(a) == 14
    assert a[2:7] == (hp.data_ptr(), cp.data_ptr(), ext.data_ptr(),
                      wh.data_ptr(), b.data_ptr())
    assert a[0] == c.data_ptr() and a[1] == hy.data_ptr()
    assert a[7:14] == (m, h, 2 * h, 2 * h, 4 * h, int(dtype == "bfloat16"),
                       lm.cell_split(m, h, SMS))
    assert c.shape == hy.shape == (m, h) and c.dtype == hp.dtype
    assert c.is_contiguous() and hy.is_contiguous()
    ls.lstm_level_fused(hp[:0], cp[:0], ext[:0], wh, b)
    assert len(fake_card) == 1 and lm.LAUNCHES[op] == 1
