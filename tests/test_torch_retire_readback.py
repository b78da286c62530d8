"""K6a with the ids by value and a mapped host destination, and the
continuous engine's retirement with one sync a retiring window, on the
CPU with the card replaced by fakes.

- The wrapper (``gather_scatter.gather_rows``) with its launch replaced by
  an emulation of the kernel on host memory (``ctypes`` copies of each
  row, through the pointers the wrapper passes): one launch per
  ``GATHER_CAP`` ids, the ids read from the host address in the launch's
  arguments, the rows equal to the plain gather bit for bit on both
  destinations, out-of-range ids as zero rows; ids on a device and a host
  destination that is not pinned, not mapped or the wrong shape raise.
- ``ContinuousBatchEngine`` with ``torch.Tensor.is_cuda`` patched to
  ``True`` (so the engine and ``ops`` take their card branches on CPU
  tensors), the op-by-op leg's K6b and K6a emulated: each retiring window
  makes one K6a launch per ``GATHER_CAP`` roots, with the root rows by
  value and the engine's pinned buffer as the host destination, creates
  no tensor on a device for the ids, and syncs once (the head's read of
  its logits, else the stream's); the buffer grows to the next power of
  two when a window retires more than it holds, and never otherwise; the
  roots, logits and labels equal the plain CPU engine's bit for bit.
- K8a's launch geometry (``cell_kernels.k8a_geometry``), a pure host
  function: at every 4-wide shape of the Var-LSTM levels and wider the
  grid puts at least two CTAs on each of the H100's 132 SMs; the wrapper
  passes what it chose.

The kernels themselves are held against their plain versions on the card
by ``tests/test_torch_serve_continuous_card.py`` and
``tests/test_torch_cell_kernels_card.py``."""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.structure import chain
from repro_torch.kernels import _build
from repro_torch.kernels import cell_kernels as ck
from repro_torch.kernels import gather_scatter as gsc
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import ref
from repro_torch.models.readout import ClassificationHead
from repro_torch.models.rnn import LSTMVertex
from repro_torch.serve import (AdmissionPolicy, ContinuousBatchEngine,
                               ContinuousRequest)

X, H = 4, 3
CAP = gsc.GATHER_CAP
SMS = 132                     # an H100 SXM's streaming multiprocessors


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _ints(addr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(addr)) \
        .copy() if n else np.zeros(0, np.int32)


class _Card:
    """The K6 launches emulated on host memory, as the kernels do them:
    each row copied (or zeroed, for a gather id outside ``[0, R)``) to
    every destination the launch names.  Records each launch's name,
    arguments and the ids it carried."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, device, *args):
        if name == "gather_rows":
            out, host, src, ids, n, R, D, es, so, ss, sh = args
            idv = _ints(ids, n)
            for i, r in enumerate(idv):
                for dst, stride in ((out, so), (host, sh)):
                    if dst is None:
                        continue
                    at = dst + i * stride * es
                    if 0 <= r < R:
                        ctypes.memmove(at, src + int(r) * ss * es, D * es)
                    else:
                        ctypes.memset(at, 0, D * es)
        elif name == "scatter_rows":
            dst, rows, idx, n, R, D, es, sd, sr = args
            idv = _ints(idx, n)
            for i, r in enumerate(idv):
                if 0 <= r < R:
                    ctypes.memmove(dst + int(r) * sd * es,
                                   rows + i * sr * es, D * es)
        else:
            raise AssertionError(f"unexpected launch {name}")
        self.calls.append((name, args, idv))
        lm.LAUNCHES[name] += 1


def _fake_pointer(host, dev):
    """``host_device_pointer`` under unified addressing: the host's own
    address."""
    dev._obj.value = host
    return 0


@pytest.fixture
def card(monkeypatch):
    """K6 launches emulated, host tensors taken as pinned and mapped."""
    rec = _Card()
    monkeypatch.setattr(gsc, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(gsc, "launch_kernel", rec)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a: True)
    real_load = _build.load
    monkeypatch.setattr(_build, "load", lambda name: _fake_pointer
                        if name == "host_device_pointer" else real_load(name))
    lm.reset_launches()
    yield rec
    lm.reset_launches()


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0, 1, 7, CAP, CAP + 1, 2 * CAP + 3])
def test_gather_launch_per_capacity_ids_by_value(card, n, dtype):
    """One launch per ``GATHER_CAP`` ids; each carries its ids' host
    address and count; both destinations equal the plain gather bit for
    bit; the host buffer's rows past ``n`` keep their bits."""
    R, D = 300, 5
    gen = torch.Generator().manual_seed(n)
    src = torch.randn(R, D, generator=gen).to(dtype)
    idx = torch.randint(0, R, (n,), generator=gen, dtype=torch.int32)
    host = torch.full((n + 3, D), 7.0, dtype=dtype)
    out = gsc.gather_rows(src, idx, host_out=host)
    want = ref.gather_rows(src, idx)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(_bits(host[:n]), _bits(want))
    assert bool((host[n:] == 7.0).all())
    assert lm.LAUNCHES.get("gather_rows", 0) == -(-n // CAP)
    carried = [ids for name, _a, ids in card.calls]
    assert len(carried) == -(-n // CAP)
    assert all(len(c) <= CAP for c in carried)
    np.testing.assert_array_equal(
        np.concatenate(carried) if carried else np.zeros(0, np.int32),
        idx.numpy())
    for c, (_name, args, _ids) in enumerate(card.calls):
        es = src.element_size()
        assert args[0] == out.data_ptr() + c * CAP * D * es
        assert args[1] == host.data_ptr() + c * CAP * D * es
        assert args[2] == src.data_ptr() and args[8:] == (D, D, D)


def test_gather_ids_from_numpy_and_out_of_range_rows(card):
    """A numpy id array is taken as it is; an id outside ``[0, R)`` gives
    a zero row on both destinations (the kernel's guard)."""
    src = torch.randn(6, 4)
    idx = np.array([5, -1, 0, 6, 99], np.int32)
    host = torch.empty(8, 4)
    out = gsc.gather_rows(src, idx, host_out=host)
    want = torch.stack([src[5], torch.zeros(4), src[0], torch.zeros(4),
                        torch.zeros(4)])
    assert torch.equal(out, want) and torch.equal(host[:5], want)


def test_gather_refuses_ids_on_a_device(card):
    """K6a takes the ids by value: ids on a device raise ``TypeError``
    (never quietly copied back), as do ids of another type."""
    src = torch.zeros(4, 3)
    with pytest.raises(TypeError, match="host"):
        gsc.gather_rows(src, torch.zeros(2, dtype=torch.int32,
                                         device="meta"))
    with pytest.raises(TypeError):
        gsc.gather_rows(src, np.zeros(2, np.int64))
    with pytest.raises(TypeError):
        gsc.gather_rows(src, np.zeros((2, 1), np.int32))
    assert not card.calls


def test_gather_refuses_an_unmapped_host_destination(card, monkeypatch):
    """``host_out`` must be pinned and mapped, of ``src``'s type, with at
    least ``n`` rows of width ``D``: else the wrapper raises and launches
    nothing."""
    src = torch.zeros(4, 3)
    idx = torch.zeros(2, dtype=torch.int32)
    monkeypatch.setattr(_build, "load", lambda name: lambda h, d: 1)
    with pytest.raises(RuntimeError, match="not mapped"):
        gsc.gather_rows(src, idx, host_out=torch.zeros(2, 3))
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a: False)
    with pytest.raises(ValueError, match="page-locked"):
        gsc.gather_rows(src, idx, host_out=torch.zeros(2, 3))
    for bad in (torch.zeros(1, 3), torch.zeros(2, 4),
                torch.zeros(2, 3, dtype=torch.bfloat16),
                torch.zeros(3, 2).t()):
        with pytest.raises(ValueError, match="host_out"):
            gsc.gather_rows(src, idx, host_out=bad)
    assert not card.calls


def test_host_pointer_adds_the_offset_into_the_block(card):
    """The mapped address is taken for the tensor's block and the
    tensor's offset added, so a view into a pinned block maps too."""
    block = torch.zeros(10, 4)
    assert gsc.host_pointer("op", block[3:]) == block[3:].data_ptr()


# ---------------------------------------------------------------------------
# The engine's retirement
# ---------------------------------------------------------------------------

def _lstm():
    fn = LSTMVertex(X, H)
    gen = torch.Generator().manual_seed(4)
    params = fn.init(gen, device="cpu")
    params["b"] = torch.randn(params["b"].shape, generator=gen) * 0.3
    head = ClassificationHead(fn.state_dim, 3)
    return fn, params, head, head.init(gen, device="cpu")


def _requests(sizes, seed=5):
    rng = np.random.default_rng(seed)
    return [ContinuousRequest(i, chain(n), (rng.standard_normal((n, X))
                                            * 0.4).astype(np.float32))
            for i, n in enumerate(sizes)]


def _engine(with_head, width):
    fn, params, head, hp = _lstm()
    kw = dict(head=head, head_params=hp) if with_head else {}
    return ContinuousBatchEngine(
        fn, params, num_rows=64, frontier_width=width, fusion_mode="none",
        device="cpu", policy=AdmissionPolicy(min_occupancy=0.0,
                                             max_window=4), **kw)


class _Stream:
    def __init__(self):
        self.syncs = 0

    def synchronize(self):
        self.syncs += 1


@pytest.fixture
def card_engine(card, monkeypatch):
    """The card branches taken on CPU tensors; the stream's syncs counted,
    the host buffers' allocations recorded, and tensor creation on a
    device inside a retirement's readback recorded."""
    stream = _Stream()
    allocs, made = [], []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: stream)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    real_rows = gsc.host_rows

    def host_rows(n, D, dtype, pinned):
        allocs.append((n, pinned))
        return real_rows(n, D, dtype, False)

    monkeypatch.setattr(gsc, "host_rows", host_rows)
    real_tensor, real_to = torch.tensor, torch.Tensor.to
    inside = [False]

    def tensor(*a, **kw):
        if inside[0] and kw.get("device") is not None:
            made.append(("torch.tensor", kw["device"]))
        return real_tensor(*a, **kw)

    def to(self, *a, **kw):
        if inside[0]:
            made.append(("Tensor.to", a, kw))
        return real_to(self, *a, **kw)

    monkeypatch.setattr(torch, "tensor", tensor)
    monkeypatch.setattr(torch.Tensor, "to", to)
    return stream, allocs, made, inside


def _watch_readback(eng, inside):
    """Wrap ``eng._readback``: flag its extent and keep each window's
    retired root rows."""
    inner, windows = eng._readback, []

    def readback(done):
        windows.append([a.root_row for a in done])
        inside[0] = True
        try:
            return inner(done)
        finally:
            inside[0] = False

    eng._readback = readback
    return windows


def _plain_run(sizes, with_head, width):
    eng = _engine(with_head, width)
    reqs = _requests(sizes)
    for r in reqs:
        assert eng.submit(r), r.error
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("with_head", [True, False])
@pytest.mark.parametrize("sizes,width", [
    ([5], 4),                                   # one request
    ([3, 7, 5, 12, 1, 9, 2, 4, 6], 4),          # many, several windows
    ([1] * 20 + [3, 2], 24),                    # 20 roots in one window
])
def test_retire_one_launch_by_value_one_sync(card_engine, card, sizes,
                                             width, with_head):
    stream, allocs, made, inside = card_engine
    eng = _engine(with_head, width)
    windows = _watch_readback(eng, inside)
    reqs = _requests(sizes)
    for r in reqs:
        assert eng.submit(r), r.error
    eng.run()
    assert all(r.status == "ok" for r in reqs)
    gathers = [(args, ids) for name, args, ids in card.calls
               if name == "gather_rows"]
    # One launch a retiring window (none retires more than GATHER_CAP),
    # its ids the window's root rows, by value; its host destination the
    # engine's buffer as it was at that window.
    assert len(windows) == eng.readbacks == len(gathers) > 0
    for rows, (args, ids) in zip(windows, gathers):
        np.testing.assert_array_equal(ids, rows)
        assert args[1] is not None
    assert args[1] == eng._host.data_ptr()
    assert not made, made
    # One sync a window: the head's read of its logits, or the stream's.
    assert stream.syncs == (0 if with_head else eng.readbacks)
    # The buffer: allocated pinned once, grown only for a window that
    # retires more than it holds, to the next power of two.
    most = max(len(w) for w in windows)
    want = [(ContinuousBatchEngine.HOST_ROWS, True)]
    if most > ContinuousBatchEngine.HOST_ROWS:
        want.append((1 << (most - 1).bit_length(), True))
    assert allocs == want
    assert eng._host.shape[0] == want[-1][0]
    # The same roots, logits and labels as the plain engine, bit for bit.
    _, plain = _plain_run(sizes, with_head, width)
    for r, p in zip(reqs, plain):
        np.testing.assert_array_equal(r.root_state.view(np.int32),
                                      p.root_state.view(np.int32))
        if with_head:
            np.testing.assert_array_equal(r.logits.view(np.int32),
                                          p.logits.view(np.int32))
            assert r.label == p.label
        else:
            assert r.logits is None


def test_retire_past_capacity_takes_one_launch_per_capacity(card_engine,
                                                            card,
                                                            monkeypatch):
    """A window that retires more roots than a launch carries takes one
    further launch per ``GATHER_CAP`` (here 4, to keep the engine small),
    all counted, none with ids on a device."""
    _stream, _allocs, made, inside = card_engine
    monkeypatch.setattr(gsc, "GATHER_CAP", 4)
    eng = _engine(True, 24)
    windows = _watch_readback(eng, inside)
    reqs = _requests([1] * 10)
    for r in reqs:
        assert eng.submit(r), r.error
    eng.run()
    assert [len(w) for w in windows] == [10]
    assert lm.LAUNCHES["gather_rows"] == 3
    ids = [i for name, _a, i in card.calls if name == "gather_rows"]
    assert [len(i) for i in ids] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(ids), windows[0])
    assert not made
    _, plain = _plain_run([1] * 10, True, 24)
    for r, p in zip(reqs, plain):
        np.testing.assert_array_equal(r.logits, p.logits)


def test_cpu_engine_fills_its_host_buffer_unpinned():
    """On the CPU the plain gather fills the same buffer (not pinned: no
    card to map it into); it grows as on the card."""
    eng, reqs = _plain_run([1] * 20, True, 24)
    assert not eng._host.is_pinned()
    assert eng._host.shape == (32, eng.fn.state_dim)
    assert all(r.status == "ok" for r in reqs)


# ---------------------------------------------------------------------------
# K8a's geometry
# ---------------------------------------------------------------------------

#: K8a's 4-wide shapes on the main path (the Var-LSTM levels, M 128,
#: H 512) and wider ones of the same model.
K8A_PATH_SHAPES = [(128, 512), (256, 512), (1024, 512), (128, 1024),
                   (2048, 512)]


@pytest.mark.parametrize("M,Hd", K8A_PATH_SHAPES)
def test_k8a_geometry_covers_every_sm_twice(M, Hd):
    V, nt = ck.k8a_geometry(M, Hd, SMS, True)
    assert (V, nt) in ck.K8A_GEOMETRIES
    assert -(-M * (Hd // V) // nt) >= 2 * SMS
    # No candidate before it would have filled the card: the most work a
    # CTA that still does.
    before = ck.K8A_GEOMETRIES[:ck.K8A_GEOMETRIES.index((V, nt))]
    assert all(-(-M * (Hd // v) // n) < 2 * SMS for v, n in before)


def test_k8a_geometry_at_the_var_lstm_level():
    """M 128, H 512: 2 columns a thread in blocks of 64, 512 CTAs (the
    parent's 4 in blocks of 256 gave 64 CTAs)."""
    assert ck.k8a_geometry(128, 512, SMS, True) == (2, 64)
    assert -(-128 * 256 // 64) == 512


@pytest.mark.parametrize("M,Hd", [(1, 8), (3, 4), (37, 52), (64, 512)])
def test_k8a_geometry_small_shapes_take_the_most_ctas(M, Hd):
    """Where no candidate fills the card, the one with the most CTAs."""
    assert ck.k8a_geometry(M, Hd, SMS, True) == ck.K8A_GEOMETRIES[-1]


def test_k8a_geometry_ragged_route():
    assert ck.k8a_geometry(128, 512, SMS, False) == (1, 256)
    assert ck.k8a_geometry(37, 50, SMS, False) == (1, 256)


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, name, device, *args):
        self.calls.append((name, args))
        lm.LAUNCHES[name] += 1


@pytest.mark.parametrize("M,Hd,stride,want", [
    (128, 512, 1024, (2, 64)),                  # a strided c half
    (1024, 512, 512, (4, 256)),
    (128, 512, 1025, (1, 256)),                 # a row stride off 4
    (37, 50, 50, (1, 256)),                     # H off 4
])
def test_k8a_wrapper_passes_its_geometry(monkeypatch, M, Hd, stride, want):
    rec = _Recorder()
    monkeypatch.setattr(ck, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(ck, "launch_kernel", rec)
    monkeypatch.setattr(lm, "_sm_count", lambda dev: SMS)
    gates = torch.zeros(M, 4 * Hd)
    c_prev = torch.zeros(M, stride)[:, :Hd]
    c, h = ck.lstm_gates(gates, c_prev)
    (name, args), = rec.calls
    assert name == "lstm_gates"
    assert args[4:] == (M, Hd, 4 * Hd, stride, 0, 0) + want
    assert c.shape == h.shape == (M, Hd)
