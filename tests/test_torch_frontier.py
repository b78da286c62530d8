"""The port's union-frontier layer against the JAX package: the plain row
gather/scatter (``repro_torch.kernels.ref.gather_rows``/``scatter_rows``)
against JAX ``ref`` and the Pallas K6 in interpret mode; the plain
``frontier_megastep`` and ``ops.frontier_megastep`` against JAX
``ref.frontier_megastep`` and its Pallas staging composition in interpret
mode, for all four megastep kinds; ``core.scheduler.frontier_step`` on
both fusion legs, alone and over staggered cohorts against solo scoring;
and the K6 wrappers' and the frontier megastep's argument handling (one
launch a tick, the rows stored at ``out_ids``), run on the CPU with the
launch replaced by a recorder.  K6a's host ids and mapped host rows, and
the continuous engine's one sync a retiring window, are
``tests/test_torch_retire_readback.py``'s.  The folded tick's arithmetic is
``tests/test_torch_frontier_fold.py``'s; the CUDA kernels are held
against the plain versions on the card by
``tests/test_torch_serve_continuous_card.py``.

Tolerances: the row copies are exact (bit for bit); the cell math is the
same fp32 math in another summation order, held to 1e-5 absolute on
unit-scale inputs (the JAX package's kernel-against-oracle bar); whole
cohorts against solo scoring to 1e-4 (the reference's fused-vs-unfused
bar).  Every cell draws a NONZERO bias."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import scheduler as jsch
from repro.core import structure as jst
from repro.kernels import gather_scatter as jgsc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rnn as jrnn
from repro.models import treelstm as jtree
from repro_torch.core import scheduler as tsch
from repro_torch.core import structure as tst
from repro_torch.interop import params_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels import gather_scatter as gsc
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import rnn as trnn
from repro_torch.models import treelstm as ttree
from repro_torch.obs.registry import get_registry

TOL = 1e-5
KINDS = ["treelstm", "lstm", "gru", "treefc"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K6: plain gather/scatter against JAX ref and the Pallas kernel
# ---------------------------------------------------------------------------

SHAPES = [(10, 8, 4), (100, 130, 33), (64, 512, 64), (9, 3, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,d,n", SHAPES)
def test_gather_rows_matches_jax_bitwise(r, d, n, dtype):
    rng = np.random.default_rng(r + d + n)
    src32 = rng.standard_normal((r, d)).astype(np.float32)
    jsrc = jnp.asarray(src32).astype(dtype)
    idx = rng.integers(0, r, n).astype(np.int32)
    want_ref = jref.gather_rows(jsrc, jnp.asarray(idx))
    want_pallas = jgsc.gather_rows(jsrc, jnp.asarray(idx), interpret=True)
    tsrc = _t(src32).to(getattr(torch, dtype))
    np.testing.assert_array_equal(_jbits(jsrc), _bits(tsrc))
    got = tref.gather_rows(tsrc, _t(idx))
    assert got.dtype == tsrc.dtype and got.shape == (n, d)
    np.testing.assert_array_equal(_bits(got), _jbits(want_ref))
    np.testing.assert_array_equal(_bits(got), _jbits(want_pallas))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,d,n", SHAPES)
def test_scatter_rows_matches_jax_bitwise_with_drops(r, d, n, dtype):
    """Unique ids; two pad lanes past the end (the continuous engine's
    pads) are dropped, as JAX ``ref.scatter_rows`` (``mode="drop"``)
    drops them; every untouched row keeps its bits.  The Pallas K6b in
    interpret mode clamps an out-of-range id to the last row instead of
    dropping it (ROADMAP queue 3), so it is held to the in-range lanes."""
    rng = np.random.default_rng(7 * r + d + n)
    dst = rng.standard_normal((r, d)).astype(np.float32)
    live = rng.choice(r, min(n, r), replace=False).astype(np.int32)
    ids = np.concatenate([live, np.asarray([r, r + 5], np.int32)])
    rows = rng.standard_normal((ids.size, d)).astype(np.float32)
    jd, jr = (jnp.asarray(a).astype(dtype) for a in (dst, rows))
    td, tr = (_t(a).to(getattr(torch, dtype)) for a in (dst, rows))
    want = jref.scatter_rows(jd, jnp.asarray(ids), jr)
    out = td.clone()
    got = tref.scatter_rows(out, _t(ids), tr)
    assert got is out                                   # in place
    np.testing.assert_array_equal(_bits(got), _jbits(want))
    untouched = np.setdiff1d(np.arange(r), live)
    np.testing.assert_array_equal(_bits(got)[untouched], _bits(td)[untouched])
    pallas = jgsc.scatter_rows(jd, jnp.asarray(live), jr[:live.size],
                               interpret=True)
    again = tref.scatter_rows(td.clone(), _t(live), tr[:live.size])
    np.testing.assert_array_equal(_bits(again), _jbits(pallas))


def test_scatter_rows_drops_negative_ids():
    """The port drops every id outside ``[0, R)``, a negative one too
    (JAX's ``.at[].set`` would wrap -1 to the last row; no path of either
    package produces one: pads lie past the end)."""
    dst = torch.arange(12.0).reshape(4, 3)
    out = tref.scatter_rows(dst.clone(), torch.tensor([-1, 1, -4],
                                                      dtype=torch.int32),
                            -torch.ones(3, 3))
    want = dst.clone()
    want[1] = -1.0
    assert torch.equal(out, want)


def test_ops_gather_scatter_dispatch_on_cpu():
    """CPU tensors take the plain versions, counted once per call on the
    registry; the kernels' wrappers refuse CPU tensors."""
    reg = get_registry()
    reg.reset()
    src = torch.randn(6, 5)
    idx = torch.tensor([5, 0, 0, 3], dtype=torch.int32)
    assert torch.equal(tops.gather_rows(src, idx), src[idx.long()])
    dst = torch.zeros(6, 5)
    tops.scatter_rows(dst, torch.tensor([1, 9], dtype=torch.int32),
                      torch.ones(2, 5))
    assert dst[1].eq(1).all() and dst.sum() == 5
    snap = reg.snapshot()["counters"]
    assert snap["kernel.dispatch{impl=ref,op=gather_rows}"] == 1
    assert snap["kernel.dispatch{impl=ref,op=scatter_rows}"] == 1
    with pytest.raises(ValueError, match="CUDA"):
        gsc.gather_rows(src, idx)
    with pytest.raises(ValueError, match="CUDA"):
        gsc.scatter_rows(dst, idx, torch.zeros(4, 5))


def test_build_table_has_both_k6_entry_points_in_one_source():
    """K6a (the ids by value, a host destination: 12 arguments with the
    stream), K6b (device ids: 10) and the helper that maps a pinned host
    buffer all live in one source and one library."""
    for name, nargs in (("gather_rows", 12), ("scatter_rows", 10)):
        src, entry, argtypes = _build.KERNELS[name]
        assert src == "gather_scatter.cu" and entry == f"{name}_launch"
        assert len(argtypes) == nargs
        assert _build.library_path(name).name.startswith("gather_scatter-")
    src, entry, argtypes = _build.HELPERS["host_device_pointer"]
    assert src == "gather_scatter.cu" and len(argtypes) == 2
    text = (_build._CSRC / src).read_text()
    for entry in ("gather_rows_launch", "scatter_rows_launch",
                  "host_device_pointer"):
        assert f'extern "C" int {entry}(' in text
    assert f"constexpr int GATHER_CAP = {gsc.GATHER_CAP};" in text
    assert _build.library_path("gather_rows") == \
        _build.library_path("scatter_rows") == \
        _build.library_path("host_device_pointer")


class _Recorder:
    """Stands in for the kernels' launch: records its arguments and
    counts it, launching nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, device, *args):
        self.calls.append((name, args))
        lm.LAUNCHES[name] += 1


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(gsc, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(gsc, "launch_kernel", rec)
    monkeypatch.setattr(lm, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(lm, "launch_kernel", rec)
    monkeypatch.setattr(lm, "_sm_count", lambda dev: 132)   # K1's split
    lm.reset_launches()
    yield rec
    lm.reset_launches()


def test_k6_wrappers_pass_shapes_element_sizes_and_strides(recorder):
    src = torch.zeros(7, 3, dtype=torch.bfloat16)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    out = gsc.gather_rows(src, idx)
    assert out.shape == (2, 3) and out.dtype == torch.bfloat16
    name, args = recorder.calls[-1]
    assert name == "gather_rows"
    # out, no host destination, src, the ids' host address, then n, R, D,
    # the element size and the out / src / host row strides.
    assert args[0] == out.data_ptr() and args[1] is None
    assert args[2] == src.data_ptr()
    assert args[4:] == (2, 7, 3, 2, 3, 3, 0)
    dst = torch.zeros(5, 4)
    rows = torch.zeros(2, 4)
    assert gsc.scatter_rows(dst, idx, rows) is dst
    name, args = recorder.calls[-1]
    assert name == "scatter_rows" and args[:2] == (dst.data_ptr(),
                                                  rows.data_ptr())
    assert args[3:] == (2, 5, 4, 4, 4, 4)
    # No rows: nothing launched, nothing counted.
    n = len(recorder.calls)
    gsc.gather_rows(src, idx[:0])
    gsc.scatter_rows(dst, idx[:0], rows[:0])
    assert len(recorder.calls) == n
    assert lm.LAUNCHES == {"gather_rows": 1, "scatter_rows": 1}


def test_k6_wrappers_refuse_what_the_kernels_do_not_take(recorder):
    with pytest.raises(TypeError):
        gsc.gather_rows(torch.zeros(4, 3, dtype=torch.float64),
                        torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        gsc.gather_rows(torch.zeros(4, 3), torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        gsc.gather_rows(torch.zeros(3, 4).t(),
                        torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        gsc.scatter_rows(torch.zeros(4, 3), torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        gsc.scatter_rows(torch.zeros(4, 3), torch.zeros(2, dtype=torch.int32),
                         torch.zeros(1, 3))
    assert not recorder.calls


def test_cell_megastep_sentinel_argument(recorder):
    """The zero row a level's absent children read is the buffer's last
    row: the cell wrappers pass it to the kernel as the sentinel, take no
    other (the continuous frontier stores at ``out_ids`` and needs no
    staging block past it), and refuse a block over it or past the
    buffer."""
    H, M, R = 4, 3, 10
    buf = torch.zeros(R, 2 * H)
    cids = torch.zeros(M, 1, dtype=torch.int32)
    eids = torch.arange(M, dtype=torch.int32)
    nm = torch.ones(M)
    ext = torch.zeros(M, 4 * H)
    wh, b = torch.zeros(H, 4 * H), torch.zeros(4 * H)
    lm.lstm_megastep(buf, cids, eids, nm, R - 1 - M, ext, wh, b)
    # Arguments 10 and 11: the offset and the sentinel.
    assert recorder.calls[-1][1][10:12] == (R - 1 - M, R - 1)
    lm.lstm_megastep(buf, cids, eids, nm, 0, ext, wh, b)
    assert recorder.calls[-1][1][10:12] == (0, R - 1)
    with pytest.raises(ValueError, match="sentinel"):
        lm.lstm_megastep(buf, cids, eids, nm, R - M, ext, wh, b)  # covers R-1
    with pytest.raises(ValueError, match="sentinel"):
        lm.lstm_megastep(buf, cids, eids, nm, R + 1, ext, wh, b)
    with pytest.raises(ValueError):
        lm.lstm_megastep(buf, cids, eids, nm, -1, ext, wh, b)
    with pytest.raises(TypeError):
        lm.lstm_megastep(buf, cids, eids, nm, 0, ext, wh, b, sentinel=R - 1)
    assert len(recorder.calls) == 2


# ---------------------------------------------------------------------------
# frontier_megastep: plain and ops against JAX ref and the Pallas leg
# ---------------------------------------------------------------------------

def _cells(kind, H=4, X=5):
    """(JAX cell, port cell, arity) for a megastep kind."""
    if kind == "treelstm":
        return (jtree.TreeLSTMVertex(input_dim=X, hidden=H, arity=2),
                ttree.TreeLSTMVertex(input_dim=X, hidden=H, arity=2), 2)
    if kind == "treefc":
        return (jtree.TreeFCVertex(input_dim=X, hidden=H, arity=2),
                ttree.TreeFCVertex(input_dim=X, hidden=H, arity=2), 2)
    if kind == "lstm":
        return (jrnn.LSTMVertex(input_dim=X, hidden=H),
                trnn.LSTMVertex(input_dim=X, hidden=H), 1)
    return (jrnn.GRUVertex(input_dim=X, hidden=H),
            trnn.GRUVertex(input_dim=X, hidden=H), 1)


def _params(jfn, seed):
    """JAX params with a nonzero bias, as NumPy."""
    p = {k: np.asarray(v) for k, v in jfn.init(jax.random.PRNGKey(seed))
         .items()}
    p["b"] = (np.random.default_rng(seed).standard_normal(p["b"].shape)
              * 0.3).astype(np.float32)
    return p


def _frontier_case(kind, seed):
    """The inputs of the JAX package's Pallas-leg frontier test
    (``tests/test_frontier.py``): an absent child points at the zero
    sentinel row ``R`` with mask 0, one pad lane with an out-of-range
    destination, live lanes with unique in-range destinations."""
    jfn, tfn, A = _cells(kind)
    rng = np.random.default_rng(seed)
    M, R = 6, 9
    S = jfn.state_dim
    buf = (rng.standard_normal((R + 1, S)) * 0.3).astype(np.float32)
    buf[R] = 0.0
    child_mask = (rng.random((M, A)) > 0.4).astype(np.float32)
    child_ids = np.where(child_mask > 0, rng.integers(0, R, (M, A)),
                         R).astype(np.int32)
    node_mask = np.ones(M, np.float32)
    node_mask[4] = 0.0
    out = (R + 1 + np.arange(M)).astype(np.int32)
    live = np.nonzero(node_mask > 0)[0]
    out[live] = rng.choice(R, live.size, replace=False).astype(np.int32)
    rows = (rng.standard_normal((M, jfn.ext_dim)) * 0.3).astype(np.float32)
    p = _params(jfn, seed)
    return jfn, tfn, p, (buf, child_ids, child_mask, rows, node_mask, out)


def _jargs(kind, jfn, p, case):
    spec = jsch.resolve_fusion(jfn, "megastep",
                               sched_arity=case[1].shape[1])
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    return (kind, *(jnp.asarray(a) for a in case), spec.weights(jp))


def _targs(kind, tfn, p, case):
    spec = tsch.resolve_fusion(tfn, "megastep",
                               sched_arity=case[1].shape[1])
    tp = params_from_jax(p, "cpu")
    return (kind, *(_t(a) for a in case), spec.weights(tp))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_frontier_megastep_matches_jax_ref_and_pallas(kind, seed):
    jfn, tfn, p, case = _frontier_case(kind, seed)
    jargs = _jargs(kind, jfn, p, case)
    want = np.asarray(jref.frontier_megastep(*jargs))
    pallas = np.asarray(jops.frontier_megastep(*jargs, impl="pallas"))
    targs = _targs(kind, tfn, p, case)
    buf0 = targs[1].clone()
    got = tref.frontier_megastep(*targs)
    assert got is targs[1]                               # in place
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL)
    # Rows no live lane names keep their bits; the sentinel stays zero.
    R = buf0.shape[0] - 1
    live = case[5][case[4] > 0]
    untouched = np.setdiff1d(np.arange(R + 1), live)
    np.testing.assert_array_equal(_bits(got)[untouched],
                                  _bits(buf0)[untouched])
    assert not got[R].any()


@pytest.mark.parametrize("kind", KINDS)
def test_ops_frontier_megastep_on_cpu_is_the_plain_version(kind):
    """On CPU tensors ``ops.frontier_megastep`` is the plain version
    (counted), with pre-gathered rows or with ``ext_ids`` into a matrix of
    pulled rows."""
    jfn, tfn, p, case = _frontier_case(kind, 3)
    targs = _targs(kind, tfn, p, case)
    want = tref.frontier_megastep(kind, targs[1].clone(), *targs[2:])
    reg = get_registry()
    reg.reset()
    got = tops.frontier_megastep(kind, targs[1].clone(), *targs[2:])
    assert torch.equal(got, want)
    rows = targs[4]
    perm = torch.randperm(rows.shape[0] + 3,
                          generator=torch.Generator().manual_seed(0))
    table = torch.zeros(rows.shape[0] + 3, rows.shape[1])
    table[perm[:rows.shape[0]]] = rows
    got2 = tops.frontier_megastep(
        kind, targs[1].clone(), targs[2], targs[3], table, targs[5],
        targs[6], targs[7], ext_ids=perm[:rows.shape[0]].to(torch.int32))
    assert torch.equal(got2, want)
    assert reg.snapshot()["counters"][
        "kernel.dispatch{impl=ref,op=frontier_megastep}"] == 2


def test_ops_frontier_megastep_unknown_kind_raises():
    jfn, tfn, p, case = _frontier_case("lstm", 0)
    targs = _targs("lstm", tfn, p, case)
    with pytest.raises(ValueError, match="kind"):
        tops.frontier_megastep("bogus", *targs[1:])


@pytest.mark.parametrize("kind", ["treelstm", "lstm", "gru", "treefc"])
def test_staged_composition_launches_megastep_then_scatter(kind, recorder,
                                                           monkeypatch):
    """The card's leg of ``ops.frontier_megastep``, run on CPU tensors
    with the launches recorded.  The staged composition (the megastep
    into a staging block past the arena, then K6b) is folded into one
    launch: the level megastep of the kind over the arena itself, offset
    0, the arena's sentinel (row R-1) passed, ``out_ids`` and the arena's
    rows R given, so the kernel stores each lane's row at its id; no
    scatter, no staging block, no copy of the arena; without ``ext_ids``
    the lanes pull rows 0..M-1."""
    jfn, tfn, p, case = _frontier_case(kind, 0)
    kind_, buf, cids, cmask, rows, nm, out, w = _targs(kind, tfn, p, case)
    R, S = buf.shape
    M = cids.shape[0]
    arena = buf.clone()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    got = tops.frontier_megastep(kind, arena, cids, cmask, rows, nm, out, w)
    assert got is arena
    ((mname, margs),) = recorder.calls
    assert mname == f"{kind}_megastep"
    assert margs[0] == arena.data_ptr()
    assert margs[7] == M and margs[10:12] == (0, R - 1)  # offset, sentinel
    assert margs[16:18] == (out.data_ptr(), R)            # out_ids, rows
    assert margs[2] != out.data_ptr()                     # ext_ids 0..M-1
    assert lm.LAUNCHES == {f"{kind}_megastep": 1}
    assert torch.equal(arena, buf)                        # nothing else ran
    # With ext_ids, those are passed through.
    eids = torch.arange(M, dtype=torch.int32).flip(0).contiguous()
    tops.frontier_megastep(kind, arena, cids, cmask, rows, nm, out, w,
                           ext_ids=eids)
    assert recorder.calls[-1][1][2] == eids.data_ptr()
    assert "scatter_rows" not in lm.LAUNCHES


def test_megastep_out_ids_argument(recorder):
    """The forward wrappers take ``out_ids`` (``[M]`` int32 on the
    buffer's device, contiguous): its address and the buffer's rows go to
    the kernel, offset must be 0 and the block check gives way to the ids
    (a frontier may be wider than the arena); without it the address is
    null and the block is checked as before."""
    H, M, R = 4, 6, 5
    buf = torch.zeros(R, 2 * H)
    cids = torch.full((M, 1), R - 1, dtype=torch.int32)
    eids = torch.arange(M, dtype=torch.int32)
    nm = torch.ones(M)
    ext = torch.zeros(M, 4 * H)
    wh, b = torch.zeros(H, 4 * H), torch.zeros(4 * H)
    out = torch.tensor([0, 1, 2, 3, 7, 8], dtype=torch.int32)
    lm.lstm_megastep(buf, cids, eids, nm, 0, ext, wh, b, out_ids=out)
    args = recorder.calls[-1][1]
    assert args[10:12] == (0, R - 1) and args[16:18] == (out.data_ptr(), R)
    with pytest.raises(ValueError, match="offset"):
        lm.lstm_megastep(buf, cids, eids, nm, 1, ext, wh, b, out_ids=out)
    with pytest.raises(TypeError):
        lm.lstm_megastep(buf, cids, eids, nm, 0, ext, wh, b,
                         out_ids=out.long())
    with pytest.raises(ValueError, match="shape"):
        lm.lstm_megastep(buf, cids, eids, nm, 0, ext, wh, b,
                         out_ids=out[:3])
    with pytest.raises(ValueError):               # M > R: no block fits
        lm.lstm_megastep(buf, cids, eids, nm, 0, ext, wh, b)
    ui = torch.zeros(H, 4 * H)
    lm.treelstm_megastep(buf, cids, eids, nm, 0, ext,
                         *(ui[:, g * H:(g + 1) * H] for g in range(4)),
                         torch.zeros(4 * H), out_ids=out)
    assert recorder.calls[-1][1][16:18] == (out.data_ptr(), R)
    gbuf = torch.zeros(R + M + 1, H)
    lm.gru_megastep(gbuf, cids, eids, nm, R, torch.zeros(M, 3 * H),
                    torch.zeros(H, 3 * H), torch.zeros(3 * H))
    assert recorder.calls[-1][1][16:18] == (0, R + M + 1)  # null: the block


# ---------------------------------------------------------------------------
# frontier_step: both fusion legs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion", ["megastep", "none"])
@pytest.mark.parametrize("kind", KINDS)
def test_frontier_step_matches_jax_both_legs(kind, fusion):
    jfn, tfn, p, case = _frontier_case(kind, 5)
    A = case[1].shape[1]
    jspec = jsch.resolve_fusion(jfn, fusion, sched_arity=A)
    tspec = tsch.resolve_fusion(tfn, fusion, sched_arity=A)
    assert (jspec is None) == (tspec is None) == (fusion == "none")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = np.asarray(jsch.frontier_step(
        jfn, jp, *(jnp.asarray(a) for a in case), spec=jspec))
    tp = params_from_jax(p, "cpu")
    targs = [_t(a) for a in case]
    got = tsch.frontier_step(tfn, tp, *targs, spec=tspec)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # Pulled rows through ext_ids into a shuffled table: the same rows.
    rows = targs[3]
    table = torch.zeros(rows.shape[0] + 1, rows.shape[1])
    table[1:] = rows
    ids = torch.arange(1, rows.shape[0] + 1, dtype=torch.int32)
    targs2 = [_t(a) for a in case]
    targs2[3] = table
    got2 = tsch.frontier_step(tfn, tp, *targs2, spec=tspec, ext_ids=ids)
    assert torch.equal(got2, got)


def _solo_buf(fn, params, g, x, mod):
    sched = mod.pack_batch([g], pad_arity=max(1, fn.arity),
                           with_runs=False)
    ext = mod.pack_external([x], sched, fn.input_dim)
    return sched, ext


@pytest.mark.parametrize("fusion", ["megastep", "none"])
@pytest.mark.parametrize("kind", ["treelstm", "lstm", "gru"])
@pytest.mark.parametrize("seed", [0, 1])
def test_staggered_union_frontier_matches_solo(kind, fusion, seed):
    """A cohort of graphs entering a shared arena at staggered ticks, one
    level per graph per tick, levels split when the frontier is full:
    every vertex's arena row is within 1e-4 of the graph scored alone
    through the port's ``execute`` and through the JAX package's."""
    jfn, tfn, A = _cells(kind)
    p = _params(jfn, seed)
    tp = params_from_jax(p, "cpu")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    cohort = []
    for _ in range(4):
        n = int(rng.integers(1, 10))
        g = (tst.chain(n) if A == 1
             else tst.random_dag(n, rng, max_arity=A))
        x = (rng.standard_normal((n, tfn.input_dim)) * 0.4).astype(np.float32)
        cohort.append((g, x))
    starts = [int(rng.integers(0, 4)) for _ in cohort]
    width = int(rng.integers(2, 6))
    spec = tsch.resolve_fusion(tfn, fusion, sched_arity=A)

    per_graph, total = [], 0
    for g, x in cohort:
        sched, raw = _solo_buf(tfn, tp, g, x, tst)
        ext = tfn.project_inputs(tp, _t(raw))
        M = sched.M
        levels = []
        for t in range(sched.T):
            lanes = np.nonzero(sched.node_mask[t] > 0)[0]
            if lanes.size:
                levels.append((t * M + lanes, sched.child_ids[t][lanes],
                               sched.child_mask[t][lanes],
                               ext[_t(sched.ext_ids[t][lanes]).long()]))
        arena_of = np.full(sched.T * M + 1, -1, np.int64)
        arena_of[np.concatenate([lv[0] for lv in levels])] = \
            np.arange(total, total + g.num_nodes)
        per_graph.append((sched, raw, levels, arena_of))
        total += g.num_nodes
    R = total
    buf = torch.zeros(R + 1, tfn.state_dim)
    cursors = [(0, 0)] * len(cohort)
    tick = 0
    while not all(c[0] >= len(pg[2]) for c, pg in zip(cursors, per_graph)):
        parts, used = [], 0
        for i, (_s, _r, levels, arena_of) in enumerate(per_graph):
            li, lo = cursors[i]
            if tick < starts[i] or li >= len(levels) or used >= width:
                continue
            slots, cids, cmask, erows = levels[li]
            take = min(len(slots) - lo, width - used)
            sl = slice(lo, lo + take)
            a_cids = arena_of[cids[sl]]
            a_cids[a_cids < 0] = R
            parts.append((arena_of[slots[sl]], a_cids, cmask[sl], erows[sl]))
            cursors[i] = ((li + 1, 0) if lo + take >= len(slots)
                          else (li, lo + take))
            used += take
        if parts:
            child_ids = np.full((width, A), R, np.int32)
            child_mask = np.zeros((width, A), np.float32)
            ext_rows = torch.zeros(width, tfn.ext_dim)
            node_mask = np.zeros(width, np.float32)
            out_ids = (R + 1 + np.arange(width)).astype(np.int32)
            o = 0
            for dest, cids, cmask, erows in parts:
                n = len(dest)
                out_ids[o:o + n] = dest
                child_ids[o:o + n] = cids
                child_mask[o:o + n] = cmask
                ext_rows[o:o + n] = erows
                node_mask[o:o + n] = 1.0
                o += n
            with torch.no_grad():
                tsch.frontier_step(tfn, tp, buf, _t(child_ids),
                                   _t(child_mask), ext_rows, _t(node_mask),
                                   _t(out_ids), spec=spec)
        tick += 1
        assert tick < 1000
    assert not buf[R].any()
    for (g, _x), (sched, raw, levels, arena_of) in zip(cohort, per_graph):
        with torch.no_grad():
            solo = tsch.execute(tfn, tp, sched.to_device("cpu"), _t(raw),
                                fusion_mode=fusion).buf
        jsched = jst.pack_batch([jst.InputGraph(
            children=[list(c) for c in g.children])], pad_arity=A,
            with_runs=False)
        jsolo = np.asarray(jsch.execute(jfn, jp, jsched.to_device(),
                                        jnp.asarray(raw),
                                        fusion_mode=fusion).buf)
        for slots, _c, _m, _e in levels:
            arena = buf[_t(arena_of[slots])].numpy()
            np.testing.assert_allclose(arena, solo[_t(slots)].numpy(),
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(arena, jsolo[slots], rtol=0,
                                       atol=1e-4)
