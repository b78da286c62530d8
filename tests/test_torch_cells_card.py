"""The ``lstm``, ``gru`` and ``treefc`` megastep kernels on the card: the
forward kernels (K3, K4, K5) and the reverse megastep (K2) of each kind
against their plain versions, at small widths and at the paper's H = 512,
with M = 1 and all-padding levels, the forward kernels given the
schedule's live counts; K3, K4 and K5 on ``CELL_EDGES`` (live counts at
and across a tile's edge, none, padding, a continuous frontier's tick
storing its rows at ``out_ids``; K5 with two children a slot), which
``tests/test_torch_cell_sm90.py`` also feeds to its emulation of the
kernels; rows a launch does not touch bit-unchanged; two launches
bitwise equal; the CUDA launches of the forward kernels' design; training
gradients that repeat bit for bit and match the op-by-op leg; and the
refusals: a wrong arity, a too-small workspace and a failed build raise
instead of falling back to the plain version.  Every test here is
``gpu``-marked and skips inside its body where there is no card; none
needs JAX, which the GPU machine lacks.

Tolerance: the kernels' error relative to max |plain| <= 1e-4, the
reference's fused-vs-unfused bar (``repro/core/scheduler.py:305``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import scheduler as tsch
from repro_torch.core.structure import (balanced_binary_tree, chain,
                                        pack_batch, random_binary_tree,
                                        random_dag)
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.models.rnn import GRUVertex, LSTMVertex
from repro_torch.models.treelstm import TreeFCVertex

TOL = 1e-4
SM = {"lstm": 2, "gru": 1, "treefc": 1}
GM = {"lstm": 4, "gru": 3, "treefc": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _graphs(kind, family, rng):
    if kind == "treefc":
        if family == "balanced":
            return [balanced_binary_tree(64) for _ in range(4)]
        if family == "single":                    # levels of one slot
            return [balanced_binary_tree(4)]
        if family == "dag":                       # runs of several
            return [random_dag(int(rng.integers(6, 24)), rng, max_arity=2)
                    for _ in range(6)]
        return [random_binary_tree(int(rng.integers(1, 40)), rng)
                for _ in range(8)]
    if family == "single":                        # M = 1
        return [chain(5)]
    return [chain(int(n)) for n in rng.integers(1, 30, size=70)]


def _levels(kind, family, h, seed=0, dev="cuda", **pads):
    """Every level of a packed schedule with its sorted runs, random
    buffer, gradient and ext rows (sentinels zero) and weights with a
    nonzero bias."""
    rng = np.random.default_rng(seed)
    if kind == "treefc":
        pads = dict(pads, pad_arity=2)
    s = pack_batch(_graphs(kind, family, rng), with_runs=True, **pads)
    d = s.to_device(dev)
    R, S, G = s.T * s.M + 1, SM[kind] * h, GM[kind] * h
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa
    buf = rng.standard_normal((R, S)) * 0.5
    buf[-1] = 0.0
    ext = rng.standard_normal((s.K * s.N + 1, G)) * 0.5
    ext[-1] = 0.0
    rows = s.A * h if kind == "treefc" else h
    w = rng.standard_normal((rows, h if kind == "treefc" else G)) \
        * rows ** -0.5
    b = rng.standard_normal(G) * 0.3
    return (s, d, f32(buf), f32(rng.standard_normal((R, S))), f32(ext),
            (f32(w), f32(b)))


#: K3/K4/K5 edge levels: name → (M, live, real slots, A, fold).
#: ``live`` None: the level is given no live count (the decode engine, the
#: chain frontier), and its children lie in the first third of the slots,
#: so a 64-slot tile past them has none; slots ``[real, M)`` are padding;
#: ``fold``: a continuous frontier's tick, its slots stored at
#: ``out_ids`` rather than at a block (see :func:`cell_edge_level`).
#: Tiles are 64 slots.  K5 (``treefc``) takes every level with A 2, as a
#: Tree-FC batch packs it.
CELL_EDGES = {
    "M1_live0": (1, 0, 1, 1, False), "M1_live1": (1, 1, 1, 1, False),
    "M1_none": (1, None, 1, 1, False),
    "M63_live1": (63, 1, 63, 1, False), "M63_liveM": (63, 63, 50, 1, False),
    "M63_none": (63, None, 63, 1, False),
    "M64_live0": (64, 0, 64, 1, False), "M64_live63": (64, 63, 64, 1, False),
    "M64_liveM": (64, 64, 64, 2, False),
    "M65_live64": (65, 64, 65, 1, False), "M65_liveM": (65, 65, 60, 1, False),
    "M65_none": (65, None, 65, 2, False),
    "M128_live0": (128, 0, 100, 1, False),
    "M128_live1": (128, 1, 128, 1, False),
    "M128_live63": (128, 63, 128, 1, False),
    "M128_live64": (128, 64, 128, 1, False),
    "M128_liveM": (128, 128, 90, 1, False),
    "M128_none": (128, None, 128, 1, False),
    "fold_M64": (64, None, 44, 1, True),
    "fold_M128": (128, None, 128, 1, True),
}


def cell_edge_level(kind, name, h, seed=0):
    """NumPy level ``name`` of ``CELL_EDGES`` for kind ``kind`` at width
    ``h``: a buffer whose last row, the sentinel, is zero and whose rows
    ``[0, 2M)`` hold the predecessors; slots before ``live`` get a
    predecessor (a fifth of them the sentinel, never slot ``live - 1``'s;
    with A 2 the second column too); the first ``real`` slots are real,
    the rest padding (ext rows at the zero row); ``wh`` ``[h, G]`` (for
    ``treefc`` ``wc`` ``[A·h, h]``, A 2) and a nonzero bias.  The level
    writes rows ``[2M, 3M)`` (``off``); a ``fold`` level stores them at
    ``out_ids`` instead (``off`` 0), a shuffle of those rows for the real
    slots and the first pad slot (a masked lane: a zero row) and ids past
    the buffer or below zero for the other pad slots, which store
    nothing."""
    M, live, real, a, fold = CELL_EDGES[name]
    if kind == "treefc":
        a = 2
    S, G = SM[kind] * h, GM[kind] * h
    rng = np.random.default_rng(seed + sum(map(ord, name)) + h)
    sent = 3 * M
    off, R = 2 * M, sent + 1
    buf = (rng.standard_normal((R, S)) * 0.5).astype(np.float32)
    buf[sent] = 0.0
    lo = 2 * M                                    # rows a child may be
    hi = -(-M // 3) if live is None else live     # slots with a child
    cids = np.full((M, a), sent, np.int32)
    cids[:hi] = rng.integers(0, lo, size=(hi, a))
    cids[:hi][rng.random((hi, a)) < 0.2] = sent
    if hi:
        cids[hi - 1, 0] = rng.integers(0, lo)
    n_ext = M + 8
    ext = (rng.standard_normal((n_ext + 1, G)) * 0.5).astype(np.float32)
    ext[n_ext] = 0.0
    eids = rng.integers(0, n_ext, size=M).astype(np.int32)
    eids[real:] = n_ext
    nm = np.zeros(M, np.float32)
    nm[:real] = 1.0
    rows = a * h if kind == "treefc" else h
    wh = (rng.standard_normal((rows, G)) * rows ** -0.5).astype(np.float32)
    b = (rng.standard_normal(G) * 0.3).astype(np.float32)
    out_ids = None
    if fold:
        off = 0
        out_ids = (2 * M + rng.permutation(M)).astype(np.int32)
        out_ids[real + 1::2] = R + 5
        out_ids[real + 2::2] = -1
    return dict(buf=buf, cids=cids, cmask=(cids != sent).astype(np.float32),
                eids=eids, nm=nm, off=off, ext=ext, w=(wh, b), live=live,
                sentinel=sent, out_ids=out_ids)


def dest_rows(c) -> np.ndarray:
    """The row each slot of level ``c`` is stored at: ``off + m``, or
    ``out_ids[m]`` for a fold level (an id outside the buffer stores
    nothing)."""
    if c["out_ids"] is None:
        return np.arange(c["off"], c["off"] + c["cids"].shape[0])
    return c["out_ids"]


def stored_rows(c, first=0) -> np.ndarray:
    """The rows of the buffer that slots ``[first, M)`` of level ``c``
    write, the ids outside the buffer left out."""
    ids = dest_rows(c)[first:]
    return ids[(ids >= 0) & (ids < c["buf"].shape[0])]


def plain_level(kind, c, device="cpu") -> torch.Tensor:
    """The port's plain version of level ``c`` on a copy of its buffer on
    ``device``: ``ref.level_megastep`` at ``off``, or for a fold level
    ``ref.frontier_megastep`` (the rows stored at ``out_ids``)."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), device=device)

    buf, cids, cmask, eids, nm, ext = (t(c[k]) for k in (
        "buf", "cids", "cmask", "eids", "nm", "ext"))
    w = tuple(t(x) for x in c["w"])
    if c["out_ids"] is None:
        return ref.level_megastep(kind, buf, cids, cmask, eids, nm, c["off"],
                                  ext, w)
    return ref.frontier_megastep(kind, buf, cids, cmask,
                                 ext.index_select(0, eids.long()), nm,
                                 t(c["out_ids"]), w)


def _rel(got, want):
    return float((got - want).abs().max()) \
        / max(float(want.abs().max()), 1e-30)


def _bits(t):
    return t.view(torch.int32)


CASES = [("lstm", "chains", 72, {}), ("lstm", "single", 16, {}),
         ("lstm", "chains", 512, {"pad_levels": 40, "pad_width": 128}),
         ("gru", "chains", 72, {}), ("gru", "single", 16, {}),
         ("gru", "chains", 512, {"pad_levels": 40, "pad_width": 128}),
         ("treefc", "random", 72, {"pad_levels": 12, "pad_width": 256}),
         ("treefc", "balanced", 512, {}),
         ("lstm", "chains", 20, {}), ("gru", "chains", 20, {}),
         ("treefc", "random", 20, {}), ("treefc", "single", 20, {}),
         ("treefc", "dag", 72, {}), ("lstm", "chains", 6, {})]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,family,h,pads", CASES)
def test_forward_and_reverse_kernels_match_plain_on_card(kind, family, h,
                                                         pads):
    _need_card()
    s, d, buf, g, ext, w = _levels(kind, family, h, **pads)
    ws = lmb.bwd_workspace(kind, s.M, s.A, h, "cuda")
    lm.reset_launches()
    launches = f"{kind}_bwd_megastep.cuda_launches"
    for t in range(s.T):
        lvl = (d.child_ids[t], d.child_mask[t], d.ext_ids[t], d.node_mask[t],
               t * s.M, ext, w)
        want = ref.level_megastep(kind, buf.clone(), *lvl)
        cuda0 = lm.CUDA_LAUNCHES[f"{kind}_megastep"]
        got = lm.MEGASTEPS[kind](buf.clone(), d.child_ids[t], d.ext_ids[t],
                                 d.node_mask[t], t * s.M, ext, *w,
                                 live=d.live[t])
        again = lm.MEGASTEPS[kind](buf.clone(), d.child_ids[t],
                                   d.ext_ids[t], d.node_mask[t], t * s.M,
                                   ext, *w, live=d.live[t])
        assert lm.CUDA_LAUNCHES[f"{kind}_megastep"] - cuda0 == \
            2 * ((d.live[t] > 0) + (d.live[t] < s.M)), t
        wantb = ref.bwd_megastep(kind, g.clone(), buf, *lvl)
        before = lm.LAUNCHES[launches]
        bargs = (buf, d.child_ids[t], d.ext_ids[t], d.node_mask[t], t * s.M,
                 ext, w)
        gotb = lmb.bwd_megastep(kind, g.clone(), *bargs, workspace=ws,
                                **tsch._level_runs(d, t))
        made = lm.LAUNCHES[launches] - before
        againb = lmb.bwd_megastep(kind, g.clone(), *bargs, workspace=ws,
                                  **tsch._level_runs(d, t))
        torch.cuda.synchronize()
        assert _rel(got, want) <= TOL, ("forward", t)
        assert _rel(gotb, wantb) <= TOL, ("reverse", t)
        assert torch.equal(_bits(got), _bits(again)), ("forward", t)
        assert torch.equal(_bits(gotb), _bits(againb)), t
        live, single = d.live[t], d.bwd_single[t]
        assert made == (0 if live == 0 else 2 if single else 3), t
        keep = torch.ones(buf.shape[0], dtype=torch.bool, device="cuda")
        keep[t * s.M:(t + 1) * s.M] = False
        assert torch.equal(_bits(got[keep]), _bits(buf[keep])), t
        touched = torch.zeros(g.shape[0], dtype=torch.bool, device="cuda")
        touched[d.child_ids[t].reshape(-1).long()] = True
        touched[-1] = False                       # the sentinel is kept
        assert torch.equal(_bits(gotb[~touched]), _bits(g[~touched])), t
        if not bool(d.node_mask[t].any()):        # an all-padding level
            assert not bool(got[t * s.M:(t + 1) * s.M].any())
    assert lm.LAUNCHES[f"{kind}_megastep"] == 2 * s.T
    work = sum(1 for live in d.live if live)
    assert lm.LAUNCHES[f"{kind}_bwd_megastep"] == 2 * work
    if family == "dag":
        assert not all(d.bwd_single), "no level with a run of several"


@pytest.mark.gpu
@pytest.mark.parametrize("h", [5, 72, 512])
@pytest.mark.parametrize("name", list(CELL_EDGES))
@pytest.mark.parametrize("kind", ["lstm", "gru", "treefc"])
def test_cell_edge_levels_on_card(kind, name, h):
    """K3/K4/K5 on ``CELL_EDGES`` with the keywords the main path gives them:
    within 1e-4 of max |plain|, rows the level does not store (the sentinel
    among them) bit-unchanged, two launches bitwise equal, the CUDA launches of
    the design (the product where a slot may have a predecessor, the
    elementwise launch past ``live``), at most 2."""
    _need_card()
    c = cell_edge_level(kind, name, h)
    f32 = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    buf, cids, eids, nm, ext = (f32(c[k]) for k in
                                ("buf", "cids", "eids", "nm", "ext"))
    w = tuple(f32(x) for x in c["w"])
    M, off, live = cids.shape[0], c["off"], c["live"]
    kw = {"live": live}
    if c["out_ids"] is not None:
        kw["out_ids"] = torch.from_numpy(c["out_ids"]).cuda()
    want = plain_level(kind, c, "cuda")
    lm.reset_launches()
    got = lm.MEGASTEPS[kind](buf.clone(), cids, eids, nm, off, ext, *w, **kw)
    again = lm.MEGASTEPS[kind](buf.clone(), cids, eids, nm, off, ext, *w,
                               **kw)
    torch.cuda.synchronize()
    n = M if live is None else live
    rows = torch.from_numpy(stored_rows(c)).long().cuda()
    pads = torch.from_numpy(stored_rows(c, int(c["nm"].sum()))).long().cuda()
    assert lm.LAUNCHES[f"{kind}_megastep"] == 2
    assert lm.CUDA_LAUNCHES[f"{kind}_megastep"] == 2 * ((n > 0) + (n < M))
    if c["nm"].any():
        assert _rel(got, want) <= TOL
    else:
        assert not bool(got[rows].any())
    assert torch.equal(_bits(got), _bits(again))
    keep = torch.ones(buf.shape[0], dtype=torch.bool, device="cuda")
    keep[rows] = False
    assert torch.equal(_bits(got[keep]), _bits(buf[keep]))
    assert not bool(got[pads].any())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lstm", "gru", "treefc"])
def test_reverse_runs_of_several_on_card(kind):
    """A hand-built level whose slots share children (runs of two and
    three contributions, so the kernel's run pass), its plan built by the
    wrapper: against the plain version, untouched rows bit-unchanged,
    three CUDA launches, a second launch bitwise equal."""
    _need_card()
    s, d, buf, g, ext, w = _levels(kind, "chains" if kind != "treefc"
                                   else "random", 72)
    t = 1
    cids = d.child_ids[t].clone()
    live = int((cids != s.T * s.M).any(1).nonzero().max()) + 1
    assert live >= 3
    cids[:live] = cids[0]                         # one run per child column
    cids[1, 0] = s.T * s.M                        # a sentinel child
    flat = cids.reshape(-1)
    perm = torch.sort(flat.cpu().long(), stable=True)[1].int().cuda()
    runs = dict(sort_perm=perm, sorted_child_ids=flat[perm.long()],
                run_head=torch.zeros_like(flat))
    lvl = (cids, (cids != s.T * s.M).float(), d.ext_ids[t], d.node_mask[t],
           t * s.M, ext, w)
    want = ref.bwd_megastep(kind, g.clone(), buf, *lvl)
    lm.reset_launches()
    bargs = (buf, cids, d.ext_ids[t], d.node_mask[t], t * s.M, ext, w)
    got = lmb.bwd_megastep(kind, g.clone(), *bargs, **runs)
    again = lmb.bwd_megastep(kind, g.clone(), *bargs, **runs)
    torch.cuda.synchronize()
    assert lm.LAUNCHES[f"{kind}_bwd_megastep.cuda_launches"] == 6
    assert _rel(got, want) <= TOL
    assert torch.equal(_bits(got), _bits(again))
    touched = torch.zeros(g.shape[0], dtype=torch.bool, device="cuda")
    touched[flat.long()] = True
    touched[-1] = False
    assert torch.equal(_bits(got[~touched]), _bits(g[~touched]))


def _cell(kind, x, h):
    return {"lstm": LSTMVertex, "gru": GRUVertex,
            "treefc": TreeFCVertex}[kind](input_dim=x, hidden=h)


def _grads(fn, params, sched, ext, cot, fusion_mode):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    e = ext.clone().requires_grad_()
    buf = tsch.execute_lazy(fn, leaves, e, sched, fusion_mode=fusion_mode)
    buf.backward(cot)
    return {**{k: v.grad for k, v in leaves.items()}, "external": e.grad}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lstm", "gru", "treefc"])
def test_training_gradients_repeat_bitwise_and_match_opbyop(kind):
    _need_card()
    h, x = 72, 16
    rng = np.random.default_rng(3)
    fn = _cell(kind, x, h)
    params = fn.init(torch.Generator().manual_seed(3), device="cuda")
    params["b"] = torch.from_numpy((rng.standard_normal(params["b"].shape)
                                    * 0.3).astype(np.float32)).cuda()
    s = pack_batch(_graphs(kind, "random" if kind == "treefc" else "chains",
                           rng), pad_width=256, with_runs=True,
                   **({"pad_arity": 2} if kind == "treefc" else {}))
    ext = np.zeros((s.K * s.N + 1, x), np.float32)
    ext[:-1] = rng.standard_normal((s.K * s.N, x)) * 0.5
    ext = torch.from_numpy(ext).cuda()
    cot = torch.from_numpy(rng.standard_normal(
        (s.T * s.M + 1, fn.state_dim)).astype(np.float32)).cuda()
    d = s.to_device("cuda")
    lm.reset_launches()
    first = _grads(fn, params, d, ext, cot, "auto")
    work = sum(1 for live in d.live if live)
    assert lm.LAUNCHES[f"{kind}_megastep"] == s.T
    assert lm.LAUNCHES[f"{kind}_bwd_megastep"] == work
    assert lm.LAUNCHES[f"{kind}_bwd_megastep.cuda_launches"] == 2 * work
    assert lm.LAUNCHES["scatter_add_rows"] == 1
    second = _grads(fn, params, d, ext, cot, "auto")
    oracle = _grads(fn, params, d, ext, cot, "none")
    torch.cuda.synchronize()
    for k, v in first.items():
        assert torch.equal(_bits(v), _bits(second[k])), k
        assert _rel(v, oracle[k]) <= TOL, k


@pytest.mark.gpu
def test_wrong_arity_and_small_workspace_raise():
    _need_card()
    s, d, buf, g, ext, (wc, b) = _levels("treefc", "random", 16)
    t = 1
    with pytest.raises(ValueError, match="A\\*H=3\\*16 rows, got 32"):
        lm.treefc_megastep(buf, d.child_ids[t].repeat(1, 2)[:, :3]
                           .contiguous(), d.ext_ids[t], d.node_mask[t],
                           t * s.M, ext, wc, b)
    wide = torch.zeros((s.M, 5), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="rows"):
        lm.treefc_megastep(buf, wide, d.ext_ids[t], d.node_mask[t], t * s.M,
                           ext, wc, b)
    wc5 = torch.zeros((5 * 16, 16), device="cuda")
    with pytest.raises(NotImplementedError, match="arity 5"):
        lm.treefc_megastep(buf, wide, d.ext_ids[t], d.node_mask[t], t * s.M,
                           ext, wc5, b)
    runs = dict(sort_perm=d.sort_perm[t],
                sorted_child_ids=d.sorted_child_ids[t],
                run_head=d.run_head[t])
    small = torch.empty(lmb.workspace_numel("treefc", s.M, s.A, 16) - 1,
                        device="cuda")
    before = g.clone()
    lm.reset_launches()
    with pytest.raises(ValueError, match="workspace"):
        lmb.bwd_megastep("treefc", g, buf, d.child_ids[t], d.ext_ids[t],
                         d.node_mask[t], t * s.M, ext, (wc, b),
                         workspace=small, **runs)
    # a gru-sized workspace is too small for an lstm level
    s2, d2, buf2, g2, ext2, w2 = _levels("lstm", "chains", 16)
    ws = torch.empty(lmb.workspace_numel("gru", s2.M, s2.A, 16),
                     device="cuda")
    with pytest.raises(ValueError, match="workspace"):
        lmb.bwd_megastep("lstm", g2, buf2, d2.child_ids[1], d2.ext_ids[1],
                         d2.node_mask[1], s2.M, ext2, w2, workspace=ws,
                         sort_perm=d2.sort_perm[1],
                         sorted_child_ids=d2.sorted_child_ids[1],
                         run_head=d2.run_head[1])
    torch.cuda.synchronize()
    assert sum(lm.LAUNCHES.values()) == 0
    assert torch.equal(g, before)


@pytest.mark.gpu
def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    """A kernel that does not build fails the call: ``ops`` does not fall
    back to the plain version on a CUDA tensor, and nothing is written."""
    _need_card()
    s, d, buf, g, ext, w = _levels("gru", "chains", 16)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_LOADED", {})
    before = buf.clone()
    lm.reset_launches()
    with pytest.raises(RuntimeError, match="build failed"):
        ops.level_megastep("gru", buf, d.child_ids[1], d.child_mask[1],
                           d.ext_ids[1], d.node_mask[1], s.M, ext, w)
    with pytest.raises(RuntimeError, match="build failed"):
        ops.bwd_megastep("gru", g, buf, d.child_ids[1], d.child_mask[1],
                         d.ext_ids[1], d.node_mask[1], s.M, ext, w,
                         sort_perm=d.sort_perm[1],
                         sorted_child_ids=d.sorted_child_ids[1],
                         run_head=d.run_head[1])
    torch.cuda.synchronize()
    assert sum(lm.LAUNCHES.values()) == 0
    assert torch.equal(buf, before)
