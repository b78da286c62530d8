"""The continuous frontier's tick as one launch: the level megastep stores
lane ``m``'s row at its arena row ``out_ids[m]`` (K6b's scatter folded
into the store; ``ops.frontier_megastep`` on the card), checked where no
card is present.

- ``fold_emulation`` does what the folded launch does, one lane after
  another IN PLACE: the lane's children read from the arena as it stands
  when the lane runs, its masked state by the plain megastep's math
  (``ref.level_megastep`` on one slot), stored at ``out_ids[m]``, nothing
  for an id outside the arena.  Under the contract (the ids unique, none
  of them a row the tick reads) the lanes' order cannot matter, and the
  emulation in either order is held within 1e-5 of JAX's
  ``frontier_megastep``, its ``ref`` and its Pallas composition in
  interpret mode (megastep into a staging block, then K6b), for all four
  kinds, with a pad lane, a masked lane (node mask 0 at an arena row),
  lanes with absent children and pulled rows through ``ext_ids``.
- ``ops.frontier_contract_holds`` (the check ``chip_smoke.py`` makes on
  its tapped ticks, on the card without a sync) against the cases it
  must refuse; an overlap makes the lanes' order matter, which is why the
  contract is needed.
- The port's ``ContinuousBatchEngine`` keeps the contract on every tick,
  over fixed interleavings and Hypothesis-drawn ones (arrivals, steps,
  sizes, an arena small enough that rows are reused).

Tolerance: 1e-5 absolute on unit-scale inputs (the JAX package's
kernel-against-oracle bar).  Every cell draws a NONZERO bias."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import scheduler as jsch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rnn as jrnn
from repro.models import treelstm as jtree
from repro_torch.core import scheduler as tsch
from repro_torch.core.structure import chain, random_dag
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import rnn as trnn
from repro_torch.models import treelstm as ttree
from repro_torch.serve import (AdmissionPolicy, ContinuousBatchEngine,
                               ContinuousRequest)

from tests.hypothesis_compat import given, settings, st

TOL = 1e-5
KINDS = ["treelstm", "lstm", "gru", "treefc"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cells(kind, H=4, X=5):
    """(JAX cell, port cell) of a megastep kind."""
    if kind == "treelstm":
        return (jtree.TreeLSTMVertex(input_dim=X, hidden=H, arity=2),
                ttree.TreeLSTMVertex(input_dim=X, hidden=H, arity=2))
    if kind == "treefc":
        return (jtree.TreeFCVertex(input_dim=X, hidden=H, arity=2),
                ttree.TreeFCVertex(input_dim=X, hidden=H, arity=2))
    if kind == "lstm":
        return (jrnn.LSTMVertex(input_dim=X, hidden=H),
                trnn.LSTMVertex(input_dim=X, hidden=H))
    return (jrnn.GRUVertex(input_dim=X, hidden=H),
            trnn.GRUVertex(input_dim=X, hidden=H))


def _params(jfn, seed):
    p = {k: np.asarray(v) for k, v in jfn.init(jax.random.PRNGKey(seed))
         .items()}
    p["b"] = (np.random.default_rng(seed).standard_normal(p["b"].shape)
              * 0.3).astype(np.float32)
    return p


def fold_emulation(kind, buf, child_ids, child_mask, table, ext_ids,
                   node_mask, out_ids, weights, order=None):
    """The folded launch, one lane after another in place (``order``: the
    lanes' order, default ascending): lane ``m`` reads its children from
    ``buf`` as it stands, its state is the plain megastep's on one slot
    (into a scratch row past the arena), stored at row ``out_ids[m]`` of
    ``buf`` unless that lies outside it.  Returns ``buf``."""
    R, S = buf.shape
    for m in (range(child_ids.shape[0]) if order is None else order):
        row = torch.cat([buf, buf.new_zeros((1, S))])
        tref.level_megastep(kind, row, child_ids[m:m + 1],
                            child_mask[m:m + 1], ext_ids[m:m + 1],
                            node_mask[m:m + 1], R, table, weights)
        d = int(out_ids[m])
        if 0 <= d < R:
            buf[d] = row[R]
    return buf


def _fold_case(kind, seed):
    """A tick that keeps the contract: arena rows ``[0, R)`` and the zero
    sentinel ``R``; live lanes store to rows ``[0, 6)``, children read
    rows ``[6, R)`` or the sentinel (mask 0); lane 2 has no child, lane 4
    is masked (node mask 0 at an arena row: a zero row), lane 6 is a pad
    lane (an id past the arena); the pulled rows sit shuffled in a table
    that ``ext_ids`` index."""
    jfn, tfn = _cells(kind)
    A = max(1, tfn.arity)
    rng = np.random.default_rng(seed)
    M, R = 7, 14
    S = jfn.state_dim
    buf = (rng.standard_normal((R + 1, S)) * 0.3).astype(np.float32)
    buf[R] = 0.0
    child_mask = (rng.random((M, A)) > 0.3).astype(np.float32)
    child_mask[2] = 0.0
    child_mask[6] = 0.0
    child_ids = np.where(child_mask > 0, rng.integers(6, R, (M, A)),
                         R).astype(np.int32)
    node_mask = np.ones(M, np.float32)
    node_mask[4] = node_mask[6] = 0.0
    out = rng.permutation(6)[:M].astype(np.int32)
    out = np.concatenate([out, [R + 3]]).astype(np.int32)
    rows = (rng.standard_normal((M, jfn.ext_dim)) * 0.3).astype(np.float32)
    perm = rng.permutation(M + 3)
    table = np.zeros((M + 3, jfn.ext_dim), np.float32)
    table[perm[:M]] = rows
    return (jfn, tfn, _params(jfn, seed),
            (buf, child_ids, child_mask, rows, node_mask, out),
            table, perm[:M].astype(np.int32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_fold_emulation_matches_jax_ref_and_pallas(kind, seed):
    jfn, tfn, p, case, table, ext_ids = _fold_case(kind, seed)
    A = case[1].shape[1]
    jspec = jsch.resolve_fusion(jfn, "megastep", sched_arity=A)
    jw = jspec.weights({k: jnp.asarray(v) for k, v in p.items()})
    jargs = (kind, *(jnp.asarray(a) for a in case), jw)
    want = np.asarray(jref.frontier_megastep(*jargs))
    pallas = np.asarray(jops.frontier_megastep(*jargs, impl="pallas"))
    tspec = tsch.resolve_fusion(tfn, "megastep", sched_arity=A)
    w = tspec.weights(params_from_jax(p, "cpu"))
    buf, cids, cmask, _rows, nm, out = (_t(a) for a in case)
    assert bool(tops.frontier_contract_holds(cids, out, buf.shape[0]))
    M = cids.shape[0]
    for order in (None, range(M - 1, -1, -1)):
        got = fold_emulation(kind, buf.clone(), cids, cmask, _t(table),
                             _t(ext_ids), nm, out, w, order)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL)
        # The masked lane stores a zero row; rows no lane names, the
        # sentinel among them, keep their bits.
        assert not got[int(out[4])].any()
        named = set(int(i) for i in out if 0 <= int(i) < buf.shape[0])
        for r in range(buf.shape[0]):
            if r not in named:
                assert torch.equal(got[r], buf[r]), r
    # The port's plain version (the CPU leg of ops.frontier_megastep) is
    # the two-phase composition: the same rows.
    plain = tops.frontier_megastep(kind, buf.clone(), cids, cmask,
                                   _t(table), nm, out, w,
                                   ext_ids=_t(ext_ids))
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=TOL)


def test_contract_check_refuses_overlaps_duplicates_and_the_sentinel():
    R = 10
    cids = torch.tensor([[5, 9], [6, 9], [9, 9]], dtype=torch.int32)
    ok = torch.tensor([0, 1, 13], dtype=torch.int32)
    assert bool(tops.frontier_contract_holds(cids, ok, R))
    for bad in ([0, 5, 13],          # lane 1 stores a row lane 0 reads
                [0, 0, 13],          # a duplicate id
                [0, 9, 13]):         # the sentinel
        assert not bool(tops.frontier_contract_holds(
            cids, torch.tensor(bad, dtype=torch.int32), R)), bad
    # Ids outside the arena are pad lanes: never an overlap.
    pads = torch.tensor([-1, 10, 11], dtype=torch.int32)
    assert bool(tops.frontier_contract_holds(cids, pads, R))


def test_an_overlap_makes_the_lanes_order_matter():
    """Why the fold needs the contract: where a lane stores the row
    another lane reads, the in-place launch's result depends on which lane
    runs first, and neither order is the two-phase composition for sure."""
    _jfn, tfn, p, case, table, ext_ids = _fold_case("lstm", 0)
    w = tsch.resolve_fusion(tfn, "megastep", sched_arity=1).weights(
        params_from_jax(p, "cpu"))
    buf, cids, cmask, _rows, nm, out = (_t(a) for a in case)
    out = out.clone()
    out[1] = int(cids[0, 0])           # lane 0's predecessor row
    cmask[0, 0] = 1.0
    assert not bool(tops.frontier_contract_holds(cids, out, buf.shape[0]))
    M = cids.shape[0]
    fwd = fold_emulation("lstm", buf.clone(), cids, cmask, _t(table),
                         _t(ext_ids), nm, out, w)
    rev = fold_emulation("lstm", buf.clone(), cids, cmask, _t(table),
                         _t(ext_ids), nm, out, w, range(M - 1, -1, -1))
    assert not torch.equal(fwd, rev)


# ---------------------------------------------------------------------------
# The engine keeps the contract on every tick
# ---------------------------------------------------------------------------

X, H = 4, 3


class _ContractTap:
    """Stands in for ``ops.frontier_megastep`` and ``ops.scatter_rows``
    while installed: every fused tick is checked against the contract
    (and the op-by-op leg's scatter, whose ids obey the same plan) before
    it runs."""

    def __init__(self):
        self.ticks = 0
        self.bad = []

    def __enter__(self):
        self.inner = tops.frontier_megastep

        def tap(kind, buf, cids, cmask, rows, nm, out, w, **kw):
            self.ticks += 1
            if not bool(tops.frontier_contract_holds(cids, out,
                                                     buf.shape[0])):
                self.bad.append((cids.clone(), out.clone()))
            return self.inner(kind, buf, cids, cmask, rows, nm, out, w, **kw)

        tops.frontier_megastep = tap
        return self

    def __exit__(self, *exc):
        tops.frontier_megastep = self.inner


def _engine(cell, rows, width, t):
    tfn = trnn.LSTMVertex(X, H) if cell == "lstm" \
        else ttree.TreeLSTMVertex(X, H, 2)
    params = tfn.init(torch.Generator().manual_seed(0), device="cpu")
    return tfn, ContinuousBatchEngine(
        tfn, params, num_rows=rows, frontier_width=width,
        clock=lambda: t[0], device="cpu",
        policy=AdmissionPolicy(min_occupancy=0.25, ttl_slack_s=0.05,
                               max_defer_ticks=2, max_window=4))


def _drive_checked(cell, sizes, schedule, rows, width, seed):
    """The cohort through a fused engine under ``schedule`` (submit, step,
    clock), then drained; returns the tap."""
    t = [0.0]
    tfn, eng = _engine(cell, rows, width, t)
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(sizes):
        g = chain(n) if cell == "lstm" else random_dag(n, rng, max_arity=2)
        x = (rng.standard_normal((n, X)) * 0.4).astype(np.float32)
        reqs.append(ContinuousRequest(i, g, x))
    with _ContractTap() as tap:
        it = iter(reqs)
        for op in schedule:
            if op == "submit":
                nxt = next(it, None)
                if nxt is not None:
                    eng.submit(nxt)
            elif op == "step":
                eng.step()
            else:
                t[0] += 0.2
        for nxt in it:
            eng.submit(nxt)
        eng.run()
    assert eng.fused
    assert all(r.status == "ok" for r in reqs), [r.error for r in reqs]
    assert tap.ticks == eng.ticks > 0
    assert not tap.bad, tap.bad[:2]
    return eng


_FIXED = [
    # (cell, sizes, schedule, num_rows, frontier_width)
    ("lstm", [3, 7, 5, 12, 1, 9], [], 16, 3),             # rows reused
    ("lstm", [6, 2, 8], ["submit", "step", "step", "submit", "step",
                         "submit"], 32, 4),                # staggered
    ("tree", [4, 9, 1, 6, 11], ["submit", "step", "submit", "clock",
                                "step"], 14, 3),           # DAGs, reuse
    ("tree", [12, 12, 3], [], 12, 8),                      # one at a time
]


@pytest.mark.parametrize("case", range(len(_FIXED)))
def test_engine_ticks_keep_the_contract_fixed(case):
    cell, sizes, schedule, rows, width = _FIXED[case]
    _drive_checked(cell, sizes, schedule, rows, width, case)


@pytest.mark.parametrize("cell", ["lstm", "tree"])
@settings(max_examples=8, deadline=None)
@given(st.data())
def test_engine_ticks_keep_the_contract_any_interleaving(cell, data):
    sizes = data.draw(st.lists(st.integers(min_value=1, max_value=9),
                               min_size=1, max_size=6))
    schedule = data.draw(st.lists(
        st.sampled_from(["submit", "step", "clock"]), max_size=12))
    rows = data.draw(st.integers(min_value=9, max_value=24))
    width = data.draw(st.integers(min_value=1, max_value=6))
    _drive_checked(cell, sizes, schedule, rows, width,
                   data.draw(st.integers(0, 2 ** 16)))
