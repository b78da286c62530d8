"""Per-graph schedule splicing in the port (``repro_torch.pipeline.splice``)
against the JAX package: ``splice_schedules`` and ``extract_solo`` give
byte-identical arrays to both packages' ``pack_batch`` (and to the JAX
package's own splice and extract) on trees, chains, DAGs and padded
pads at K 1-16, sorted-run arrays included; the refusals raise the same
``ValueError`` messages; and a spliced schedule's device twin carries the
same plans as a cold pack's."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import structure as jst
from repro.pipeline import splice as jsplice
from repro_torch.core import structure as tst
from repro_torch.pipeline import splice as tsplice

FIELDS = tuple(f.name for f in dataclasses.fields(tst.LevelSchedule))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f


def _graph(m, rng, kind):
    if kind == "chain":
        return m.chain(int(rng.integers(1, 8)))
    if kind == "tree":
        return m.random_binary_tree(int(rng.integers(1, 8)), rng)
    if kind == "dag":
        return m.random_dag(int(rng.integers(1, 9)), rng, max_arity=3)
    return m.balanced_binary_tree(2 ** int(rng.integers(0, 4)))


def _forests(seed, k):
    """The same forest of ``k`` graphs built by both packages."""
    def build(m):
        rng = np.random.default_rng(seed)
        kinds = ("chain", "tree", "dag", "balanced")
        return [_graph(m, rng, kinds[int(rng.integers(0, 4))])
                for _ in range(k)]
    return build(jst), build(tst)


def _pads(graphs, which, seed):
    if which == "tight":
        return None
    s = tst.pack_batch(graphs)
    rng = np.random.default_rng(seed)
    if which == "padded":
        return (s.T + int(rng.integers(1, 3)), s.M + int(rng.integers(1, 4)),
                s.A, s.N + int(rng.integers(1, 3)))
    return (s.T, s.M, s.A + 1, s.N)           # widen A only


@pytest.mark.parametrize("with_runs", [True, False])
@pytest.mark.parametrize("which", ["tight", "padded", "arity"])
@pytest.mark.parametrize("k", [1, 2, 5, 16])
@pytest.mark.parametrize("seed", range(3))
def test_splice_byte_identical_to_both_pack_batches(seed, k, which,
                                                    with_runs):
    jg, tg = _forests(seed, k)
    pads = _pads(tg, which, seed)
    p = pads or (None,) * 4
    solos = [tst.pack_batch([g], with_runs=False) for g in tg]
    got = tsplice.splice_schedules(tg, solos, pads, with_runs=with_runs)
    _assert_same(got, tst.pack_batch(tg, *p, with_runs=with_runs))
    _assert_same(got, jst.pack_batch(jg, *p, with_runs=with_runs))
    jsolos = [jst.pack_batch([g], with_runs=False) for g in jg]
    _assert_same(got, jsplice.splice_schedules(jg, jsolos, pads,
                                               with_runs=with_runs))


@pytest.mark.parametrize("which", ["tight", "padded", "arity"])
@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("seed", range(3))
def test_extract_solo_byte_identical_and_pad_tolerant(seed, k, which):
    """Harvest out of a tight or bucketed cold pack: each member's tight
    solo, equal to packing it alone in either package and to the JAX
    package's own harvest."""
    jg, tg = _forests(100 + seed, k)
    p = _pads(tg, which, seed) or (None,) * 4
    batch = tst.pack_batch(tg, *p)
    jbatch = jst.pack_batch(jg, *p)
    for i, (j, t) in enumerate(zip(jg, tg)):
        solo = tsplice.extract_solo(batch, i)
        _assert_same(solo, tst.pack_batch([t], with_runs=False))
        _assert_same(solo, jst.pack_batch([j], with_runs=False))
        _assert_same(solo, jsplice.extract_solo(jbatch, i))


def _solos(st, graphs):
    return [st.pack_batch([g], with_runs=False) for g in graphs]


#: Inputs each package must refuse, as ``(splice module, structure
#: module, [chain(3), chain(5)]) -> call``.
REFUSALS = {
    "undersized pads": lambda sp, st, g: sp.splice_schedules(
        g, _solos(st, g), (None, None, None, 4)),
    "empty batch": lambda sp, st, g: sp.splice_schedules([], []),
    "count mismatch": lambda sp, st, g: sp.splice_schedules(
        g, _solos(st, g)[:1]),
    "solo padded in M": lambda sp, st, g: sp.splice_schedules(
        g[:1], [st.pack_batch(g[:1], pad_width=2, with_runs=False)]),
    "solo padded in A": lambda sp, st, g: sp.splice_schedules(
        g[:1], [st.pack_batch(g[:1], pad_arity=3, with_runs=False)]),
    "solo of K 2": lambda sp, st, g: sp.splice_schedules(
        g[:1], [st.pack_batch(g, with_runs=False)]),
    "extract out of range": lambda sp, st, g: sp.extract_solo(
        st.pack_batch(g, pad_levels=8, pad_width=4, pad_nodes=16), 2),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_the_same_value_errors(case):
    call = REFUSALS[case]
    with pytest.raises(ValueError) as et:
        call(tsplice, tst, [tst.chain(3), tst.chain(5)])
    with pytest.raises(ValueError) as ej:
        call(jsplice, jst, [jst.chain(3), jst.chain(5)])
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("seed", range(2))
def test_spliced_device_twin_carries_cold_pack_plans(seed):
    """``to_device`` of a spliced schedule: the K7 scatter plans, the
    per-level live counts and K2's level plans equal a cold pack's."""
    _, tg = _forests(200 + seed, 6)
    s = tst.pack_batch(tg)
    pads = (s.T + 1, s.M + 3, s.A, s.N + 2)
    solos = [tst.pack_batch([g], with_runs=False) for g in tg]
    spliced = tsplice.splice_schedules(tg, solos, pads).to_device("cpu")
    cold = tst.pack_batch(tg, *pads).to_device("cpu")
    assert spliced.live == cold.live
    assert spliced.bwd_single == cold.bwd_single
    for a, b in zip(spliced.bwd_heads, cold.bwd_heads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    for a, b in zip((spliced.ext_plan,) + spliced.child_plans,
                    (cold.ext_plan,) + cold.child_plans):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), f.name
