"""K2, the reverse megastep (``csrc/bwd_megastep_sm90.cu``), where no card
is present: the host's per-level plan, the depth split, the wrapper's
launch arguments, and the kernel's arithmetic emulated in plain PyTorch
against the plain version, JAX's reference and the Pallas K2.

- ``emulate_bwd_tf32x3`` repeats what the kernel computes on a level:
  the level's plan (``level_bwd_plan``: live slots, one contribution a
  row or the run heads); each product's depth in the kernel's chunks of
  ``K2_BK`` (segments of H, the last chunk of each cut at H), the chunks
  dealt to the ranks of the cluster as ``k2_split`` and ``k2_chunks``
  deal them; every k-step of 8 as three TF32 products (``cvt.rna`` on
  int32 bit views; small·big, big·small, big·big, in that order) into the
  rank's fp32 sum (in pass (a), the shared product's, into the chunk's
  sum, then added to the rank's); the ranks' sums added in rank order;
  the epilogue's
  formulas in the kernel's order; then each child's cotangent added into
  ``g`` by one fp32 add (one contribution a row), or the run pass's sums
  in sorted order.
- For every kind at A 1–4, on ``_bwd_case`` of
  ``tests/test_torch_megastep_bwd.py`` (duplicates across slots, a
  sentinel child, a masked slot; also with distinct children, the
  kernel's one-contribution route), at H 5 and 72, the emulation held
  within 1e-5 of max |plain| of JAX's ``ref.bwd_megastep`` and of the
  Pallas K2 in interpret mode.  (lstm and gru at A > 1 against JAX's
  ref with child 0 a slot's only child: that ref differentiates the
  cell, which reads child 0, where the Pallas K2 and the port hand the
  cotangent to every child; ROADMAP queue 3.)  Measured: 3.3e-8 to
  1.6e-7 of max |JAX ref| and 3.2e-8 to 1.5e-7 of max |Pallas K2| (the
  split keeps about 21 bits of each operand, so the error is the fp32
  sums' own).  One TF32 product a k-step without the split, as a plain
  TF32 kernel would do, gives 9.0e-5 to 1.6e-4 at H 72 and misses the
  bar, which ``test_unsplit_tf32_misses_the_bar`` shows.  The
  emulation's sums round as IEEE fp32 does; the tensor core's cut, which
  ``chip_smoke.py`` and the ``gpu`` tests hold to the card's bar of 1e-4.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import level_megastep_bwd as jlmb
from repro.kernels import ref as jref
from repro_torch.core.structure import (balanced_binary_tree, chain,
                                        level_bwd_plan, pack_batch,
                                        random_binary_tree, random_dag)
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.kernels import ops
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
KINDS = ["treelstm", "lstm", "gru", "treefc"]
SM = {"treelstm": 2, "lstm": 2, "gru": 1, "treefc": 1}
GM = {"treelstm": 4, "lstm": 4, "gru": 3, "treefc": 1}
SMS = 132                                 # an H100 SXM's SMs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bwd_case_of_megastep_tests():
    spec = importlib.util.spec_from_file_location(
        "_megastep_bwd_tests", ROOT / "tests" / "test_torch_megastep_bwd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._bwd_case


_bwd_case = _bwd_case_of_megastep_tests()


# ---------------------------------------------------------------------------
# The kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of finite f32 values: the magnitude rounded to
    10 stored mantissa bits, ties away from zero, as f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mma3(acc, a, b, split3=True):
    """``acc`` + one k-step's ``a @ b`` as the kernel's three TF32
    products, small·big, big·small, big·big, each added in fp32 (one
    unsplit TF32 product where ``split3`` is False; with ``split3``
    "bf16", ``a`` holds bf16 values, exact in TF32, and the step is the
    bf16 route's two products, big·small and big·big)."""
    if not split3:
        return acc + tf32(a) @ tf32(b)
    ag, as_ = split(a)
    bg, bs = split(b)
    if split3 == "bf16":
        assert not as_.any(), "a bf16 value has no small part"
        return (acc + ag @ bs) + ag @ bg
    for x, y in ((as_, bg), (ag, bs), (ag, bg)):
        acc = acc + x @ y
    return acc


def rank_sums(segs, H: int, s: int, planes: int, split3=True,
              chunk_sums=False):
    """The kernel's depth split of one product: ``segs[seg]`` is a list of
    ``(plane, A [rows, H], B [H, N])``, the products a chunk of segment
    ``seg`` feeds.  The segments' chunks of ``K2_BK`` (the last cut at H)
    are dealt to ``s`` ranks by ``k2_chunks``; each rank sums its chunks'
    k-steps of 8 into a zero partial a plane (with ``chunk_sums``, each
    chunk's k-steps into a zero sum that is then added to the partial:
    ``gathered_product.cuh``'s fresh accumulator a chunk); the partials
    are added in rank order.  Returns the plane sums."""
    bk = lm.K2_BK
    chunks = [(seg, k0) for seg in range(len(segs)) for k0 in range(0, H, bk)]
    rows, cols = segs[0][0][1].shape[0], segs[0][0][2].shape[1]
    total = None
    for r in range(s):
        part = [torch.zeros(rows, cols) for _ in range(planes)]
        for c in lm.k2_chunks(r, s, len(chunks)):
            seg, k0 = chunks[c]
            for plane, a, b in segs[seg]:
                acc = torch.zeros(rows, cols) if chunk_sums else part[plane]
                for k in range(k0, min(k0 + bk, H), 8):
                    k1 = min(k + 8, H)
                    acc = mma3(acc, a[:, k:k1], b[k:k1], split3)
                part[plane] = part[plane] + acc if chunk_sums else acc
        total = part if total is None else [t + p for t, p in
                                            zip(total, part)]
    return total


def emulate_bwd_tf32x3(kind, g, buf, cids, eids, nm, off, ext, weights, *,
                       sms=SMS, split3=True):
    """What ``bwd_megastep_sm90.cu`` leaves in ``g`` (a copy; the inputs
    are left as they are) for one level of kind ``kind``, its depth split
    as the kernel splits it on a card of ``sms`` SMs."""
    g = g.clone()
    R = g.shape[0]
    M, A = cids.shape
    sent = R - 1
    live, single, heads = level_bwd_plan(cids.numpy(), sent)
    H = weights[0].shape[0] if kind in ("treelstm", "lstm", "gru") \
        else weights[0].shape[1]
    if live == 0:
        return g
    sa, sb = lmb.k2_splits(kind, live, A, H, sms)
    L = live
    ids = cids[:L].long()
    has = ids != sent
    rows = torch.where(has[..., None], buf[ids], torch.zeros(()))  # [L, A, S]
    x = ext[eids[:L].long()]
    gs = g[off:off + L]
    nmk = nm[:L, None]
    sig = torch.sigmoid

    if kind == "treelstm":
        ui, uf, uo, uu, b = weights
        hk = rows[..., H:]
        hs = hk[:, 0]
        for k in range(1, A):
            hs = hs + hk[:, k]
        segs = [[(0, hs, ui), (1, hs, uo), (2, hs, uu)]
                + [(3 + k, hk[:, k], uf) for k in range(A)]]
        p = rank_sums(segs, H, sa, 3 + A, split3, chunk_sums=True)
        ig = sig(x[:, :H] + p[0] + b[:H])
        og = sig(x[:, 2 * H:3 * H] + p[1] + b[2 * H:3 * H])
        ug = torch.tanh(x[:, 3 * H:] + p[2] + b[3 * H:])
        ck = rows[..., :H]
        fa = [sig(x[:, H:2 * H] + p[3 + k] + b[H:2 * H]) for k in range(A)]
        fc = torch.zeros(L, H)
        for k in range(A):
            fc = fc + fa[k] * ck[:, k]
        c = ig * ug + fc
        tc = torch.tanh(c)
        g_c, g_h = gs[:, :H] * nmk, gs[:, H:] * nmk
        gc = g_c + g_h * og * (1 - tc * tc)
        d_i = gc * ug * ig * (1 - ig)
        d_o = g_h * tc * og * (1 - og)
        d_u = gc * ig * (1 - ug * ug)
        df = [gc * ck[:, k] * fa[k] * (1 - fa[k]) for k in range(A)]
        segs = [[(0, d_i, ui.T)], [(0, d_o, uo.T)], [(0, d_u, uu.T)],
                [(1 + k, df[k], uf.T) for k in range(A)]]
        q = rank_sums(segs, H, sb, 1 + A, split3)
        contrib = torch.stack([torch.cat([gc * fa[k], q[0] + q[1 + k]], 1)
                               for k in range(A)], 1)          # [L, A, 2H]
    elif kind == "lstm":
        wh, b = weights
        prev = rows[:, 0]
        p = rank_sums([[(q, prev[:, H:], wh[:, q * H:(q + 1) * H])
                        for q in range(4)]], H, sa, 4, split3,
                      chunk_sums=True)
        ig = sig(x[:, :H] + p[0] + b[:H])
        fg = sig(x[:, H:2 * H] + p[1] + b[H:2 * H] + 1.0)
        og = sig(x[:, 2 * H:3 * H] + p[2] + b[2 * H:3 * H])
        ug = torch.tanh(x[:, 3 * H:] + p[3] + b[3 * H:])
        c_prev = prev[:, :H]
        c = fg * c_prev + ig * ug
        tc = torch.tanh(c)
        g_c, g_h = gs[:, :H] * nmk, gs[:, H:] * nmk
        gc = g_c + g_h * og * (1 - tc * tc)
        d = [gc * ug * ig * (1 - ig), gc * c_prev * fg * (1 - fg),
             g_h * tc * og * (1 - og), gc * ig * (1 - ug * ug)]
        q = rank_sums([[(0, d[s_], wh[:, s_ * H:(s_ + 1) * H].T)]
                       for s_ in range(4)], H, sb, 1, split3)
        row = torch.cat([gc * fg, q[0]], 1)
        contrib = row[:, None].expand(L, A, 2 * H)
    elif kind == "gru":
        wh, b = weights
        prev = rows[:, 0]
        p = rank_sums([[(q, prev, wh[:, q * H:(q + 1) * H])
                        for q in range(3)]], H, sa, 3, split3,
                      chunk_sums=True)
        z = sig(x[:, :H] + (p[0] + b[:H]))
        r = sig(x[:, H:2 * H] + (p[1] + b[H:2 * H]))
        hn = p[2] + b[2 * H:]
        n = torch.tanh(x[:, 2 * H:] + r * hn)
        g_h = gs * nmk
        d_n = g_h * (1 - z) * (1 - n * n)
        d_z = g_h * (prev - n) * z * (1 - z)
        d_r = d_n * hn * r * (1 - r)
        d = [d_z, d_r, d_n * r]
        q = rank_sums([[(0, d[s_], wh[:, s_ * H:(s_ + 1) * H].T)]
                       for s_ in range(3)], H, sb, 1, split3)
        row = g_h * z + q[0]
        contrib = row[:, None].expand(L, A, H)
    else:
        wc, b = weights
        p = rank_sums([[(0, rows[:, k], wc[k * H:(k + 1) * H])]
                       for k in range(A)], H, sa, 1, split3,
                      chunk_sums=True)
        hy = torch.tanh(p[0] + x + b)
        d_pre = gs * nmk * (1 - hy * hy)
        q = rank_sums([[(0, d_pre, wc.T)]], H, sb, 1, split3)
        contrib = q[0].reshape(L, A, H)

    if single:
        for m in range(L):
            for k in range(A):
                if has[m, k]:
                    g[ids[m, k]] = g[ids[m, k]] + contrib[m, k]
        return g
    flat = contrib.reshape(L * A, -1)
    order = np.argsort(cids.numpy().reshape(-1), kind="stable")
    for lo, hi in zip(heads[:-1], heads[1:]):
        dest = int(cids.reshape(-1)[order[lo]])
        acc = g[dest]
        for j in range(lo, hi):
            acc = acc + flat[int(order[j])]
        g[dest] = acc
    return g


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def _kind_weights(kind, rng, h, a):
    """NumPy weights of ``kind`` in ``GateSpec.weights`` order, a nonzero
    bias."""
    if kind == "treelstm":
        w = [(rng.standard_normal((h, h)) * h ** -0.5).astype(np.float32)
             for _ in range(4)]
        return (*w, (rng.standard_normal(4 * h) * 0.1).astype(np.float32))
    rows = a * h if kind == "treefc" else h
    cols = h if kind == "treefc" else GM[kind] * h
    return ((rng.standard_normal((rows, cols)) * rows ** -0.5)
            .astype(np.float32),
            (rng.standard_normal(GM[kind] * h) * 0.3).astype(np.float32))


def _case(kind, seed, h, a, distinct=False):
    """``_bwd_case`` cut to ``kind``'s widths, with its weights; with
    ``distinct``, children are distinct rows (the kernel's
    one-contribution route) and the slots past the first 12 children get
    none (so ``live`` < M)."""
    c = _bwd_case(seed, h=h, a=a)
    S, G = SM[kind] * h, GM[kind] * h
    c["g"] = np.ascontiguousarray(c["g"][:, :S])
    c["buf"] = np.ascontiguousarray(c["buf"][:, :S])
    c["ext"] = np.ascontiguousarray(c["ext"][:, :G])
    sent = c["g"].shape[0] - 1
    if distinct:
        rng = np.random.default_rng(seed + 100)
        flat = np.full(c["cids"].size, sent, np.int32)
        n = min(flat.size, c["off"])
        flat[:n] = rng.permutation(c["off"])[:n]
        c["cids"] = flat.reshape(c["cids"].shape)
        c["cids"][1, -1] = sent                 # a sentinel child
        c["cmask"] = (c["cids"] != sent).astype(np.float32)
    c["w"] = _kind_weights(kind, np.random.default_rng(seed + 7), h, a)
    return c


def _torch(c):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return (t(c["g"]), t(c["buf"]), t(c["cids"]), t(c["eids"]), t(c["nm"]),
            c["off"], t(c["ext"]), tuple(t(w) for w in c["w"]))


def _emulate(kind, c, **kw):
    return emulate_bwd_tf32x3(kind, *_torch(c), **kw).numpy()


def _jax_ref(kind, c):
    return np.asarray(jref.bwd_megastep(
        kind, jnp.asarray(c["g"]), jnp.asarray(c["buf"]),
        jnp.asarray(c["cids"]), jnp.asarray(c["cmask"]),
        jnp.asarray(c["eids"]), jnp.asarray(c["nm"]), c["off"],
        jnp.asarray(c["ext"]), tuple(jnp.asarray(w) for w in c["w"])))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _untouched(c, got):
    rows = np.setdiff1d(np.arange(c["g"].shape[0]), c["cids"])
    np.testing.assert_array_equal(got[rows].view(np.int32),
                                  c["g"][rows].view(np.int32))


CASES = [(k, a, h, d) for k in KINDS for a in (1, 2, 3, 4)
         for h, d in ((5, False), (72, True))]


@pytest.mark.parametrize("kind,a,h,distinct", CASES, ids=str)
def test_emulation_matches_jax_ref(kind, a, h, distinct):
    c = _case(kind, 30 + a, h, a, distinct)
    if kind in ("lstm", "gru") and a > 1:
        # JAX's ref differentiates the cell, which reads child 0 only;
        # the analytic rule of the Pallas K2, the port and its kernel
        # hands the cotangent to every child (ROADMAP queue 3).  The two
        # agree where child 0 is a slot's only child.
        c["cids"][:, 1:] = c["g"].shape[0] - 1
        c["cmask"] = (c["cids"] != c["g"].shape[0] - 1).astype(np.float32)
    got = _emulate(kind, c)
    assert _rel(got, _jax_ref(kind, c)) <= TOL
    _untouched(c, got)


@pytest.mark.parametrize("kind,a,h,distinct",
                         [(k, a, 5, False) for k in KINDS for a in (1, 2, 3, 4)]
                         + [(k, 2, 24, True) for k in KINDS], ids=str)
def test_emulation_matches_jax_pallas_interpret(kind, a, h, distinct):
    c = _case(kind, 50 + a, h, a, distinct)
    want = np.asarray(jlmb.bwd_megastep(
        kind, jnp.asarray(c["g"]), jnp.asarray(c["buf"]),
        jnp.asarray(c["cids"]), jnp.asarray(c["eids"]), jnp.asarray(c["nm"]),
        jnp.int32(c["off"]), jnp.asarray(c["ext"]),
        tuple(jnp.asarray(w) for w in c["w"]), interpret=True))
    assert _rel(_emulate(kind, c), want) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_plain_and_split_does_not_matter(kind):
    """The emulation against the port's plain version, with the depth
    split of a card of 132 SMs and with none (``sms=1``): both within the
    bar, so the split only reorders fp32 sums."""
    c = _case(kind, 70, 72, 2, True)
    args = _torch(c)
    want = ref.bwd_megastep(kind, args[0].clone(), args[1], args[2],
                            torch.from_numpy(c["cmask"]), *args[3:])
    for sms in (SMS, 1):
        assert _rel(emulate_bwd_tf32x3(kind, *args, sms=sms), want) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_unsplit_tf32_misses_the_bar(kind):
    """One TF32 product a k-step, as a plain TF32 kernel would do, misses
    1e-5 of max |JAX ref| at the paper's scale of inputs: the reason for
    the split."""
    c = _case(kind, 90, 72, 1 if kind in ("lstm", "gru") else 2, True)
    err = _rel(_emulate(kind, c, split3=False), _jax_ref(kind, c))
    assert err > TOL, err
    assert _rel(_emulate(kind, c), _jax_ref(kind, c)) <= TOL


# ---------------------------------------------------------------------------
# The host's plan and the depth split
# ---------------------------------------------------------------------------

def _recount(cids, sent):
    """``level_bwd_plan`` by direct loops."""
    M, A = cids.shape
    live = 0
    for m in range(M):
        if any(cids[m, k] != sent for k in range(A)):
            live = m + 1
    seen = {}
    for v in cids.reshape(-1):
        if v != sent:
            seen[int(v)] = seen.get(int(v), 0) + 1
    single = all(n == 1 for n in seen.values())
    heads = None
    if not single:
        heads, at = [], 0
        for v in sorted(seen):
            heads.append(at)
            at += seen[v]
        heads.append(at)
    return live, single, heads


def _schedule(name):
    rng = np.random.default_rng(11)
    trees = [random_binary_tree(int(rng.integers(1, 30)), rng)
             for _ in range(8)]
    chains = [chain(int(n)) for n in rng.integers(1, 20, size=12)]
    dags = [random_dag(int(rng.integers(5, 20)), rng, max_arity=3)
            for _ in range(6)]
    return {"trees": lambda: pack_batch(trees),
            "chains": lambda: pack_batch(chains),
            "dags": lambda: pack_batch(dags),
            "padded": lambda: pack_batch(trees + [balanced_binary_tree(8)],
                                         pad_levels=12, pad_width=256),
            "chains_padded": lambda: pack_batch(chains, pad_levels=24,
                                                pad_width=16)}[name]()


@pytest.mark.parametrize("name", ["trees", "chains", "dags", "padded",
                                  "chains_padded"])
def test_level_plan_matches_a_recount(name):
    s = _schedule(name)
    plans = s.bwd_plans()
    assert len(plans) == s.T
    for t, (live, single, heads) in enumerate(plans):
        want = _recount(s.child_ids[t], s.sentinel_slot)
        assert (live, single) == want[:2], t
        if single:
            assert heads is None
        else:
            assert heads.dtype == np.int32 and heads.tolist() == want[2]
        # The plan without the schedule's sorted ids sorts for itself.
        again = level_bwd_plan(s.child_ids[t], s.sentinel_slot)
        assert again[:2] == (live, single)
    lives = [p[0] for p in plans]
    singles = [p[1] for p in plans]
    assert lives[0] == 0                        # leaves have no child
    if name in ("trees", "chains", "padded", "chains_padded"):
        assert all(singles), "tree and chain levels: one contribution"
    if name == "dags":
        assert not all(singles), "a DAG level with a run of several"
    if name in ("padded", "chains_padded"):
        assert lives[-1] == 0 and s.node_mask[-1].sum() == 0, \
            "an all-padding level has no live slot"


def test_to_device_carries_the_plans():
    s = _schedule("dags")
    d = s.to_device("cpu")
    plans = s.bwd_plans()
    assert d.live == tuple(p[0] for p in plans)
    assert d.bwd_single == tuple(p[1] for p in plans)
    for (_l, single, heads), h in zip(plans, d.bwd_heads):
        if single:
            assert h is None
        else:
            assert h.dtype == torch.int32 and h.tolist() == heads.tolist()
    plain = pack_batch([chain(4)], with_runs=False).to_device("cpu")
    assert plain.bwd_single is None and plain.bwd_heads is None


@pytest.mark.parametrize("kind", KINDS)
def test_split_fills_the_card(kind):
    """The split is a power of two up to 8 and the pass's chunks, and
    gives a launch about one CTA an SM (90 % of the SMs) unless it is at
    its cap; past that only while the launch keeps at most two CTAs an SM
    and each rank at least 8 chunks."""
    for live in (1, 16, 64, 128, 350, 2048, 8192):
        for A in (1, 2, 4):
            for H in (5, 20, 72, 512):
                grid = lmb.k2_grid(kind, live, A, H)
                splits = lmb.k2_splits(kind, live, A, H, SMS)
                for (tiles, chunks, warps), s in zip(grid, splits):
                    assert s in (1, 2, 4, 8) and s <= max(1, chunks)
                    assert 10 * tiles * s * warps >= 72 * SMS or s == 8 \
                        or 2 * s > chunks
                    if s > 1 and 10 * tiles * (s // 2) * warps >= 72 * SMS:
                        # split past eight warps an SM: at most sixteen an
                        # SM and at least 8 chunks a rank
                        assert tiles * s * warps <= 16 * SMS
                        assert chunks >= 8 * s
                    dealt = [c for r in range(s)
                             for c in lm.k2_chunks(r, s, chunks)]
                    assert dealt == list(range(chunks))
    # A Var-LSTM / GRU level (128 slots, H 512): 2 row tiles, yet both
    # passes launch at least 512 warps (pass (b) at the cap of 8: 16 tiles
    # of 64 x 64 outputs).
    for (tiles, _c, warps), s in zip(lmb.k2_grid(kind, 128, 1, 512),
                                     lmb.k2_splits(kind, 128, 1, 512, SMS)):
        assert tiles * s * warps >= 128 * 4


# ---------------------------------------------------------------------------
# The wrapper's launch, stubbed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["trees", "dags"])
def test_wrapper_passes_the_plan_and_counts_launches(name, monkeypatch):
    """Through the scheduler's keywords the wrapper launches nothing on a
    level with no live slot, passes ``live``, the flag, the run heads and
    the two splits, and counts one level and the CUDA launches the entry
    point reports (2, or 3 with several contributions to a row)."""
    import ctypes
    s = _schedule(name)
    d = s.to_device("cpu")
    H, R = 8, s.T * s.M + 1
    calls = []

    def fake_launch(op, dev, *args, counts=()):
        calls.append((op, args))
        single = args[21]
        ctypes.c_int.from_address(args[-1]).value = 2 if single else 3
        for key in counts or (op,):
            lm.LAUNCHES[key] += 1

    monkeypatch.setattr(lmb, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(lmb, "launch_kernel", fake_launch)
    monkeypatch.setattr(lmb, "_sm_count", lambda dev: SMS)
    g = torch.zeros(R, 2 * H)
    buf = torch.zeros(R, 2 * H)
    ext = torch.zeros(s.K * s.N + 1, 4 * H)
    p = torch.zeros(H, 4 * H)
    w = (p[:, :H], p[:, H:2 * H], p[:, 2 * H:3 * H], p[:, 3 * H:],
         torch.zeros(4 * H))
    lm.reset_launches()
    from repro_torch.core.scheduler import _level_runs
    for t in range(s.T):
        kw = _level_runs(d, t)
        lmb.bwd_megastep("treelstm", g, buf, d.child_ids[t], d.ext_ids[t],
                         d.node_mask[t], t * s.M, ext, w, **kw)
    work = [t for t in range(s.T) if d.live[t] > 0]
    assert [a[15] for _op, a in calls] == [t * s.M for t in work]  # offsets
    cuda = 0
    for t, (_op, a) in zip(work, calls):
        live, single, nruns, sa, sb = a[20:25]
        assert (live, bool(single)) == (d.live[t], d.bwd_single[t])
        assert (a[10] is None) == single
        assert nruns == (0 if single else d.bwd_heads[t].numel() - 1)
        assert (sa, sb) == lmb.k2_splits("treelstm", live, s.A, H, SMS)
        cuda += 2 if single else 3
    assert lm.LAUNCHES["treelstm_bwd_megastep"] == len(work)
    assert lm.LAUNCHES["treelstm_bwd_megastep.cuda_launches"] == cuda
    lm.reset_launches()


def test_ops_passes_the_plan_to_the_card_and_ignores_it_on_cpu():
    """``ops.bwd_megastep`` takes the plan keywords; on CPU tensors it
    runs the plain version whatever they say."""
    c = _case("gru", 3, 5, 1, True)
    g, buf, cids, eids, nm, off, ext, w = _torch(c)
    cmask = torch.from_numpy(c["cmask"])
    want = ref.bwd_megastep("gru", g.clone(), buf, cids, cmask, eids, nm,
                            off, ext, w)
    got = ops.bwd_megastep("gru", g.clone(), buf, cids, cmask, eids, nm,
                           off, ext, w, live=0, single=True, heads=None)
    assert torch.equal(got, want)
