"""K11's split of the cache rows over a thread-block cluster, on the CPU.

The card's ``decode_attention`` kernel splits each slot's valid rows
``[lo, len)`` over ``ns`` CTAs and combines their partial softmax
statistics in rank order.  The split's arithmetic lives in Python
(``decode_split.row_range``, ``split_rows``, ``split_count``,
``heads_per_cta``) and is mirrored in ``csrc/decode_attention.cu``;
``ref.decode_attention_split`` is the kernel's assignment and combine in
plain PyTorch.  Here:

- ``ref.decode_attention_split`` at ``ns`` 1, 3 and 8 against the port's
  ``ref.decode_attention``, JAX's ``decode_attention_chunked`` and the
  Pallas ``decode_attention`` in interpret mode, from the same numpy
  inputs: ``kv_len`` 1, inside a tile, on a split edge and = S; windows
  that cross split edges; GQA groups 1, 4 and 12; head dims 16, 80 and
  128.  Tolerance 1e-5 of max |reference| (the reference's own bar is
  2e-5, ``tests/test_kernels.py:98``).
- ``kv_len`` 0 and ``kv_len`` > S against the port's ``ref.decode_attention``
  only (zeros; rows cut at S).  The reference differs there: at 0 the
  Pallas kernel and ``decode_attention_chunked`` average the padded V
  rows and JAX's ``ref`` gives NaN; past S the Pallas kernel attends its
  zero padding (ROADMAP queue 3).  The engine passes neither
  (``kv_len = pos + 1``, at most the cache's length).
- Hypothesis properties: the shares partition ``[lo, len)`` in rank
  order, each at most ``c`` rows, ``c`` a multiple of 8; ``row_range``
  is the plain version's mask.
- The wrapper's launch arguments (``ns`` at granite's shape) with the
  launch itself stubbed, since the kernel needs a card.
- ``emulate_mma`` repeats the bf16 tensor-core route's arithmetic (fp32
  scores of bf16 operands, the online softmax a tile, PV on ``P_hi =
  bf16(P)`` and ``P_lo = bf16(P - P_hi)``, the rank-order combine),
  which the card's bf16 bar of 1e-2 cannot tell from a single bf16 P.
  Held within 1e-5 of max |reference| of ``ref.decode_attention_split``
  and of JAX's ``decode_attention_chunked``: 5.8e-7 to 1.9e-6 on the
  cases here.  Rounding P to bf16 alone gives 3.7e-4 to 1.2e-3 and
  misses the bar, which ``test_mma_route_without_the_p_split_misses_the_bar``
  shows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import decode_attention as jdec
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import decode_split as split
from repro_torch.kernels import ref
from tests.hypothesis_compat import given, settings, st

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)))


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("ns,B,Hq,Hkv,S,D,kv_len,window", [
    (1, 3, 2, 2, 40, 16, [1, 17, 40], None),    # G 1, D 16
    (3, 3, 8, 2, 100, 80, [100, 48, 5], None),  # 48: three shares of 16
    (8, 2, 12, 1, 200, 128, [200, 64], None),   # G 12: 64 = eight of 8
    (3, 2, 8, 2, 100, 80, [100, 57], 30),       # window across the edges
    (8, 3, 4, 1, 96, 128, [96, 1, 70], 20),     # G 4, window, kv_len 1
    (3, 2, 12, 1, 72, 16, [72, 9], 50),         # G 12, D 16
])
def test_split_matches_plain_and_jax(ns, B, Hq, Hkv, S, D, kv_len, window):
    q, k, v = _inputs(ns * 100 + S, B, Hq, Hkv, S, D)
    kvl = np.asarray(kv_len, np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ref.decode_attention_split(tq, tk, tv, kv_len=torch.from_numpy(kvl),
                                     window=window, ns=ns).numpy()
    _close(got, ref.decode_attention(tq, tk, tv, kv_len=torch.from_numpy(kvl),
                                     window=window))
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, kvl))
    _close(got, jdec.decode_attention_chunked(jq, jk, jv, kv_len=jl,
                                              window=window, block_k=32))
    _close(got, jdec.decode_attention(jq, jk, jv, kv_len=jl, window=window,
                                      block_k=32, interpret=True))


@pytest.mark.parametrize("ns", [1, 3, 8])
@pytest.mark.parametrize("window", [None, 4, 30])
def test_split_empty_and_overfull_slots_match_plain(ns, window):
    """``kv_len`` 0 gives zeros and ``kv_len`` > S cuts the rows at S, as
    the port's plain version does (the reference differs; module doc)."""
    q, k, v = map(torch.from_numpy, _inputs(ns, 4, 8, 2, 100, 16))
    kvl = torch.tensor([0, 120, 101, 100], dtype=torch.int32)
    got = ref.decode_attention_split(q, k, v, kv_len=kvl, window=window,
                                     ns=ns)
    want = ref.decode_attention(q, k, v, kv_len=kvl, window=window)
    assert not got[0].any()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=TOL * float(want.abs().max()))


def test_split_defaults_match_plain():
    q, k, v = map(torch.from_numpy, _inputs(7, 2, 4, 4, 70, 32))
    torch.testing.assert_close(ref.decode_attention_split(q, k, v, ns=3),
                               ref.decode_attention(q, k, v), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(
        ref.decode_attention_split(q, k, v, scale=0.3, ns=8),
        ref.decode_attention(q, k, v, scale=0.3), rtol=0, atol=1e-6)


@settings(max_examples=300, deadline=None)
@given(lo=st.integers(0, 5000), n=st.integers(0, 5000),
       ns=st.integers(1, split.MAX_SPLITS))
def test_shares_partition_the_valid_rows(lo, n, ns):
    hi = lo + n
    shares = split.split_rows(lo, hi, ns)
    c = ((n + ns - 1) // ns + 7) // 8 * 8        # the kernel's share
    assert len(shares) == ns and c * ns >= n
    assert shares[0][0] == lo and shares[-1][1] == hi
    for (a0, b0), (a1, b1) in zip(shares, shares[1:]):
        assert a0 <= b0 == a1 <= b1
    assert all(b - a <= c for a, b in shares)
    # Full shares first, then at most one short one, then empty ones.
    full = n // c if c else 0
    assert all(b - a == c for a, b in shares[:full])
    assert all(a == b for a, b in shares[full + 1:])


@settings(max_examples=300, deadline=None)
@given(kv_len=st.integers(-3, 90), S=st.integers(0, 80),
       window=st.one_of(st.none(), st.integers(1, 100)))
def test_row_range_is_the_plain_mask(kv_len, S, window):
    lo, hi = split.row_range(kv_len, S, window)
    assert 0 <= lo <= hi
    rows = np.arange(S)
    want = rows < kv_len
    if window is not None:
        want &= rows >= kv_len - window
    assert set(rows[want]) == set(range(lo, min(hi, S)))
    assert hi <= max(lo, S)


def test_split_count_and_heads_per_cta():
    assert [split.heads_per_cta(g) for g in (1, 2, 3, 4, 5, 8, 12)] == \
        [1, 4, 4, 4, 8, 8, 8]
    assert split.split_count(1024, 64, 132) == 4   # granite: 256 CTAs
    assert split.split_count(64, 64, 132) == 1     # a short cache
    assert split.split_count(65, 64, 132) == 4
    assert split.split_count(4096, 100, 132) == 2  # 200 <= 264 < 400
    assert split.split_count(4096, 300, 132) == 1
    assert split.split_count(4096, 33, 132) == split.MAX_SPLITS
    assert split.split_count(4096, 1, 132) == split.MAX_SPLITS


def test_wrapper_passes_the_split(monkeypatch):
    """The launch's arguments at granite's shape, the launch stubbed: one
    per C parameter, ``ns`` 4, the window and the bf16 flag."""
    seen = []
    monkeypatch.setattr(dec, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(dec, "_sm_count", lambda index: 132)
    monkeypatch.setattr(dec, "launch_kernel",
                        lambda name, dev, *args: seen.append((name, args)))
    q = torch.zeros(8, 32, 128, dtype=torch.bfloat16)
    k = torch.zeros(8, 8, 1024, 128, dtype=torch.bfloat16)
    kvl = torch.full((8,), 300, dtype=torch.int32)
    dec.decode_attention(q, k, k, kv_len=kvl, window=100)
    (name, args), = seen
    assert name == "decode_attention"
    assert len(args) + 1 == len(_build.KERNELS[name][2])  # + the stream
    assert args[5:10] == (8, 32, 8, 1024, 128)
    assert args[-3:] == (100, 4, 1)
    dec.decode_attention(q[:, :4], k[:, :4, :64], k[:, :4, :64], kv_len=kvl)
    assert seen[-1][1][-3:] == (0, 1, 1)


# ---------------------------------------------------------------------------
# The tensor-core route's arithmetic, emulated
# ---------------------------------------------------------------------------

def _tile_rows(D: int) -> int:
    """Rows a tile at bf16 (``layout`` in the ``.cu``): 64, halved while
    a tile of K passes 16 KB, at least 16."""
    tr = 64
    while tr > 16 and tr * D * 2 > 16384:
        tr //= 2
    return tr


def emulate_mma(q, k, v, *, kv_len, window=None, scale=None, ns=1,
                split_p=True) -> torch.Tensor:
    """What K11's bf16 tensor-core route computes, before its one bf16
    rounding of the output, on f32 tensors holding bf16 values: each
    rank's rows (``split_rows``) in tiles of ``_tile_rows(D)``; scores
    ``q . k`` in fp32 times ``scale``; the online softmax once a tile
    (``alpha`` 0 while the max is -inf); PV on ``P_hi = bf16(P)`` then
    ``P_lo = bf16(P - P_hi)`` (``split_p``) or on ``bf16(P)`` alone, the
    sum ``l`` of the unrounded P; the ranks' partials combined in rank
    order, zeros where ``l`` is 0."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g, tr = Hq // Hkv, _tile_rows(D)
    scale = D ** -0.5 if scale is None else scale
    out = torch.zeros((B, Hq, D))
    for b in range(B):
        kk, vv = (t[b].repeat_interleave(g, 0) for t in (k, v))
        parts = []
        for r0, r1 in split.split_rows(
                *split.row_range(int(kv_len[b]), S, window), ns):
            m = torch.full((Hq,), float("-inf"))
            l, acc = torch.zeros(Hq), torch.zeros((Hq, D))
            for t0 in range(r0, r1, tr):
                t1 = min(t0 + tr, r1)
                s = torch.einsum("hd,hrd->hr", q[b], kk[:, t0:t1]) * scale
                mn = torch.maximum(m, s.amax(-1))
                alpha = torch.where(m == float("-inf"), 0.0,
                                    torch.exp(m - mn))
                p = torch.exp(s - mn[:, None])
                l = l * alpha + p.sum(-1)
                hi = p.to(torch.bfloat16).float()
                pieces = ((hi, (p - hi).to(torch.bfloat16).float())
                          if split_p else (hi,))
                acc = acc * alpha[:, None]
                for piece in pieces:
                    acc = acc + torch.einsum("hr,hrd->hd", piece,
                                             vv[:, t0:t1])
                m = mn
            parts.append((m, l, acc))
        mx = torch.stack([mi for mi, _, _ in parts]).amax(0)
        lt, at = torch.zeros(Hq), torch.zeros((Hq, D))
        for mi, li, ai in parts:
            e = torch.where(mi == float("-inf"), 0.0, torch.exp(mi - mx))
            lt = lt + li * e
            at = at + ai * e[:, None]
        out[b] = torch.where(lt[:, None] > 0, at / lt[:, None], 0.0)
    return out


def _bf16_inputs(seed, B, Hq, Hkv, S, D):
    return tuple(torch.from_numpy(x).to(torch.bfloat16).float()
                 for x in _inputs(seed, B, Hq, Hkv, S, D))


#: (ns, B, Hq, Hkv, S, D, kv_len, window): granite's head dim and group
#: (G 4, D 128) at its 1,024-row cache and NS 4, with fills from 1 row to
#: the whole cache; a window across the shares; G 8 at D 64 over NS 8;
#: G 1 at D 256 (tiles of 32 rows) unsplit.
MMA_CASES = [(4, 4, 8, 2, 1024, 128, [632, 17, 1024, 1], None),
             (4, 2, 8, 2, 1024, 128, [900, 300], 100),
             (8, 2, 16, 2, 512, 64, [512, 203], None),
             (1, 2, 2, 2, 300, 256, [300, 77], None)]


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_mma_route_emulation_matches_split_and_jax(case):
    """The tensor-core route keeps about fp32 precision: within 1e-5 of
    max |reference| of ``ref.decode_attention_split`` and of JAX's
    ``decode_attention_chunked``, both on the same bf16 values widened to
    f32."""
    ns, B, Hq, Hkv, S, D, kv_len, window = case
    q, k, v = _bf16_inputs(ns * 1000 + S + D, B, Hq, Hkv, S, D)
    kvl = torch.tensor(kv_len, dtype=torch.int32)
    got = emulate_mma(q, k, v, kv_len=kvl, window=window, ns=ns)
    _close(got, ref.decode_attention_split(q, k, v, kv_len=kvl,
                                           window=window, ns=ns))
    jq, jk, jv, jl = (jnp.asarray(t.numpy()) for t in (q, k, v, kvl))
    _close(got, jdec.decode_attention_chunked(jq, jk, jv, kv_len=jl,
                                              window=window, block_k=64))


def test_mma_route_without_the_p_split_misses_the_bar():
    """P rounded to bf16 alone keeps 8 bits: the 1e-5 bar catches it, so
    the ``P_hi + P_lo`` split is what the emulation test passes on."""
    ns, B, Hq, Hkv, S, D, kv_len, window = MMA_CASES[0]
    q, k, v = _bf16_inputs(ns * 1000 + S + D, B, Hq, Hkv, S, D)
    kvl = torch.tensor(kv_len, dtype=torch.int32)
    want = ref.decode_attention_split(q, k, v, kv_len=kvl, ns=ns)
    bar = TOL * float(want.abs().max())
    split_err = float((emulate_mma(q, k, v, kv_len=kvl, ns=ns)
                       - want).abs().max())
    bf16_err = float((emulate_mma(q, k, v, kv_len=kvl, ns=ns, split_p=False)
                      - want).abs().max())
    assert split_err <= bar < bf16_err, (split_err, bar, bf16_err)
