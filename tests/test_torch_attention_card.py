"""The attention kernels on the card: K10 ``flash_attention`` and K11
``decode_attention`` against their plain versions (``ref.mha``,
``ref.decode_attention``, computing in float32 on float32 copies of the
inputs) at edge shapes -- Sq 1, Sq != Sk without ``causal``, windows,
Hq = Hkv and GQA groups up to 12, head dims 7 to 256, lengths no
multiple of a tile, ``kv_len`` 0, 1 and ragged, caches of 4,096 rows,
unaligned cache rows, float32 and bf16 -- two launches bitwise equal,
K11 one launch a call and at f32 within 1e-6 of its split computed in
plain PyTorch (``ref.decode_attention_split``) whatever the cluster size,
K11 and bf16 K10 refusing a gradient (f32 K10 giving one), and the launch
counts of ``ServeEngine`` over a small LM on the card (one K10 a layer a
prompt, one K11 a layer a tick) with its greedy tokens equal to a full
recompute at f32, every K10 launch on the tf32 route at f32 and on the
wgmma route at bf16.  Every test here is ``gpu``-marked and skips inside
its body where there is no card; none needs JAX, which the GPU machine
lacks.

Bars: 1e-5 of max |plain| at float32 (the kernels sum in another order)
and 1e-2 at bf16 (one bf16 rounding of the output, and the operands'
own bf16 rounding, which the plain version sees too).

bf16 K10 takes the wgmma route (``csrc/flash_attention_sm90.cu``: bf16
``wgmma`` for QKᵀ and for PV on ``P_hi + P_lo``, TMA staging) where
``D % 16 == 0``; every other head dim, and f32 at every head dim, the
tf32 route (``csrc/flash_attention_tf32.cu``: TF32 ``mma.sync``, an f32
product split into three, a bf16 operand exact in one; ``cp.async``
staging, a head dim no multiple of 8 zero-padded to the next); the K10
cases check which route each launch took.  They cover head dims 7, 16,
20, 32, 36, 40, 64, 80, 100, 128, 160 and 256 (every padded width of the
wgmma kernel's shared tiles and every class of the tf32 kernel's; the
ragged ones on the tf32 route at both types, 100 at 1,024 tokens),
Sq 1, 63, 65, 127 and 129, Sq != Sk without ``causal``, a window starting
inside a key tile, GQA groups 1, 4, 8 and 12, a 2,048-token causal
prefill, q as a permuted view, and Sq > Sk (rows with no key, exactly
zero).  Against the plain version on
f32 copies of the same bf16 operands the wgmma route's error is that
of the output's one bf16 rounding (unit roundoff 2^-8 = 3.9e-3 of an
element): 1.2e-3 to 3.6e-3 of max |plain| on the H100 (NVIDIA H100
80GB HBM3, 700 W; these cases and ``chip_smoke.py`` phase 15's edges
and kept launches), far under the 1e-2 bar."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.archs import reduced
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import ref
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import Request, ServeEngine

BARS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen).to("cuda", dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _check(got, again, want, dtype):
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again)), "two launches differ"
    assert torch.isfinite(got).all()
    err = float((got.float() - want).abs().max())
    assert err <= BARS[dtype] * float(want.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", [
    (1, 32, 8, 1, 1, 128, True, None),        # Sq 1
    (2, 4, 4, 40, 72, 64, False, None),       # Sq != Sk, not causal
    (1, 8, 2, 96, 96, 64, True, 24),          # window 24
    (2, 32, 8, 100, 100, 128, True, None),    # group 4, ragged tiles
    (1, 16, 2, 33, 65, 80, True, None),       # group 8, D 80
    (1, 32, 8, 1024, 1024, 128, True, None),  # a full prefill bucket
    (1, 4, 1, 63, 63, 32, True, None),        # D 32, Sq 63, group 4
    (1, 8, 1, 65, 65, 64, True, None),        # Sq 65, group 8
    (1, 16, 2, 127, 127, 80, True, None),     # Sq 127
    (2, 12, 1, 129, 129, 128, True, None),    # Sq 129, group 12
    (1, 4, 4, 1, 1, 256, True, None),         # D 256, Sq 1, group 1
    (1, 4, 4, 65, 130, 256, True, None),      # D 256, ragged keys
    (1, 4, 2, 100, 100, 160, True, None),     # D 160 (192 in smem)
    (1, 2, 2, 70, 70, 16, False, None),       # D 16 (64 in smem)
    (1, 8, 2, 65, 200, 128, False, None),     # Sq < Sk, not causal
    (1, 8, 2, 300, 300, 128, True, 100),      # window inside a key tile
    (1, 4, 4, 129, 50, 128, True, None),      # Sq > Sk: zero rows
    (1, 32, 8, 2048, 2048, 128, True, None),  # a 2,048-token prefill
    (1, 8, 2, 100, 100, 20, True, None),      # D 20: tf32, padded to 24
    (1, 4, 2, 129, 129, 40, True, 50),        # D 40: tf32 at both types
    (2, 4, 4, 40, 72, 36, False, None),       # D 36, Sq != Sk
    (1, 4, 2, 65, 65, 7, True, None),         # D 7: 4- and 2-byte copies
    (1, 8, 2, 1024, 1024, 100, True, None),   # D 100 at 1,024 tokens
])
def test_flash_attention_matches_plain(dt, B, Hq, Hkv, Sq, Sk, D, causal,
                                       window):
    _need_card()
    dtype = DTYPES[dt]
    gen = torch.Generator().manual_seed(Sq * 7 + D)
    q = _randn(gen, B, Sq, Hq, D, dtype=dtype).transpose(1, 2)  # a view
    k, v = (_randn(gen, B, Hkv, Sk, D, dtype=dtype) for _ in range(2))
    run = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                     window=window)
    want = ref.mha(q.float(), k.float(), v.float(), causal=causal,
                   window=window)
    lm.reset_launches()
    got = run()
    _check(got, run(), want, dtype)
    path = "wgmma" if dtype == torch.bfloat16 and D % 16 == 0 else "tf32"
    assert fa.route(dtype, D) == path
    assert dict(lm.LAUNCHES) == {"flash_attention": 2,
                                 f"flash_attention.{path}": 2}
    if causal and Sq > Sk:
        assert not got[:, :, :Sq - Sk].any(), "a row with no key is not 0"


@pytest.mark.gpu
@pytest.mark.parametrize("D,pad,off", [(64, 2, 0), (128, 1, 1), (40, 0, 1)])
def test_flash_attention_tf32_narrow_strides_match_plain(D, pad, off):
    """f32 operands whose rows are D + pad elements apart or whose base
    sits ``off`` elements past 16 bytes: the tf32 kernel copies them 4
    bytes at a time (no 16-byte ``cp.async``), in the same launch."""
    _need_card()
    gen = torch.Generator().manual_seed(D + pad + off)
    q = _randn(gen, 1, 8, 70, D + pad + off, dtype=torch.float32)
    k, v = (_randn(gen, 1, 2, 90, D + pad + off, dtype=torch.float32)
            for _ in range(2))
    q, k, v = (t[..., off:off + D] for t in (q, k, v))
    assert fa.route(torch.float32, D) == "tf32"
    run = lambda: fa.flash_attention(q, k, v)  # noqa: E731
    want = ref.mha(q, k, v)
    lm.reset_launches()
    _check(run(), run(), want, torch.float32)
    assert dict(lm.LAUNCHES) == {"flash_attention": 2,
                                 "flash_attention.tf32": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("D,pad,off", [(20, 3, 1), (100, 0, 2), (36, 4, 0)])
def test_flash_attention_bf16_tf32_route_strides_match_plain(D, pad, off):
    """bf16 operands at head dims the wgmma route does not take, rows
    D + pad elements apart from a base ``off`` elements past 16 bytes:
    the tf32 kernel stages them raw by the widest copy that divides the
    rows, strides and bases (plain 2-byte loads at an odd stride, 4-byte
    ``cp.async`` at a 4-byte base, 8-byte at D 36), within the bf16 bar,
    on the tf32 route."""
    _need_card()
    gen = torch.Generator().manual_seed(D + pad + off)
    q = _randn(gen, 1, 8, 70, D + pad + off, dtype=torch.bfloat16)
    k, v = (_randn(gen, 1, 2, 90, D + pad + off, dtype=torch.bfloat16)
            for _ in range(2))
    q, k, v = (t[..., off:off + D] for t in (q, k, v))
    assert fa.route(torch.bfloat16, D) == "tf32"
    run = lambda: fa.flash_attention(q, k, v)  # noqa: E731
    want = ref.mha(q.float(), k.float(), v.float())
    lm.reset_launches()
    _check(run(), run(), want, torch.bfloat16)
    assert dict(lm.LAUNCHES) == {"flash_attention": 2,
                                 "flash_attention.tf32": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,S,D,kv_len,window", [
    (8, 32, 8, 1024, 128, [1, 17, 600, 1024, 2, 333, 64, 1000], None),
    (3, 4, 4, 33, 64, [33, 16, 1], None),     # Hq = Hkv, kv_len 1
    (2, 8, 2, 100, 64, [100, 41], 24),         # window 24
    (2, 24, 2, 50, 80, [50, 7], None),         # group 12: two CTAs a head
    (4, 8, 2, 100, 64, [0, 100, 37, 0], None),  # kv_len 0: zero rows
    (2, 32, 8, 4096, 128, [4000, 17], None),   # S 4,096
    (2, 8, 8, 300, 256, [300, 129], None),     # D 256, group 1
    (3, 16, 2, 200, 16, [200, 3, 150], None),  # D 16, group 8
    (2, 32, 8, 1024, 128, [1000, 250], 100),   # window 100 across shares
])
def test_decode_attention_matches_plain(dt, B, Hq, Hkv, S, D, kv_len,
                                        window):
    _need_card()
    dtype = DTYPES[dt]
    gen = torch.Generator().manual_seed(S + D)
    q = _randn(gen, B, Hq, D, dtype=dtype)
    k, v = (_randn(gen, B, Hkv, S, D, dtype=dtype) for _ in range(2))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    run = lambda: dec.decode_attention(q, k, v, kv_len=kvl,  # noqa: E731
                                       window=window)
    want = ref.decode_attention(q.float(), k.float(), v.float(), kv_len=kvl,
                                window=window)
    _check(run(), run(), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D,pad", [(64, 1), (20, 0), (7, 3)])
def test_decode_attention_narrow_staging_matches_plain(dt, D, pad):
    """Rows that are not 16-byte aligned (a cache view whose row stride is
    D + pad elements) or not a multiple of 16 bytes long take the
    kernel's element-wise staging path, split over a cluster."""
    _need_card()
    dtype = DTYPES[dt]
    gen = torch.Generator().manual_seed(D + pad)
    B, Hq, Hkv, S = 3, 8, 2, 300
    q = _randn(gen, B, Hq, D, dtype=dtype)
    k, v = (_randn(gen, B, Hkv, S, D + pad, dtype=dtype)[..., :D]
            for _ in range(2))
    kvl = torch.tensor([300, 77, 1], dtype=torch.int32, device="cuda")
    run = lambda: dec.decode_attention(q, k, v, kv_len=kvl)  # noqa: E731
    want = ref.decode_attention(q.float(), k.float(), v.float(), kv_len=kvl)
    _check(run(), run(), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("ns", [1, 3, 8])
def test_decode_attention_is_one_launch_of_the_split(monkeypatch, ns):
    """One call is one launch (one count in ``LAUNCHES``), and at f32 the
    kernel equals ``ref.decode_attention_split`` -- the same rows a rank,
    combined in rank order -- within 1e-6 of max |plain|; ``ns`` forced."""
    _need_card()
    monkeypatch.setattr(dec, "split_count", lambda S, clusters, sms: ns)
    gen = torch.Generator().manual_seed(ns)
    q = _randn(gen, 8, 32, 128, dtype=torch.float32)
    k, v = (_randn(gen, 8, 8, 1024, 128, dtype=torch.float32)
            for _ in range(2))
    kvl = torch.tensor([1, 17, 600, 1024, 2, 333, 64, 1000],
                       dtype=torch.int32, device="cuda")
    lm.reset_launches()
    got = dec.decode_attention(q, k, v, kv_len=kvl, window=500)
    torch.cuda.synchronize()
    assert dict(lm.LAUNCHES) == {"decode_attention": 1}
    want = ref.decode_attention_split(q, k, v, kv_len=kvl, window=500, ns=ns)
    plain = ref.decode_attention(q, k, v, kv_len=kvl, window=500)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(plain.abs().max()), err


@pytest.mark.gpu
def test_wrappers_refuse_grad_and_bad_operands():
    """K11 refuses a gradient, and K10 at bf16 (its wgmma forward saves no
    log-sum-exp); K10 at f32 differentiates (its backward is
    ``tests/test_torch_attention_bwd_card.py``'s); both refuse bad
    operands."""
    _need_card()
    q = torch.randn(1, 4, 8, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 2, 8, 64, device="cuda")
    with pytest.raises(NotImplementedError, match="forward only"):
        dec.decode_attention(q[:, :, 0], k, k)
    with pytest.raises(NotImplementedError, match="K10 backward at bf16"):
        fa.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    out = fa.flash_attention(q, k, k)
    (g,) = torch.autograd.grad(out.sum(), q)
    assert g.shape == q.shape and bool(torch.isfinite(g).all())
    with torch.no_grad():
        fa.flash_attention(q, k, k)
    k3 = torch.randn(1, 3, 8, 64, device="cuda")
    with pytest.raises(ValueError, match="fold"):
        fa.flash_attention(q.detach(), k3, k3)
    with pytest.raises(TypeError):
        dec.decode_attention(q.detach()[:, :, 0], k.half(), k.half())
    with pytest.raises(ValueError, match="kv_len"):
        dec.decode_attention(q.detach()[:, :, 0], k, k,
                             kv_len=torch.ones(1, dtype=torch.int64,
                                               device="cuda"))


@pytest.mark.gpu
def test_serve_engine_launches_and_tokens_on_the_card():
    """A small f32 LM served on the card: one K10 launch a layer a prompt,
    each on the tf32 route (head dim 32), one K11 a layer a tick, and
    every request's greedy tokens equal to a full recompute on the
    card."""
    _need_card()
    cfg = reduced(get_config("granite-3-8b"))
    model = TransformerLM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    eng = ServeEngine(model, params, num_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)), max_new_tokens=6)
            for i, n in enumerate((3, 9, 16, 30, 5))]
    for r in reqs:
        assert eng.submit(r)
    lm.reset_launches()
    done = eng.run()
    L = cfg.num_layers
    assert lm.LAUNCHES["flash_attention"] == L * len(reqs)
    assert lm.LAUNCHES["flash_attention.tf32"] == L * len(reqs)
    assert lm.LAUNCHES["decode_attention"] == L * eng.ticks
    assert all(r.status == "ok" for r in done)
    with torch.no_grad():
        for r in done:
            toks = [int(t) for t in r.prompt]
            for want in r.output:
                x = model.embed(params, torch.tensor([toks], device="cuda"))
                h, _ = model.trunk(params, x, mode="train",
                                   positions=torch.arange(len(toks),
                                                          device="cuda"))
                assert int(torch.argmax(model.logits(params, h)[0, -1])) \
                    == want
                toks.append(want)


@pytest.mark.gpu
def test_bf16_serve_engine_takes_the_wgmma_route():
    """A small bf16 LM (head dim 32) served on the card: every K10 launch
    on the wgmma route, one a layer a prompt, every request ``ok``."""
    _need_card()
    cfg = dataclasses.replace(reduced(get_config("granite-3-8b")),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    eng = ServeEngine(model, params, num_slots=4, max_len=64)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)), max_new_tokens=4)
            for i, n in enumerate((3, 9, 16, 30, 5))]
    for r in reqs:
        assert eng.submit(r)
    lm.reset_launches()
    done = eng.run()
    L = cfg.num_layers
    assert all(r.status == "ok" for r in done)
    assert lm.LAUNCHES["flash_attention"] == L * len(reqs)
    assert lm.LAUNCHES["flash_attention.wgmma"] == L * len(reqs)
    assert "flash_attention.tf32" not in lm.LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,path", [(32, "tf32"), (20, "tf32")])
def test_f32_serve_engine_takes_one_route(head_dim, path):
    """The reduced f32 model served through ``ServeEngine`` on the card:
    at head dim 32 (its own) and at the ragged head dim 20 every K10
    launch on the tf32 route; no launch on another route, every request
    ``ok``."""
    _need_card()
    cfg = dataclasses.replace(reduced(get_config("granite-3-8b")),
                              head_dim=head_dim)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    eng = ServeEngine(model, params, num_slots=4, max_len=64)
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)), max_new_tokens=4)
            for i, n in enumerate((3, 9, 16, 30, 5))]
    for r in reqs:
        assert eng.submit(r)
    lm.reset_launches()
    done = eng.run()
    L = cfg.num_layers
    assert all(r.status == "ok" for r in done)
    routes = {k: n for k, n in lm.LAUNCHES.items()
              if k.startswith("flash_attention.")}
    assert routes == {f"flash_attention.{path}": L * len(reqs)}, routes
