"""The port's attention layer against the JAX package on the CPU: the plain
versions of K10/K11 (``ref.mha``, ``ref.decode_attention``), the
transformer building blocks (``rmsnorm``, interleaved ``apply_rope``,
``swiglu``, ``cross_entropy``) and ``gqa_apply`` in its three modes.

- ``ref.mha`` against JAX's ``ref.mha``, ``attention_chunked`` and the
  Pallas ``flash_attention`` in interpret mode, at the shapes of
  ``tests/test_kernels.py`` (causal and not, window, GQA, Sq != Sk).
- ``ref.decode_attention`` against JAX's ``ref.decode_attention``,
  ``decode_attention_chunked`` and the Pallas ``decode_attention`` in
  interpret mode, ragged ``kv_len`` and a window.
- ``gqa_apply`` train/prefill/decode with JAX's params, over GQA (group
  4) and the rolling sliding-window cache of ``reduced(mixtral-8x22b)``.
- The ``ops`` dispatch on CPU tensors, and the kernel wrappers refusing
  them.

Tolerances: 1e-5 of max |reference| on attention (the reference's own
bar is 2e-5, ``tests/test_kernels.py:98``); 1e-6 on the elementwise
blocks; 1e-5 relative on ``gqa_apply``, whose products sum in another
order than XLA's.  A query with no valid key is a zero row in the port
and NaN in JAX's ``ref.mha``: such rows are kept out of the comparison."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.configs.archs import reduced as jreduced
from repro.kernels import decode_attention as jdec
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.obs.registry import get_registry

TOL, ELEM_TOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL, rows=None):
    """``|got - want| <= tol * max |want|`` over ``rows`` (a boolean mask
    of the leading dims, default all)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# K10's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("sq,sk", [(64, 64), (40, 72)])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_matches_jax_ref_chunked_and_pallas(hq, hkv, sq, sk, causal):
    rng = np.random.default_rng(hq * 100 + sq + causal)
    q, k, v = (_randn(rng, 2, hq, sq, 32), _randn(rng, 2, hkv, sk, 32),
               _randn(rng, 2, hkv, sk, 32))
    got = ref.mha(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jref.mha(jq, jk, jv, causal=causal))
    _close(got, jfa.attention_chunked(jq, jk, jv, causal=causal,
                                      block_q=32, block_k=32))
    _close(got, jfa.flash_attention(jq, jk, jv, causal=causal, block_q=32,
                                    block_k=32, interpret=True))


def test_mha_window_matches_jax():
    rng = np.random.default_rng(24)
    q, k, v = (_randn(rng, 1, 2, 96, 16) for _ in range(3))
    got = ref.mha(*map(torch.from_numpy, (q, k, v)), causal=True,
                  window=24).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jref.mha(jq, jk, jv, causal=True, window=24))
    _close(got, jfa.flash_attention(jq, jk, jv, causal=True, window=24,
                                    block_q=32, block_k=32, interpret=True))


def test_mha_gqa_odd_widths_matches_chunked_twin():
    rng = np.random.default_rng(70)
    q, k, v = (_randn(rng, 2, 4, 70, 24), _randn(rng, 2, 2, 70, 24),
               _randn(rng, 2, 2, 70, 24))
    got = ref.mha(*map(torch.from_numpy, (q, k, v))).numpy()
    _close(got, jfa.attention_chunked(*map(jnp.asarray, (q, k, v)),
                                      block_q=32, block_k=32))


def test_mha_scale_and_rows_without_keys():
    """``scale`` as the kernel takes it; with Sq > Sk under ``causal`` the
    first Sq - Sk queries see no key: zero rows here, NaN in JAX's
    ``ref.mha``, which the comparison leaves out."""
    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, 1, 2, 50, 32), _randn(rng, 1, 2, 30, 32),
               _randn(rng, 1, 2, 30, 32))
    got = ref.mha(*map(torch.from_numpy, (q, k, v)), scale=0.3).numpy()
    want = np.asarray(jref.mha(*map(jnp.asarray, (q, k, v)), scale=0.3))
    live = np.zeros((1, 2, 50), bool)
    live[:, :, 20:] = True
    assert np.isnan(want[~live]).all() and (got[~live] == 0).all()
    _close(got, want, rows=live)


# ---------------------------------------------------------------------------
# K11's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv,s", [(4, 4, 33), (8, 2, 128)])
def test_decode_attention_matches_jax(hq, hkv, s):
    rng = np.random.default_rng(s)
    q, k, v = (_randn(rng, 3, hq, 32), _randn(rng, 3, hkv, s, 32),
               _randn(rng, 3, hkv, s, 32))
    kvl = np.asarray([s, max(1, s // 2), 1], np.int32)
    got = ref.decode_attention(*map(torch.from_numpy, (q, k, v)),
                               kv_len=torch.from_numpy(kvl)).numpy()
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, kvl))
    _close(got, jref.decode_attention(jq, jk, jv, kv_len=jl))
    _close(got, jdec.decode_attention_chunked(jq, jk, jv, kv_len=jl,
                                              block_k=32))
    _close(got, jdec.decode_attention(jq, jk, jv, kv_len=jl, block_k=32,
                                      interpret=True))


def test_decode_attention_window_and_defaults_match_jax():
    rng = np.random.default_rng(16)
    q, k, v = (_randn(rng, 2, 4, 16), _randn(rng, 2, 4, 64, 16),
               _randn(rng, 2, 4, 64, 16))
    kvl = np.asarray([64, 40], np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ref.decode_attention(tq, tk, tv, kv_len=torch.from_numpy(kvl),
                               window=16).numpy()
    _close(got, jref.decode_attention(jq, jk, jv, kv_len=jnp.asarray(kvl),
                                      window=16))
    _close(got, jdec.decode_attention(jq, jk, jv, kv_len=jnp.asarray(kvl),
                                      window=16, block_k=16, interpret=True))
    # No kv_len: every row; and ``scale`` as the Pallas kernel takes it.
    _close(ref.decode_attention(tq, tk, tv).numpy(),
           jref.decode_attention(jq, jk, jv))
    _close(ref.decode_attention(tq, tk, tv, scale=0.2).numpy(),
           jdec.decode_attention_chunked(jq, jk, jv, scale=0.2))


def test_decode_attention_is_mha_of_one_query():
    """One query at the end of a cache of ``kv_len`` rows is the last row
    of causal ``mha`` over those rows."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 8, 64)),
               torch.from_numpy(_randn(rng, 1, 2, 20, 64)),
               torch.from_numpy(_randn(rng, 1, 2, 20, 64)))
    kvl = torch.tensor([13], dtype=torch.int32)
    got = ref.decode_attention(q, k, v, kv_len=kvl, window=5)
    want = ref.mha(q[:, :, None], k[:, :, :13], v[:, :, :13],
                   window=5)[:, :, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_swiglu_cross_entropy_match_jax():
    rng = np.random.default_rng(7)
    x = _randn(rng, 2, 5, 24)
    scale = _randn(rng, 24)
    _close(tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x)).numpy(),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           ELEM_TOL)
    # RoPE at odd positions, [S] and per-batch [B, 1, 1] positions.
    pos = np.asarray([1, 3, 7, 101, 999], np.int32)
    h = _randn(rng, 2, 3, 5, 32)
    _close(tlayers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                              500.0).numpy(),
           jlayers.apply_rope(jnp.asarray(h), jnp.asarray(pos), 500.0),
           ELEM_TOL)
    bpos = np.asarray([[[5]], [[77]]], np.int32)
    h1 = _randn(rng, 2, 3, 1, 32)
    _close(tlayers.apply_rope(torch.from_numpy(h1),
                              torch.from_numpy(bpos)).numpy(),
           jlayers.apply_rope(jnp.asarray(h1), jnp.asarray(bpos)), ELEM_TOL)
    # The pairs are interleaved: position p rotates (x0, x1) by p * 1.
    e = torch.zeros(1, 1, 4)
    e[..., 0] = 1.0
    r = tlayers.apply_rope(e, torch.tensor([1]))
    assert torch.allclose(r[0, 0, :2], torch.tensor([np.cos(1.0),
                                                     np.sin(1.0)],
                                                    dtype=torch.float32))
    p = jlayers.swiglu_init(jax.random.PRNGKey(1), 24, 40)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    _close(tlayers.swiglu(tp, torch.from_numpy(x)).numpy(),
           jlayers.swiglu(p, jnp.asarray(x)), ELEM_TOL)
    logits = _randn(rng, 3, 4, 11)
    labels = rng.integers(0, 11, (3, 4)).astype(np.int32)
    mask = (rng.random((3, 4)) > 0.3).astype(np.float32)
    got, gm = tlayers.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(mask), z_loss=1e-3)
    want, wm = jlayers.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels), jnp.asarray(mask),
                                     z_loss=1e-3)
    assert abs(float(got) - float(want)) <= ELEM_TOL * abs(float(want))
    assert float(gm["tokens"]) == float(wm["tokens"])


def test_rmsnorm_bf16_computes_in_f32():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0)) * 30
    got = tlayers.rmsnorm({"scale": torch.ones(64, dtype=torch.bfloat16)},
                          x.to(torch.bfloat16))
    want = tlayers.rmsnorm({"scale": torch.ones(64)},
                           x.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_inits_follow_the_generator():
    g = torch.Generator().manual_seed(3)
    w = tlayers.dense_init(g, 16, 8, torch.bfloat16, "cpu")
    e = tlayers.embed_init(torch.Generator().manual_seed(3), 16, 8)
    assert w.dtype == torch.bfloat16 and w.shape == (16, 8)
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(e, x * 0.02)
    torch.testing.assert_close(w, (x * 16 ** -0.5).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# gqa_apply
# ---------------------------------------------------------------------------

def _dims_pair(n_q, n_kv, window=None, bias=False):
    kw = dict(d_model=48, n_q=n_q, n_kv=n_kv, head_dim=16, window=window,
              rope_theta=1000.0, bias=bias)
    return jattn.AttnDims(**kw), tattn.AttnDims(**kw)


def _gqa_params(jd, seed, bias):
    p = {k: np.asarray(v) for k, v in
         jattn.gqa_init(jax.random.PRNGKey(seed), jd).items()}
    rng = np.random.default_rng(seed)
    if bias:                        # nonzero biases reach every head
        p = {k: (_randn(rng, *v.shape) * 0.1 if k.startswith("b") else v)
             for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


@pytest.mark.parametrize("n_q,n_kv,window,bias", [
    (8, 2, None, False), (4, 4, None, True), (8, 2, 6, False)])
def test_gqa_train_and_prefill_match_jax(n_q, n_kv, window, bias):
    jd, td = _dims_pair(n_q, n_kv, window, bias)
    jp, tp = _gqa_params(jd, n_q + n_kv, bias)
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 11, 48)
    pos = np.arange(11, dtype=np.int32)
    for mode in ("train", "prefill"):
        jy, jc = jax.jit(functools.partial(
            jattn.gqa_apply, dims=jd, mode=mode, attn_impl="chunked"))(
                jp, jnp.asarray(x), jnp.asarray(pos))
        ty, tc = tattn.gqa_apply(tp, torch.from_numpy(x),
                                 torch.from_numpy(pos), dims=td, mode=mode)
        _close(ty.numpy(), jy)
        if mode == "prefill":
            _close(tc["k"].numpy(), jc["k"])
            _close(tc["v"].numpy(), jc["v"])
        else:
            assert tc is None and jc is None


@pytest.mark.parametrize("n_q,n_kv,window,L", [
    (8, 2, None, 24),      # GQA, plain cache
    (8, 2, 5, 24),         # windowed attention over a full-length cache
    (4, 4, 16, 16)])       # rolling SWA cache (reduced mixtral's window)
def test_gqa_decode_matches_jax(n_q, n_kv, window, L):
    """Decode steps from a prefilled cache, two sequences at ragged
    positions; the rolling case wraps past its ``window`` rows."""
    jd, td = _dims_pair(n_q, n_kv, window)
    jp, tp = _gqa_params(jd, 3, False)
    rng = np.random.default_rng(2)
    steps = 18
    jc = jattn.gqa_empty_cache(jd, 2, L)
    tc = tattn.gqa_empty_cache(td, 2, L, device="cpu")
    pos = np.asarray([0, 4], np.int32)
    jstep = jax.jit(lambda p, x, c, cp: jattn.gqa_apply(
        p, x, None, dims=jd, mode="decode", cache=c, cache_pos=cp,
        attn_impl="chunked"))
    for t in range(steps):
        x = _randn(rng, 2, 1, 48)
        jy, jc = jstep(jp, jnp.asarray(x), jc, jnp.asarray(pos))
        ty, tc2 = tattn.gqa_apply(tp, torch.from_numpy(x), None, dims=td,
                                  mode="decode", cache=tc,
                                  cache_pos=torch.from_numpy(pos))
        assert tc2 is tc                      # written in place
        _close(ty.numpy(), jy)
        pos = pos + 1
    _close(tc["k"].numpy(), jc["k"])
    _close(tc["v"].numpy(), jc["v"])


def test_reduced_mixtral_window_reaches_the_rolling_cache():
    jd_cfg = jreduced(jget("mixtral-8x22b"))
    from repro_torch.configs import get_config
    from repro_torch.configs.archs import reduced
    cfg = reduced(get_config("mixtral-8x22b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jd_cfg)
    assert cfg.window == 16


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_ops_dispatch_cpu_to_plain_and_wrappers_refuse_cpu():
    rng = np.random.default_rng(0)
    q4, k4 = (torch.from_numpy(_randn(rng, 1, 4, 6, 8)),
              torch.from_numpy(_randn(rng, 1, 2, 6, 8)))
    q3 = torch.from_numpy(_randn(rng, 1, 4, 8))
    reg = get_registry()
    before = {op: reg.counter("kernel.dispatch", op=op, impl="ref")
              for op in ("attention", "decode_attention")}
    assert torch.equal(ops.attention(q4, k4, k4, window=3),
                       ref.mha(q4, k4, k4, window=3))
    kvl = torch.tensor([4], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q3, k4, k4, kv_len=kvl),
                       ref.decode_attention(q3, k4, k4, kv_len=kvl))
    for op in before:
        assert reg.counter("kernel.dispatch", op=op, impl="ref") == \
            before[op] + 1
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q4, k4, k4)
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention(q3, k4, k4, kv_len=kvl)
