"""Mamba-2 serving in the port against the JAX package on the CPU, on
``reduced(mamba2-370m)`` (4 Mamba blocks, d_model 128, 16 heads of 16,
state 16, chunk 8, f32):

- ``mamba_apply`` in train, prefill and decode mode and its cache leaves
  (prompts of 1, 2, 13 and 24 tokens: the conv tail's zero rows, a
  ragged last chunk, whole chunks) against JAX's, one case on JAX's
  Pallas SSD kernel in interpret mode;
- ``interop.lm_params_from_numpy`` carries a Mamba block's leaves out of
  the reference's stacked ``pattern``;
- ``TransformerLM`` prefill logits and 8 decode steps against JAX's;
- ``CacheSlots.admit`` writes the ``conv`` ``[1, 3, conv_dim]`` and
  ``ssm`` ``[1, H, P, N]`` leaves into a slot;
- ``ServeEngine(pad_prompts=False)`` greedy tokens equal to JAX's
  ``ServeEngine(pad_prompts=False)`` and to a full recompute on the same
  traffic (staggered admission, slot reuse);
- ``repro_torch/launch/serve.py --device cpu`` for mamba2-370m and
  granite-3-8b.

Tolerance: 1e-4 of max |reference| (the reference's own bar for the
mixer and the LM); greedy tokens exactly."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.configs.archs import reduced as jreduced
from repro.models import mamba as jmamba
from repro.models.transformer import TransformerLM as JLM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.configs.archs import reduced
from repro_torch.interop import lm_params_from_numpy, params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import CacheSlots, Request, ServeEngine

TOL = 1e-4
ARCH = "mamba2-370m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), \
        (err, float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX lm, JAX params, port lm, port params) of ``reduced(mamba2)``
    from one JAX init."""
    jlm = JLM(jreduced(jget(ARCH)))
    jp = jlm.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(ARCH))
    lm = TransformerLM(cfg)
    return jlm, jp, lm, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                             cfg, device="cpu")


def _dims(cfg):
    m = cfg.mamba
    return m, dict(d_model=cfg.d_model, d_state=m.d_state, headdim=m.headdim,
                   expand=m.expand, d_conv=m.d_conv, chunk=m.chunk)


@functools.lru_cache(maxsize=None)
def _mixer():
    _, kw = _dims(reduced(get_config(ARCH)))
    jdims, dims = jmamba.MambaDims(**kw), mamba.MambaDims(**kw)
    jp = jmamba.mamba_init(jax.random.PRNGKey(3), jdims)
    # A_log, D and dt_bias away from their constant init, so every leaf
    # counts.
    rng = np.random.default_rng(3)
    H = dims.n_heads
    jp = dict(jp, A_log=jnp.asarray(rng.normal(0, 0.5, H), jnp.float32),
              D=jnp.asarray(rng.uniform(0.5, 1.5, H), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(-2, 0.5, H), jnp.float32),
              conv_b=jnp.asarray(rng.normal(0, 0.1, dims.conv_dim),
                                 jnp.float32))
    return jdims, jp, dims, params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu")


@pytest.mark.parametrize("L,impl", [(1, "chunked"), (2, "chunked"),
                                    (13, "chunked"), (24, "chunked"),
                                    (2, "pallas"), (13, "pallas")])
def test_mamba_apply_all_modes_match_jax(L, impl):
    jdims, jp, dims, tp = _mixer()
    rng = np.random.default_rng(L)
    x = rng.standard_normal((2, L, dims.d_model)).astype(np.float32)
    jy, _ = jmamba.mamba_apply(jp, jnp.asarray(x), dims=jdims, mode="train",
                               ssd_impl=impl)
    jyp, jc = jmamba.mamba_apply(jp, jnp.asarray(x), dims=jdims,
                                 mode="prefill", ssd_impl=impl)
    with torch.no_grad():
        ty, tc0 = mamba.mamba_apply(tp, torch.from_numpy(x), dims=dims,
                                    mode="train")
        typ, tc = mamba.mamba_apply(tp, torch.from_numpy(x), dims=dims,
                                    mode="prefill")
    assert tc0 is None
    _close(ty, jy)
    _close(typ, jyp)
    assert tc["conv"].shape == (2, dims.d_conv - 1, dims.conv_dim)
    assert tc["ssm"].shape == (2, dims.n_heads, dims.headdim, dims.d_state)
    assert tc["ssm"].dtype == torch.float32
    _close(tc["conv"], jc["conv"])
    _close(tc["ssm"], jc["ssm"])
    if L < dims.d_conv - 1:
        assert not tc["conv"][:, :dims.d_conv - 1 - L].any()
    # Three decode steps from the prefilled caches; the port's cache is
    # updated in place and returned.
    for step in range(3):
        xt = rng.standard_normal((2, 1, dims.d_model)).astype(np.float32)
        jo, jc = jmamba.mamba_apply(jp, jnp.asarray(xt), dims=jdims,
                                    mode="decode", cache=jc)
        with torch.no_grad():
            to, tc2 = mamba.mamba_apply(tp, torch.from_numpy(xt), dims=dims,
                                        mode="decode", cache=tc)
        assert tc2 is tc
        _close(to, jo)
        _close(tc["conv"], jc["conv"])
        _close(tc["ssm"], jc["ssm"])


def test_empty_cache_and_init_match_the_reference_layout():
    jdims, _, dims, _ = _mixer()
    jc = jmamba.mamba_empty_cache(jdims, 3)
    tc = mamba.mamba_empty_cache(dims, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tc["ssm"].dtype == torch.float32 and not tc["conv"].any()
    jp = jmamba.mamba_init(jax.random.PRNGKey(0), jdims)
    tp = mamba.mamba_init(torch.Generator().manual_seed(0), dims,
                          device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("A_log", "D", "dt_bias", "conv_b", "norm_scale"):
        _close(tp[k], jp[k])


def test_lm_params_from_numpy_carries_mamba_leaves():
    jlm, jp, lm, tp = _pair()
    R = lm.cfg.num_layers
    assert len(tp["layers"]) == R
    for i, layer in enumerate(tp["layers"]):
        assert set(layer) == {"norm1", "mamba"}
        assert set(layer["mamba"]) == {"w_in", "conv_w", "conv_b", "A_log",
                                       "D", "dt_bias", "norm_scale",
                                       "w_out"}
        for k, v in layer["mamba"].items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jp["pattern"][0]["mamba"][k][i]))


@pytest.mark.parametrize("S", [1, 2, 13, 24])
def test_prefill_and_decode_match_jax(S):
    jlm, jp, lm, tp = _pair()
    rng = np.random.default_rng(S)
    toks = rng.integers(0, lm.cfg.vocab, (2, S)).astype(np.int32)
    jl, jc = jax.jit(jlm.prefill)(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = lm.prefill(tp, torch.from_numpy(toks).long())
    _close(tl.numpy(), jl)
    for i in range(lm.cfg.num_layers):
        for k in ("conv", "ssm"):
            _close(tc[i]["mamba"][k], jc["pattern"][0]["mamba"][k][i])
    jstep = jax.jit(jlm.decode_step)
    pos = np.full(2, S, np.int32)
    for _ in range(8):
        t = rng.integers(0, lm.cfg.vocab, (2, 1)).astype(np.int32)
        jlg, jc = jstep(jp, jc, jnp.asarray(t), jnp.asarray(pos))
        with torch.no_grad():
            tlg, tc = lm.decode_step(tp, tc, torch.from_numpy(t).long(),
                                     torch.from_numpy(pos))
        _close(tlg.numpy(), jlg)
        pos = pos + 1


def test_cache_slots_admit_writes_mamba_leaves():
    _, _, lm, tp = _pair()
    pool = lm.init_cache(3, 32, device="cpu")
    slots = CacheSlots.create(pool, 3)
    with torch.no_grad():
        _, one = lm.prefill(tp, torch.tensor([[5, 7]]))
    slots.cache[0]["mamba"]["ssm"][1].fill_(9.0)
    slots.admit(1, 0, one, prompt_len=2)
    for i in range(lm.cfg.num_layers):
        for k in ("conv", "ssm"):
            got = slots.cache[i]["mamba"][k]
            assert torch.equal(got[1], one[i]["mamba"][k][0])
            assert not got[0].any() and not got[2].any()
    assert slots.positions.tolist() == [0, 2, 0]


def _recompute(lm, params, prompt, max_new):
    toks, out = [int(t) for t in prompt], []
    with torch.no_grad():
        for _ in range(max_new):
            x = lm.embed(params, torch.tensor([toks]))
            h, _ = lm.trunk(params, x, mode="train")
            out.append(int(torch.argmax(lm.logits(params, h)[0, -1])))
            toks.append(out[-1])
    return out


def _serve(engine_cls, req_cls, lm, params, waves, **kw):
    eng = engine_cls(lm, params, pad_prompts=False, **kw)
    tick = 0
    for at, reqs in waves:
        while tick < at:
            eng.step()
            tick += 1
        for rid, p, n in reqs:
            assert eng.submit(req_cls(request_id=rid, prompt=p,
                                      max_new_tokens=n))
    done = eng.run()
    assert all(r.status == "ok" for r in done)
    return {r.request_id: r.output for r in done}


def test_engine_matches_jax_engine_and_recompute():
    """Exact-length prefill (``pad_prompts=False``): staggered admission
    into 2 slots, slot reuse, prompts of 1 and 2 tokens."""
    jlm, jp, lm, tp = _pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n) for n in (5, 1, 9, 2, 5)]
    waves = [(0, [(i, p, 5) for i, p in enumerate(prompts[:3])]),
             (2, [(3 + i, p, 4) for i, p in enumerate(prompts[3:])])]
    got = _serve(ServeEngine, Request, lm, tp, waves, num_slots=2,
                 max_len=32)
    want = _serve(JEngine, JRequest, jlm, jp, waves, num_slots=2,
                  max_len=32)
    assert got == want and sorted(got) == [0, 1, 2, 3, 4]
    for i, p in enumerate(prompts):
        assert got[i] == _recompute(lm, tp, p, len(got[i]))


def _attention_lm():
    lm = TransformerLM(reduced(get_config("granite-3-8b")))
    return lm, lm.init(torch.Generator().manual_seed(0), device="cpu")


def test_bucket_is_exact_without_padding():
    _, _, lm, tp = _pair()
    eng = ServeEngine(lm, tp, num_slots=1, max_len=32, pad_prompts=False)
    assert [eng.bucket(n) for n in (1, 3, 8, 9)] == [1, 3, 8, 9]
    padded = ServeEngine(*_attention_lm(), num_slots=1, max_len=32)
    assert [padded.bucket(n) for n in (1, 3, 8, 9)] == [8, 8, 8, 16]


def test_pad_prompts_follows_the_model():
    """Over Mamba layers prompts are exact by default and padding them
    raises (the pads would roll into the SSM state); over attention
    they are padded by default and may be exact."""
    _, _, lm, tp = _pair()
    assert not ServeEngine(lm, tp, num_slots=1, max_len=32).pad_prompts
    with pytest.raises(ValueError, match="SSM state"):
        ServeEngine(lm, tp, num_slots=1, max_len=32, pad_prompts=True)
    glm, gp = _attention_lm()
    assert ServeEngine(glm, gp, num_slots=1, max_len=32).pad_prompts
    assert not ServeEngine(glm, gp, num_slots=1, max_len=32,
                           pad_prompts=False).pad_prompts


@pytest.mark.parametrize("arch", ["mamba2-370m", "granite-3-8b"])
def test_launch_serve_runs_on_cpu(arch, capsys):
    finished = launch_serve.main(["--arch", arch, "--requests", "4",
                                  "--slots", "2", "--max-new", "4",
                                  "--device", "cpu"])
    assert len(finished) == 4 and all(r.status == "ok" for r in finished)
    assert all(len(r.output) == 4 for r in finished)
    assert f"arch={arch}-smoke requests=4" in capsys.readouterr().out
