"""LM serving in the port against the JAX package on the CPU:
``TransformerLM`` (prefill and decode), ``CacheSlots``, ``ServeEngine``
and ``validate_prompt``, with JAX's params carried across by
``interop.lm_params_from_numpy``.

- Prefill and ten decode steps (two sequences at ragged positions) over
  ``reduced(granite-3-8b)``, ``reduced(stablelm-3b)`` (MHA; the two
  reduced configs differ only in name) and ``reduced(granite-3-8b)`` with
  one KV head (GQA, group 4), f32, against JAX with
  ``attn_impl="chunked"``; one tiny case against JAX's Pallas kernels in
  interpret mode.
- ``ServeEngine`` greedy tokens equal to JAX's ``ServeEngine`` on the
  prompts of ``tests/test_serve.py`` (slot reuse, staggered admission,
  EOS), and to a full recompute; an exact-bucket prompt; sampling.
- ``CacheSlots.admit`` writes the slot the reference writes.
- ``validate_prompt`` rejects what the reference rejects, with its
  messages; configs this slice does not run raise ``NotImplementedError``.
- ``examples/torch_serve_lm.py --device cpu`` runs.

Tolerance: logits within 1e-4 of max |logit| (the reference's fused-vs-
unfused bar, ``repro/core/scheduler.py:305``); greedy tokens exactly."""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.configs.archs import reduced as jreduced
from repro.models.transformer import TransformerLM as JLM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve.kv_cache import CacheSlots as JCacheSlots
from repro.serve.robustness import validate_prompt as jvalidate
from repro_torch.configs import get_config
from repro_torch.configs.archs import reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import (CacheSlots, Request, ServeEngine,
                               validate_prompt)

TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _pair(name: str, **over):
    """(JAX lm, JAX params, port lm, port params) of ``reduced(name)``
    with ``over`` replaced, from one JAX init."""
    jcfg = dataclasses.replace(jreduced(jget(name)), **over)
    cfg = dataclasses.replace(reduced(get_config(name)), **over)
    jlm = JLM(jcfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    lm = TransformerLM(cfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                              device="cpu")
    return jlm, jp, lm, tp


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _decode_parity(jlm, jp, lm, tp, S, steps, impl, L=32):
    rng = np.random.default_rng(S)
    vocab = lm.cfg.vocab
    toks = rng.integers(0, vocab, (2, S)).astype(np.int32)
    jl, jc = jax.jit(functools.partial(jlm.prefill, attn_impl=impl))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = lm.prefill(tp, torch.from_numpy(toks).long())
    _close(tl.numpy(), jl)
    R = lm.cfg.num_layers
    for i in range(R):
        for kv in ("k", "v"):
            _close(tc[i]["attn"][kv].numpy(),
                   jc["pattern"][0]["attn"][kv][i])
    # Pools of L rows holding the prefill; the second sequence decodes
    # from position S - 3 (its last three rows are overwritten).
    jpool = jax.tree.map(lambda pool, one: pool.at[..., :S, :].set(one),
                         jlm.init_cache(2, L), jc)
    tpool = lm.init_cache(2, L, device="cpu")
    for i in range(R):
        for kv in ("k", "v"):
            tpool[i]["attn"][kv][:, :, :S] = tc[i]["attn"][kv]
    jstep = jax.jit(functools.partial(jlm.decode_step, attn_impl=impl))
    pos = np.asarray([S, S - 3], np.int32)
    for _ in range(steps):
        t = rng.integers(0, vocab, (2, 1)).astype(np.int32)
        jlg, jpool = jstep(jp, jpool, jnp.asarray(t), jnp.asarray(pos))
        with torch.no_grad():
            tlg, tpool = lm.decode_step(tp, tpool, torch.from_numpy(t).long(),
                                        torch.from_numpy(pos))
        _close(tlg.numpy(), jlg)
        pos = pos + 1


@pytest.mark.parametrize("name,over", [
    ("granite-3-8b", {}), ("stablelm-3b", {}),
    ("granite-3-8b", {"n_kv_heads": 1})],
    ids=["granite", "stablelm", "granite-gqa4"])
def test_prefill_and_decode_match_jax(name, over):
    _decode_parity(*_pair(name, **over), S=13, steps=10, impl="chunked")


def test_prefill_and_decode_match_jax_pallas_interpret():
    """JAX on its Pallas kernels (interpret mode) at a tiny size."""
    _decode_parity(*_pair("granite-3-8b", num_layers=1, n_kv_heads=2),
                   S=9, steps=2, impl="pallas", L=16)


def test_vocab_pad_is_masked():
    """The logits keep JAX's -1e30 over the padded vocab."""
    jlm, jp, lm, tp = _pair("granite-3-8b", vocab=300, num_layers=1)
    toks = np.arange(6, dtype=np.int32)[None]
    with torch.no_grad():
        tl, _ = lm.prefill(tp, torch.from_numpy(toks).long())
    jl, _ = jax.jit(functools.partial(jlm.prefill, attn_impl="chunked"))(
        jp, jnp.asarray(toks))
    assert tl.shape == (1, 512) and (tl[:, 300:] == -1e30).all()
    _close(tl[:, :300].numpy(), np.asarray(jl)[:, :300])


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

def _recompute(lm, params, prompt, max_new):
    """Naive full-recompute greedy decoding (``tests/test_serve.py``)."""
    toks = [int(t) for t in prompt]
    out = []
    with torch.no_grad():
        for _ in range(max_new):
            x = lm.embed(params, torch.tensor([toks]))
            h, _ = lm.trunk(params, x, mode="train",
                            positions=torch.arange(len(toks)))
            nxt = int(torch.argmax(lm.logits(params, h)[0, -1]))
            out.append(nxt)
            toks.append(nxt)
    return out


def _serve(engine_cls, req_cls, lm, params, waves, **kw):
    """Submit ``waves`` (``[(tick, [(rid, prompt, max_new, eos)])]``) at
    their ticks and drain; returns ``{rid: output}`` and the engine."""
    eng = engine_cls(lm, params, **kw)
    tick = 0
    for at, reqs in waves:
        while tick < at:
            eng.step()
            tick += 1
        for rid, p, n, eos in reqs:
            assert eng.submit(req_cls(request_id=rid, prompt=p,
                                      max_new_tokens=n, eos_id=eos))
    done = eng.run()
    assert all(r.status == "ok" for r in done)
    return {r.request_id: r.output for r in done}, eng


def _both(waves, **kw):
    jlm, jp, lm, tp = _pair("stablelm-3b")
    got, eng = _serve(ServeEngine, Request, lm, tp, waves, **kw)
    want, _ = _serve(JEngine, JRequest, jlm, jp, waves, **kw)
    assert got == want
    return got, eng, lm, tp


def test_engine_matches_jax_engine_and_recompute():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n) for n in (3, 5, 4)]
    got, _, lm, tp = _both([(0, [(i, p, 6, None)
                                 for i, p in enumerate(prompts)])],
                           num_slots=2, max_len=32)
    assert sorted(got) == [0, 1, 2]
    for i, p in enumerate(prompts):
        assert got[i] == _recompute(lm, tp, p, 6)


def test_slot_reuse_staggered_admission_and_eos():
    rng = np.random.default_rng(1)
    reuse = [(i, rng.integers(0, 512, size=3), 3, None) for i in range(5)]
    got, eng, _, _ = _both([(0, reuse)], num_slots=2, max_len=32)
    assert eng.slots.num_active == 0 and len(got) == 5
    assert all(len(o) == 3 for o in got.values())
    # A co-tenant admitted at tick 0 or tick 2 does not change request 0.
    rng = np.random.default_rng(2)
    p0 = rng.integers(0, 512, size=4)
    outs = []
    for co, at in ((rng.integers(0, 512, size=4), 0),
                   (rng.integers(0, 512, size=5), 2)):
        got, _, _, _ = _both([(0, [(0, p0, 8, None)]), (at, [(1, co, 4,
                                                              None)])],
                             num_slots=4, max_len=32)
        outs.append(got[0])
    assert outs[0] == outs[1]
    # EOS stops a request at its first occurrence.
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 512, size=4)
    full, _, _, _ = _both([(0, [(0, prompt, 8, None)])], num_slots=1,
                          max_len=32)
    eos = full[0][2]
    got, _, _, _ = _both([(0, [(0, prompt, 8, eos)])], num_slots=1,
                         max_len=32)
    assert got[0] == full[0][:full[0].index(eos) + 1]


def test_exact_bucket_prompt_and_sampling():
    """A prompt of exactly a bucket's length takes its first token from
    the prefill; sampled decoding is reproducible from its seed."""
    jlm, jp, lm, tp = _pair("stablelm-3b")
    p = np.random.default_rng(4).integers(0, 512, size=8)
    got, eng = _serve(ServeEngine, Request, lm, tp, [(0, [(0, p, 4, None)])],
                      num_slots=2, max_len=32)
    assert eng.bucket(8) == 8 and got[0] == _recompute(lm, tp, p, 4)
    runs = [_serve(ServeEngine, Request, lm, tp,
                   [(0, [(0, p, 5, None), (1, p[:3], 5, None)])],
                   num_slots=2, max_len=32, greedy=False, seed=s)[0]
            for s in (7, 7, 8)]
    assert runs[0] == runs[1]
    assert all(0 <= t < 512 for r in runs for o in r.values() for t in o)


def test_cache_slots_admit_writes_what_the_reference_writes():
    jlm, jp, lm, tp = _pair("stablelm-3b")
    rng = np.random.default_rng(5)
    jpool = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                               jnp.float32),
                         jlm.init_cache(3, 16))
    jslots = JCacheSlots.create(jpool, 3)
    tslots = CacheSlots.create(
        [{"attn": {kv: torch.from_numpy(np.asarray(
            jpool["pattern"][0]["attn"][kv][i]).copy())
            for kv in ("k", "v")}} for i in range(4)], 3)
    _, jc = jlm.prefill(jp, jnp.asarray(rng.integers(0, 512, (1, 5))))
    tc = [{"attn": {kv: torch.from_numpy(np.asarray(
        jc["pattern"][0]["attn"][kv][i]).copy()) for kv in ("k", "v")}}
        for i in range(4)]
    jslots.admit(1, 7, jc, prompt_len=5)
    tslots.admit(1, 7, tc, prompt_len=5)
    for i in range(4):
        for kv in ("k", "v"):
            np.testing.assert_array_equal(
                tslots.cache[i]["attn"][kv].numpy(),
                np.asarray(jslots.cache["pattern"][0]["attn"][kv][i]))
    assert list(tslots.positions) == list(jslots.positions)
    assert tslots.free_slots() == jslots.free_slots() == [0, 2]
    with pytest.raises(ValueError, match="does not fit"):
        tslots.admit(0, 8, [{"attn": {kv: torch.zeros(1, 4, 17, 32)
                                      for kv in ("k", "v")}}] * 4, 17)


def test_validate_prompt_rejects_as_the_reference():
    bad = [(np.zeros((2, 3), np.int32), 32, 4), (np.zeros(0, np.int32), 32, 4),
           (np.asarray([1.5, 2.0]), 32, 4), (np.asarray([3, -1]), 32, 4),
           (np.arange(32), 32, 4), (np.asarray([1, 2]), 32, 0)]
    for p, max_len, n in bad:
        msg = validate_prompt(p, max_len, n)
        assert msg is not None and msg == jvalidate(p, max_len, n)
    assert validate_prompt(np.asarray([1, 2]), 32, 1) is None
    _, _, lm, tp = _pair("stablelm-3b")
    eng = ServeEngine(lm, tp, num_slots=1, max_len=16)
    for rid, p in enumerate((np.asarray([4, -2]), np.arange(16),
                             np.asarray([3, 512]))):
        assert not eng.submit(Request(request_id=rid, prompt=p))
    assert [r.status for r in eng.finished] == ["rejected"] * 3
    assert "vocab" in eng.finished[2].error


def test_deadline_times_out_in_flight():
    now = [0.0]
    _, _, lm, tp = _pair("stablelm-3b")
    eng = ServeEngine(lm, tp, num_slots=1, max_len=32, clock=lambda: now[0])
    eng.submit(Request(request_id=0, prompt=np.asarray([1, 2, 3]),
                       max_new_tokens=10, ttl=1.0))
    eng.step()
    eng.step()
    now[0] = 2.0
    eng.run()
    (req,) = eng.finished
    assert req.status == "timeout" and 1 <= len(req.output) < 10


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_unported_blocks_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        TransformerLM(reduced(get_config(name)))


def test_torch_serve_lm_example_runs_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", ROOT / "examples" / "torch_serve_lm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    finished = ex.main(["--device", "cpu"])
    assert len(finished) == 9 and all(r.status == "ok" for r in finished)
    assert "served 9 requests" in capsys.readouterr().out
