"""K10's backward without a card: its plain version and its wiring.

  - ``ref.mha_bwd`` (the plain backward, from the forward's row
    log-sum-exp; its probabilities normalised by their own row sums and Δ
    taken from them) against ``jax.vjp`` of the JAX package's ``ref.mha``
    and of ``flash_attention.attention_chunked``: causal Sq = Sk and
    Sq < Sk, not causal with Sq > Sk, windows with and without
    ``causal`` (the window without it against ``attention_chunked`` only:
    the JAX package's ``ref.mha`` applies a window under ``causal`` alone),
    GQA groups 1, 2 and 4, an explicit ``scale``, head dims 7, 20, 32 and
    64; and against torch autograd of the port's ``ref.mha``
    on the same cases and on one with rows that see no key (Sq > Sk under
    ``causal``: the JAX package's ``ref.mha`` gives NaN there, the port's
    kernels a zero row, so only torch is the yardstick);
  - ``ref.mha_lse`` against a log-sum-exp of the scores in NumPy;
  - the autograd wiring on (faked) CUDA tensors, ``launch_kernel``
    replaced by a fake that records each launch and writes the plain
    versions' results through the pointers the wrapper passes: no
    gradient, no log-sum-exp and one K10 launch as before; with one,
    ``FlashAttention`` (the tf32 forward asked for the log-sum-exp, then
    one backward launch on exactly the saved ``q, k, v, lse``), the
    gradients those of ``ref.mha``; a bf16 gradient refused naming its ROADMAP
    item; the backward wrapper's launch arguments and refusals.

Bars (float32): 1e-5 of the largest |gradient| of a call (the sums run in
other orders; a gradient that is zero in exact arithmetic keeps its
rounding noise, so the scale is the call's, not the element's); the
log-sum-exp 1e-6 of its magnitude."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import ops, ref

BAR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


#: (B, Hq, Hkv, Sq, Sk, D, causal, window, scale)
CASES = [(2, 4, 2, 24, 24, 32, True, None, None),
         (1, 8, 2, 12, 30, 20, True, None, None),
         (2, 4, 4, 17, 9, 64, False, None, None),
         (1, 8, 2, 40, 40, 32, True, 7, None),
         (1, 4, 2, 5, 21, 64, True, 6, None),
         (1, 4, 1, 16, 16, 7, False, 5, None),
         (2, 4, 2, 19, 19, 20, True, None, 0.3)]
#: Sq > Sk under ``causal``: the first Sq - Sk rows see no key.
NO_KEY = (1, 4, 2, 12, 5, 20, True, None, None)


def _ids(c):
    return "x".join(map(str, c))


def _inputs(case, seed=0):
    B, Hq, Hkv, Sq, Sk, D, causal, window, scale = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D), (B, Hq, Sq, D))]
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    return q, k, v, do, dict(causal=causal, window=window, scale=scale)


def _close(got, want, bar=BAR):
    scale = max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= bar * scale, (err, scale)


def _plain(q, k, v, do, kw):
    return ref.mha_bwd(q, k, v, ref.mha_lse(q, k, **kw), do, **kw)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mha_bwd_matches_jax_vjp(case):
    q, k, v, do, kw = _inputs(case)
    got = _plain(q, k, v, do, kw)
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    arrs = [jnp.asarray(t.numpy()) for t in (q, k, v, do)]
    # The JAX package's ref.mha applies a window under causal only; its
    # Pallas kernel (and attention_chunked, its blocked twin) and the
    # port's kernels apply it either way.
    fns = (jfa.attention_chunked,) if kw["window"] and not kw["causal"] \
        else (jref.mha, jfa.attention_chunked)
    for fn in fns:
        _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw), *arrs[:3])
        _close(got, [torch.from_numpy(np.array(g)) for g in vjp(arrs[3])])


@pytest.mark.parametrize("case", CASES + [NO_KEY], ids=_ids)
def test_mha_bwd_matches_torch_autograd(case):
    q, k, v, do, kw = _inputs(case, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha(*leaves, **kw), leaves, do)
    got = _plain(q, k, v, do, kw)
    _close(got, want)
    if case is NO_KEY:
        dead = case[3] - case[4]
        lse = ref.mha_lse(q, k, **kw)
        assert bool(torch.isneginf(lse[:, :, :dead]).all())
        assert torch.count_nonzero(got[0][:, :, :dead]) == 0


@pytest.mark.parametrize("case", CASES + [NO_KEY], ids=_ids)
def test_mha_lse_matches_numpy(case):
    q, k, _, _, kw = _inputs(case, seed=2)
    B, Hq, Hkv, Sq, Sk, D, causal, window, scale = case
    s = np.einsum("bhqd,bhkd->bhqk", q.numpy().astype(np.float64),
                  np.repeat(k.numpy(), Hq // Hkv, axis=1).astype(np.float64))
    s *= D ** -0.5 if scale is None else scale
    valid = ref.mha_valid(Sq, Sk, causal, window).numpy()
    s = np.where(valid, s, -np.inf)
    with np.errstate(invalid="ignore", divide="ignore"):
        m = s.max(-1, keepdims=True)
        want = (np.log(np.exp(s - np.where(np.isfinite(m), m, 0)).sum(-1))
                + np.where(np.isfinite(m), m, 0)[..., 0])
    want = np.where(valid.any(-1), want, -np.inf)
    got = ref.mha_lse(q, k, **kw).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    assert np.abs(got[live] - want[live]).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The autograd wiring, the launches stubbed
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors passed off as the card's (``is_cuda`` true), and
    ``flash_attention``'s ``launch_kernel`` replaced by a fake that
    records each launch and writes the plain versions' results through
    the pointers the wrapper passes.  ``known`` maps a data pointer to
    the tensor behind it: the test's inputs and each forward's outputs."""
    launches, known = [], {}

    def write(ptr, t):
        t = t.contiguous()
        ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())

    def launch(name, dev, *args, counts=()):
        launches.append((name, args, counts))
        if name == "flash_attention_bwd":
            q, k, v, lse, do = (known[a] for a in args[:5])
            kw = dict(scale=args[28], causal=bool(args[29]),
                      window=args[30] or None)
            for ptr, g in zip(args[5:8], ref.mha_bwd(q, k, v, lse, do, **kw)):
                write(ptr, g)
            return
        q, k, v = (known[a] for a in args[1:4])
        kw = dict(scale=args[19], causal=bool(args[20]),
                  window=args[21] or None)
        out = ref.mha(q, k, v, **kw)
        write(args[0], out)
        known[args[0]] = out
        if name == "flash_attention_tf32" and args[23]:
            lse = ref.mha_lse(q, k, **kw)
            write(args[23], lse)
            known[args[23]] = lse

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(fa, "launch_kernel", launch)
    monkeypatch.setattr(fa, "require_cuda", lambda op, t: None)
    return launches, known


def _attn_inputs(requires_grad, known, dtype=torch.float32):
    q, k, v, do, kw = _inputs((1, 4, 2, 9, 9, 20, True, 4, None), seed=3)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)   # a permuted view
    ts = [t.to(dtype).requires_grad_(requires_grad) for t in (q, k, v)]
    ts.append(do)
    known.update({t.data_ptr(): t.detach() for t in ts})
    return ts[:3], do, kw


def test_no_gradient_launches_what_it_did(fake_card):
    """Without a gradient (grad off, or no input needing one): one K10
    launch, the tf32 route asked for no log-sum-exp, no autograd edge."""
    launches, known = fake_card
    (q, k, v), _, kw = _attn_inputs(False, known)
    out = ops.attention(q, k, v, **kw)
    assert out.grad_fn is None
    (q, k, v), _, kw = _attn_inputs(True, known)
    with torch.no_grad():
        out = ops.attention(q, k, v, **kw)
    assert out.grad_fn is None
    assert [n for n, _, _ in launches] == ["flash_attention_tf32"] * 2
    assert [a[23] for _, a, _ in launches] == [0, 0]
    assert all(c == ("flash_attention", "flash_attention.tf32")
               for _, _, c in launches)


def test_gradient_runs_the_function(fake_card):
    """With a gradient: the forward asks the tf32 kernel for the
    log-sum-exp and saves ``q, k, v, lse``; the backward launches once on
    exactly those, ``do`` and the flags; the gradients are those of
    ``ref.mha``."""
    launches, known = fake_card
    (q, k, v), do, kw = _attn_inputs(True, known)
    kw["scale"] = 0.3
    out = ops.attention(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (name, args, counts), = launches
    assert name == "flash_attention_tf32" and args[23] != 0
    saved = out.grad_fn.saved_tensors
    assert [t.data_ptr() for t in saved] == [
        t.data_ptr() for t in (q, k, v)] + [args[23]]
    grads = torch.autograd.grad(out, (q, k, v), do)
    name, args, counts = launches[-1]
    assert name == "flash_attention_bwd" and counts == ()
    assert len(launches) == 2
    assert args[:5] == tuple(t.data_ptr() for t in saved) + (do.data_ptr(),)
    assert args[10:16] == (1, 4, 2, 9, 9, 20)
    assert list(args[16:28]) == [t.stride(i) for t in (q, k, v, do)
                                 for i in range(3)]
    assert args[28:] == (0.3, 1, 4)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha(*leaves, **kw), leaves, do)
    _close(grads, want, 1e-6)


def test_bf16_gradient_is_refused(fake_card):
    launches, known = fake_card
    (q, k, v), _, kw = _attn_inputs(True, known, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 2, \"K10 backward at bf16\""):
        ops.attention(q, k, v, **kw)
    assert not launches


def test_bwd_wrapper_arguments_and_refusals(monkeypatch):
    got = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(fa, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(fa, "launch_kernel",
                        lambda name, dev, *args, **kw: got.append(
                            (name, args, kw)))
    lm.reset_launches()
    q, k, v, do, _ = _inputs((2, 8, 2, 11, 13, 20, True, None, None))
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    do = do.transpose(1, 2).contiguous().transpose(1, 2)
    lse = torch.zeros(2, 8, 11)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, lse, do, causal=False,
                                        window=5, scale=0.25)
    name, args, kw = got[-1]
    assert name == "flash_attention_bwd" and kw == {}
    assert args[:5] == tuple(t.data_ptr() for t in (q, k, v, lse, do))
    assert args[5:8] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[9] - args[8] == 2 * 8 * 11 * 4      # the two row scratches
    assert args[10:16] == (2, 8, 2, 11, 13, 20)
    assert list(args[16:28]) == [t.stride(i) for t in (q, k, v, do)
                                 for i in range(3)]
    assert args[28:] == (0.25, 0, 5)
    assert dq.shape == q.shape and dq.is_contiguous()
    assert dk.shape == k.shape and dv.shape == v.shape
    fa.flash_attention_bwd(q, k, v, lse, do)
    assert got[-1][1][28:] == (20 ** -0.5, 1, 0)
    k3 = torch.zeros(2, 3, 13, 20)
    with pytest.raises(ValueError, match="fold"):
        fa.flash_attention_bwd(q, k3, k3, lse, do)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, k, v, lse.transpose(1, 2).contiguous()
                               .transpose(1, 2), do)
    with pytest.raises(ValueError, match="lse must have shape"):
        fa.flash_attention_bwd(q, k, v, lse[:, :, :4], do)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, k, v, lse, do.double())
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(*(t.bfloat16() for t in (q, k, v)), lse,
                               do.bfloat16())
    assert len(got) == 2


def test_bwd_wrapper_refuses_cpu_tensors():
    q, k, v, do, _ = _inputs((1, 4, 2, 5, 5, 8, True, None, None))
    lm.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, torch.zeros(1, 4, 5), do)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_lse(q, k, v)
    assert not lm.LAUNCHES
