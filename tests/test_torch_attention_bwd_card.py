"""K10's backward on the card (``csrc/flash_attention_bwd.cu``) against its
plain version: dQ, dK and dV of ``flash_attention_bwd`` on the forward's
own log-sum-exp (``flash_attention_lse``) against
``ref.mha_bwd`` on the same inputs and against torch autograd of
``ref.mha``; the forward's log-sum-exp against ``ref.mha_lse``, its output
bit for bit what it writes without the log-sum-exp; two launches bitwise
equal; ``FlashAttention`` through ``ops.attention`` counting one forward
and one backward launch, its gradients those of autograd of ``ref.mha``.
Cases: causal and not, a window with and without ``causal``, Sq != Sk
both ways (Sq > Sk under ``causal``: rows that see no key, zero dQ), Hkv =
Hq and GQA groups 2, 4 and 8, head dims 7, 20, 32, 64, 100, 128 and 256,
lengths no multiple of a tile, q and dO as permuted views, and granite's
training shape (Hq 32, Hkv 8, 1,024 causal tokens, D 128).

Every test here is ``gpu``-marked and skips inside its body where there is
no card; none needs JAX.  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_attention_bwd_card.py``.

Bar: 1e-5 of the largest |gradient| of a call (float32; the kernel sums
in another order, its products split into three TF32 products); the
log-sum-exp 1e-6 of its largest magnitude."""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import ops, ref

BAR = 1e-5

#: (B, Hq, Hkv, Sq, Sk, D, causal, window)
CASES = [(1, 4, 2, 64, 64, 64, True, None),
         (2, 8, 2, 100, 100, 128, True, None),
         (1, 4, 4, 70, 70, 32, False, None),
         (1, 8, 2, 96, 96, 64, True, 24),
         (1, 4, 1, 16, 16, 7, False, 5),
         (1, 4, 1, 65, 200, 128, False, None),
         (1, 4, 2, 129, 50, 64, True, None),
         (1, 8, 2, 100, 100, 20, True, None),
         (1, 4, 2, 129, 129, 100, True, 50),
         (1, 4, 4, 65, 65, 256, True, None),
         (1, 16, 2, 33, 65, 80, True, None),
         (2, 32, 8, 1024, 1024, 128, True, None)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(case, seed=0):
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    gen = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen).cuda()

    q = rn(B, Sq, Hq, D).transpose(1, 2)           # permuted views
    do = rn(B, Sq, Hq, D).transpose(1, 2)
    return q, rn(B, Hkv, Sk, D), rn(B, Hkv, Sk, D), do, dict(
        causal=causal, window=window)


def _rel(got, want):
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) \
        / max(scale, 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_backward_matches_plain_and_is_deterministic(case):
    _need_card()
    q, k, v, do, kw = _inputs(case)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    want_lse = ref.mha_lse(q, k, **kw)
    live = torch.isfinite(want_lse)
    assert torch.equal(live, torch.isfinite(lse))
    if live.any():
        assert float((lse - want_lse)[live].abs().max()) <= 1e-6 * float(
            want_lse[live].abs().max())
    lm.reset_launches()
    got = fa.flash_attention_bwd(q, k, v, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, lse, do, **kw)
    torch.cuda.synchronize()
    assert dict(lm.LAUNCHES) == {"flash_attention_bwd": 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel(got, ref.mha_bwd(q, k, v, lse, do, **kw)) <= BAR
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(ref.mha(*leaves, **kw), leaves, do)
    assert _rel(got, auto) <= BAR
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    if causal and Sq > Sk:
        assert torch.count_nonzero(got[0][:, :, :Sq - Sk]) == 0


@pytest.mark.gpu
def test_ops_attention_differentiates_through_the_kernels():
    _need_card()
    q, k, v, do, kw = _inputs((2, 8, 2, 77, 77, 32, True, None), seed=1)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lm.reset_launches()
    out = ops.attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert dict(lm.LAUNCHES) == {"flash_attention": 1,
                                 "flash_attention.tf32": 1,
                                 "flash_attention_bwd": 1}
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha(*plain, **kw), plain, do)
    assert _rel(grads, want) <= BAR


@pytest.mark.gpu
def test_bf16_gradient_is_refused_on_the_card():
    _need_card()
    q, k, v, _, kw = _inputs((1, 4, 2, 16, 16, 64, True, None), seed=2)
    q = q.bfloat16().requires_grad_()
    with pytest.raises(NotImplementedError, match="K10 backward at bf16"):
        fa.flash_attention(q, k.bfloat16(), v.bfloat16(), **kw)
