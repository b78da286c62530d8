"""The SSD chunk-scan kernel on the card: K12 ``ssd_chunk_diag``
(``csrc/ssd_chunk_sm90.cu``) against its plain version
(``ref.ssd_chunk_diag``, float32 math on float32 copies of the inputs) at
edge shapes -- chunks of 1, 2, 8, 37, 39, 64, 100 and 128, a sequence no
multiple of the chunk (through ``ops.ssd``'s padding), P 16, 48, 64 and
128, state sizes 16, 40 and 128, 1 to 32 heads, x/B/C as strided views
cut from one ``xBC`` tensor (also at a row stride no multiple of 16
bytes), bf16 inputs, an initial state -- two launches bitwise equal, one
CUDA launch a call (by ``torch.profiler``), the wrapper refusing a
gradient and CPU tensors, and the launch counts of
``ServeEngine(pad_prompts=False)`` over a small Mamba-2 model on the card
(one K12 a layer a prompt, none a tick) with its greedy tokens equal to
a full recompute.  Every test here is ``gpu``-marked and
skips inside its body where there is no card; none needs JAX.

Bar: 1e-5 of max |plain| (the kernel sums in another order), with bf16
inputs too: the plain version widens the same bf16 values to float32, so
both sides do float32 math on identical values, and a kernel that
rounded an intermediate to bf16 would fail."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.archs import reduced
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import mamba_ssd as mssd
from repro_torch.kernels import ops, ref
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import Request, ServeEngine

BARS = {torch.float32: 1e-5, torch.bfloat16: 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(seed, Bt, L, H, P, N, dtype, pad=0):
    """x, dt, A, B, C with x/B/C strided views of one ``xBC`` tensor (of
    ``pad`` columns more)."""
    g = torch.Generator().manual_seed(seed)
    Din = H * P
    xBC = torch.randn(Bt, L, Din + 2 * N + pad, generator=g).to("cuda",
                                                               dtype)
    x = xBC[..., :Din].reshape(Bt, L, H, P)
    B, C = xBC[..., Din:Din + N], xBC[..., Din + N:Din + 2 * N]
    dt = torch.nn.functional.softplus(
        torch.randn(Bt, L, H, generator=g) - 2.0).cuda()
    A = (-torch.exp(torch.randn(H, generator=g) * 0.5)).cuda()
    return x, dt, A, B, C


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("dt_name", ["f32", "bf16"])
@pytest.mark.parametrize("Bt,L,H,P,N,Q,pad", [
    (1, 1024, 32, 64, 128, 128, 0),   # a mamba2-370m 1,024-token prefill
    (1, 640, 32, 64, 128, 128, 0),    # a 600-token prompt, padded
    (2, 74, 1, 64, 16, 37, 0),        # ragged chunk, one head, N 16
    (1, 5, 32, 64, 128, 1, 0),        # chunks of one position
    (1, 2560, 30, 16, 16, 128, 0),    # 20 chunks of 30 heads of 16
    (1, 2, 32, 64, 128, 2, 0),        # a chunk of 2 (a 2-token prompt)
    (1, 39, 32, 64, 128, 39, 0),      # a ragged one-chunk prompt
    (3, 24, 5, 16, 128, 8, 0),        # chunks of 8, 5 heads of 16
    (1, 128, 4, 128, 128, 64, 0),     # P 128 in chunks of 64
    (1, 256, 32, 64, 128, 128, 1),    # row stride no multiple of 16 B
    (1, 100, 3, 48, 40, 100, 1),      # P 48, N 40, odd stride
])
def test_ssd_chunk_diag_matches_plain(dt_name, Bt, L, H, P, N, Q, pad):
    _need_card()
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt_name]
    x, dt, A, B, C = _inputs(L + H, Bt, L, H, P, N, dtype, pad)
    assert pad == 0 or x.stride(1) % 4 != 0
    y1, s1 = mssd.ssd_chunk_diag(x, dt, A, B, C, Q)
    y2, s2 = mssd.ssd_chunk_diag(x, dt, A, B, C, Q)
    yp, sp = ref.ssd_chunk_diag(x.float(), dt, A, B.float(), C.float(), Q)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2), "launches differ"
    assert torch.isfinite(y1).all() and torch.isfinite(s1).all()
    assert _rel(y1, yp) <= BARS[dtype] and _rel(s1, sp) <= BARS[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("L,Q", [(1, 1), (39, 39), (256, 128), (1024, 128)])
def test_one_cuda_launch_a_call(L, Q):
    """One CUDA kernel a call, by ``torch.profiler``: the K12 kernel and
    nothing else (the outputs are allocated, not filled), counted once."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    x, dt, A, B, C = _inputs(L, 1, L, 32, 64, 128, torch.float32)
    mssd.ssd_chunk_diag(x, dt, A, B, C, Q)        # built and warm
    torch.cuda.synchronize()
    lm.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):           # CUPTI can drop a session's first events
            torch.cuda._sleep(1000)
        mssd.ssd_chunk_diag(x, dt, A, B, C, Q)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA" and "spin_kernel" not in e.name]
    assert len(names) == 1 and "ssd_chunk_sm90_kernel" in names[0], names
    assert dict(lm.LAUNCHES) == {"ssd_chunk_scan": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("L,chunk,init", [(600, 128, True), (37, 128, False),
                                          (1, 128, True), (300, 64, False)])
def test_ops_ssd_pads_and_matches_the_sequential_recurrence(L, chunk, init):
    """``ops.ssd`` on the card (padding, K12, the cross-chunk code)
    against the exact sequential recurrence and the CPU composition."""
    _need_card()
    x, dt, A, B, C = _inputs(L, 1, L, 32, 64, 128, torch.float32)
    D = torch.rand(32, device="cuda")
    s0 = torch.randn(1, 32, 64, 128, device="cuda") if init else None
    lm.reset_launches()
    y, s = ops.ssd(x, dt, A, B, C, D, chunk=chunk, initial_state=s0)
    assert lm.LAUNCHES["ssd_chunk_scan"] == 1
    yr, sr = ref.ssd_reference(x, dt, A, B, C, D, initial_state=s0)
    yc, sc = ops.ssd(*(t.cpu() for t in (x, dt, A, B, C, D)), chunk=chunk,
                     initial_state=None if s0 is None else s0.cpu())
    assert _rel(y, yr) <= 1e-5 and _rel(s, sr) <= 1e-5
    assert _rel(y.cpu(), yc) <= 1e-5 and _rel(s.cpu(), sc) <= 1e-5


@pytest.mark.gpu
def test_wrapper_refuses_grad_cpu_and_bad_operands():
    _need_card()
    x, dt, A, B, C = _inputs(0, 1, 16, 2, 16, 16, torch.float32)
    with pytest.raises(NotImplementedError, match="forward only"):
        mssd.ssd_chunk_diag(x.detach().requires_grad_(), dt, A, B, C, 16)
    with pytest.raises(ValueError, match="CUDA"):
        mssd.ssd_chunk_diag(*(t.cpu() for t in (x, dt, A, B, C)), 16)
    with pytest.raises(ValueError, match="chunk"):
        mssd.ssd_chunk_diag(x, dt, A, B, C, 5)
    with pytest.raises(TypeError):
        mssd.ssd_chunk_diag(x, dt.double(), A, B, C, 16)
    with pytest.raises(ValueError, match="unit stride"):
        mssd.ssd_chunk_diag(x, dt, A, B[..., ::2], C[..., ::2], 16)


@pytest.mark.gpu
def test_serve_engine_launches_and_tokens_on_the_card():
    """A small f32 Mamba-2 model served on the card: one K12 launch a
    layer a prompt and none a tick; greedy tokens equal a full
    recompute."""
    _need_card()
    cfg = reduced(get_config("mamba2-370m"))
    model = TransformerLM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    eng = ServeEngine(model, params, num_slots=4, max_len=64,
                      pad_prompts=False)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)), max_new_tokens=6)
            for i, n in enumerate((1, 2, 9, 16, 30, 5))]
    for r in reqs:
        assert eng.submit(r)
    lm.reset_launches()
    done = eng.run()
    assert dict(lm.LAUNCHES) == {"ssd_chunk_scan":
                                 cfg.num_layers * len(reqs)}
    assert all(r.status == "ok" for r in done)
    with torch.no_grad():
        for r in done:
            toks = [int(t) for t in r.prompt]
            for want in r.output:
                x = model.embed(params, torch.tensor([toks], device="cuda"))
                h, _ = model.trunk(params, x, mode="train")
                assert int(torch.argmax(model.logits(params, h)[0, -1])) \
                    == want
                toks.append(want)
