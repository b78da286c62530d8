"""K10's wgmma route (``csrc/flash_attention_sm90.cu``) where no card is
present: the route rule, the strides TMA refuses, and the kernel's
arithmetic emulated in plain PyTorch against the plain version and the
JAX reference.

- ``route`` for every (dtype, head dim) that the configs, their reduced
  forms and ``chip_smoke.K10_EDGES`` use: bf16 with ``D % 16 == 0`` and
  ``D <= 256`` takes "wgmma", every other f32 or bf16 head dim in
  ``1..256`` "tf32" (``tests/test_torch_flash_tf32.py``); another type
  or head dim has no kernel and raises.
- ``tma_strides`` and the wrapper refusing, on CPU and meta tensors and
  before any launch, a batch, head or row stride that is not a positive
  multiple of 16 bytes or a base off a 16-byte boundary, and accepting
  the projections' permuted views.
- ``emulate`` repeats the kernel's arithmetic: bf16 operands, fp32 QKᵀ,
  the key-tile-by-key-tile online softmax in the exp2 domain, each fp32
  probability split into ``P_hi = bf16(P)`` and ``P_lo = bf16(P -
  P_hi)``, fp32 PV on both, normalised by the fp32 row sum.  Held within
  1e-4 of max |plain| (the port's fused-against-unfused bar) of
  ``ref.mha`` and of JAX's ``attention_chunked``, both fed the same
  inputs rounded to bf16 and widened to f32.  Measured at the granite
  head dim, 2 query heads on 1 KV head, Sq = Sk = 300, causal: 1.29e-6
  of max |plain| against ``ref.mha`` and 1.28e-6 against JAX (the split
  keeps about 2^-17 of each probability); on every case here at most
  1.70e-6.  Rounding P to bf16 alone, as FlashAttention-2/3 do, gives
  6.2e-4 to 9.9e-4 and misses the bar, which
  ``test_unsplit_p_misses_the_bar`` shows.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention as jfa
from repro_torch.configs import get_config
from repro_torch.configs.archs import reduced
from repro_torch.configs.base import list_configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
BK = 64                  # keys a tile, as in the kernel
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _k10_edges():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K10_EDGES


# ---------------------------------------------------------------------------
# The route rule
# ---------------------------------------------------------------------------

def _attention_head_dims():
    dims = set()
    for name in list_configs():
        for cfg in (get_config(name), reduced(get_config(name))):
            if cfg.n_heads:
                dims.add(cfg.dh)
    return sorted(dims)


def test_route_for_every_config_head_dim():
    dims = _attention_head_dims()
    assert {32, 64, 80, 128} <= set(dims), dims
    for D in dims:
        assert fa.route(torch.bfloat16, D) == "wgmma", D
        assert fa.route(torch.float32, D) == "tf32", D


def test_route_for_every_k10_edge():
    edges = _k10_edges()
    assert {e[5] for e in edges} >= {32, 64, 80, 128, 256}
    for *_, D, _causal, _window in edges:
        assert fa.route(torch.bfloat16, D) == \
            ("wgmma" if D % 16 == 0 else "tf32"), D
        assert fa.route(torch.float32, D) == "tf32", D


@pytest.mark.parametrize("D,want", [(16, "wgmma"), (48, "wgmma"),
                                    (256, "wgmma"), (8, "tf32"),
                                    (72, "tf32"), (100, "tf32"),
                                    (257, None)])
def test_route_rule_on_other_head_dims(D, want):
    if want is None:                     # past the widest head: no kernel
        for dt in (torch.bfloat16, torch.float32, torch.float16):
            with pytest.raises(ValueError, match="no kernel"):
                fa.route(dt, D)
        return
    assert fa.route(torch.bfloat16, D) == want
    assert fa.route(torch.float32, D) == "tf32"
    with pytest.raises(ValueError, match="no kernel"):
        fa.route(torch.float16, D)


# ---------------------------------------------------------------------------
# Strides TMA takes and refuses
# ---------------------------------------------------------------------------

def _perm(B, S, H, D, device="cpu"):
    """``[B, H, S, D]`` as the projections give it: a permuted view of a
    ``[B, S, H, D]`` tensor."""
    return torch.zeros((B, S, H, D), dtype=torch.bfloat16,
                       device=device).permute(0, 2, 1, 3)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_tma_strides_of_permuted_views(device):
    q = _perm(2, 5, 4, 64, device)
    assert fa.tma_strides("op", "q", q) == (5 * 4 * 64, 64, 4 * 64)
    v = torch.zeros((2, 5, 4 * 128), dtype=torch.bfloat16,
                    device=device).view(2, 5, 4, 128).permute(0, 2, 1, 3)
    assert fa.tma_strides("op", "v", v) == (5 * 4 * 128, 128, 4 * 128)


def test_tma_strides_of_size_one_dims_are_contiguous():
    # A one-row, one-head, one-batch view whose own strides TMA would
    # refuse: no copy steps along those dims, so they get their
    # contiguous strides.
    t = torch.zeros(1, 1, 1, 100, dtype=torch.bfloat16)[..., :64]
    assert t.stride()[:3] == (100, 100, 100)
    assert fa.tma_strides("op", "q", t) == (64, 64, 64)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("bad", ["row", "head", "zero"])
def test_wrapper_refuses_strides_tma_cannot_take(device, bad):
    """Rows 66 elements apart (132 bytes), heads 132 bytes apart, or K
    broadcast over heads by a zero stride: the wrapper raises before any
    launch, on any device."""
    q = _perm(1, 8, 4, 64, device)
    if bad == "row":
        k = torch.zeros((1, 4, 8, 66), dtype=torch.bfloat16,
                        device=device)[..., :64]
    elif bad == "head":
        k = torch.zeros((1, 8, 4, 66), dtype=torch.bfloat16,
                        device=device)[..., :64].permute(0, 2, 1, 3)
    else:
        k = torch.zeros((1, 1, 8, 64), dtype=torch.bfloat16,
                        device=device).expand(1, 4, 8, 64)
    with pytest.raises(ValueError, match="TMA reads k"):
        fa.tma_strides("flash_attention", "k", k)
    with pytest.raises(ValueError, match="TMA reads k"):
        fa.flash_attention(q, k, q)
    # The tf32 route reads any stride: f32 operands reach the device check.
    with pytest.raises(ValueError, match="CUDA tensors|cuda"):
        fa.flash_attention(q.float(), k.float(), q.float())


def test_wrapper_refuses_a_base_off_16_bytes():
    flat = torch.zeros(8 + 2 * 8 * 64, dtype=torch.bfloat16)
    k = flat[4:-4].view(1, 2, 8, 64)      # 8 bytes past a 16-byte boundary
    q = _perm(1, 8, 2, 64)
    with pytest.raises(ValueError, match="TMA reads v"):
        fa.flash_attention(q, q, k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, flat[8:].view(1, 2, 8, 64))


# ---------------------------------------------------------------------------
# The kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def _bf16(x: np.ndarray) -> torch.Tensor:
    """``x`` rounded to bf16 and widened back to f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float()


def emulate(q, k, v, *, causal=True, window=None, scale=None,
            split=True) -> torch.Tensor:
    """What ``flash_attention_sm90.cu`` computes, before its one bf16
    rounding of the output, on f32 tensors holding bf16 values: scores in
    fp32 scaled into the exp2 domain, masked to -inf, the online softmax
    over key tiles of 64 (a row with no key yet keeps max -inf, alpha and
    P 0), PV on ``P_hi`` and ``P_lo`` (``split``) or on ``bf16(P)``
    alone, the row sum of the unrounded P, and ``o * (1 / l)`` (0 where
    ``l`` is 0)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    c = (D ** -0.5 if scale is None else scale) * LOG2E
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, Hq, Sq), float("-inf"))
    l = torch.zeros((B, Hq, Sq))
    o = torch.zeros((B, Hq, Sq, D))
    for k0 in range(0, Sk, BK):
        kpos = torch.arange(k0, min(k0 + BK, Sk))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kk[:, :, k0:k0 + BK]) * c
        valid = torch.ones((Sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            valid &= kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        s = s.masked_fill(~valid, float("-inf"))
        mnew = torch.maximum(m, s.amax(-1))
        mref = torch.where(mnew == float("-inf"), 0.0, mnew)
        alpha = torch.exp2(m - mref)
        p = torch.exp2(s - mref[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        parts = (hi, (p - hi).to(torch.bfloat16).float()) if split else (hi,)
        o = o * alpha[..., None]
        for part in parts:
            o = o + part @ vv[:, :, k0:k0 + BK]
        m = mnew
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    return o * inv[..., None]


#: (Hq, Hkv, Sq, Sk, D, causal, window): the granite head dim with 2 query
#: heads on 1 KV head at Sq = Sk = 300, then Sq != Sk without ``causal``,
#: a window starting inside a key tile, Sq > Sk (zero rows) and D 80.
CASES = [(2, 1, 300, 300, 128, True, None),
         (4, 2, 65, 200, 64, False, None),
         (2, 1, 300, 300, 128, True, 100),
         (4, 4, 129, 50, 128, True, None),
         (8, 2, 127, 127, 80, True, None)]


def _inputs(Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(Hq * 1000 + Sq + D)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, Hq, Sq, D), (1, Hkv, Sk, D), (1, Hkv, Sk, D)))
    return q, k, v


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulation_matches_plain(case):
    Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = map(_bf16, _inputs(Hq, Hkv, Sq, Sk, D))
    got = emulate(q, k, v, causal=causal, window=window)
    want = ref.mha(q, k, v, causal=causal, window=window)
    assert _rel(got, want) <= TOL
    if Sq > Sk and causal:
        assert not got[:, :, :Sq - Sk].any(), "rows with no key must be 0"


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulation_matches_jax_attention_chunked(case):
    Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = (_bf16(x) for x in _inputs(Hq, Hkv, Sq, Sk, D))
    got = emulate(q, k, v, causal=causal, window=window)
    want = np.asarray(jfa.attention_chunked(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
        window=window, block_q=128, block_k=BK))
    # A query with no valid key is a zero row here and the mean of V in
    # JAX (its -1e30 stand-in for -inf): such rows are left out.
    rows = np.arange(Sq) >= Sq - Sk if causal else np.ones(Sq, bool)
    assert _rel(got.numpy()[:, :, rows], want[:, :, rows]) <= TOL


def test_unsplit_p_misses_the_bar():
    """P rounded to bf16 alone keeps 8 bits: the 1e-4 bar catches it, so
    the split is what the emulation tests pass on."""
    q, k, v = map(_bf16, _inputs(2, 1, 300, 300, 128))
    want = ref.mha(q, k, v)
    assert _rel(emulate(q, k, v), want) <= TOL
    assert _rel(emulate(q, k, v, split=False), want) > TOL
