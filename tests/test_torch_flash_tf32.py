"""K10's tensor-core route for f32 operands and for the bf16 head dims
the wgmma route does not take (``csrc/flash_attention_tf32.cu``) where no
card is present: the route rule, and the kernel's arithmetic emulated in
plain PyTorch against the plain version and the JAX reference.

- ``route`` for every head dim that the configs and their reduced forms
  use and every ``chip_smoke.K10_EDGES`` case at f32: every head dim in
  ``1..256`` takes "tf32" (a head dim no multiple of 8 zero-padded to the
  next in the kernel), a wider one has no kernel and raises.
- ``emulate_tf32x3`` repeats the kernel's arithmetic on f32 tensors:
  ``cvt.rna.tf32.f32`` on int32 bit views (add half of the 13 dropped
  bits' weight to the magnitude, clear them); each operand split into
  ``big = tf32(x)`` and ``small = tf32(x - big)``; every k-step of 8
  as three products, small·big, big·small and big·big, each exact in
  fp32 and accumulated in fp32, QKᵀ's big·big products and cross terms
  in two sums added once a key tile; key tiles of the kernel's size
  (:func:`tile_keys`); the online softmax in the exp2 domain (masked
  scores -inf, a row with no key yet keeps max -inf, alpha and P 0); P
  split like the operands; each tile's PV in a fresh fp32 sum, added to
  O as ``O * alpha + tile``; normalised by the fp32 row sum.
- That emulation held within 1e-5 of max |plain| (the card's f32 bar,
  ``chip_smoke.ATTN_BARS``) of ``ref.mha`` and of JAX's
  ``attention_chunked`` on the same numpy f32 inputs, at the cases of
  ``tests/test_torch_flash_sm90.py`` and D 40.  Measured: 1.9e-7 to
  6.1e-7 of max |plain| against ``ref.mha`` and 2.3e-7 to 4.8e-7 against
  JAX on these cases (the split keeps about 21 bits of each operand, so
  the error is the fp32 sums' own).  One TF32 product a k-step without
  the split, as a plain TF32 kernel would do, gives 2.5e-4 to 4.9e-4 and
  misses the bar, which ``test_unsplit_tf32_misses_the_bar`` shows.
  The emulation's sums round as IEEE fp32 does; the tensor core's cut
  instead, which is why the kernel adds each tile's PV to O outside the
  mma (its header): ``chip_smoke.py`` holds the card's own sums to the
  same bar.
- Ragged head dims (20, 36, 100: ``RAGGED``): the kernel zero-fills the
  columns from D to the end of the last 8-column block, which adds exact
  zeros to every product, so the emulation's last k-step is the partial
  block; held to the same 1e-5 against ``ref.mha`` and JAX.
- bf16 operands (``BF16_CASES``: D 20, 40, 100): a bf16 value is exact in
  TF32, so QKᵀ is one product a k-step and PV two (``P_small·V`` then
  ``P_big·V``), O narrowed to bf16 with round-to-nearest-even.  The f32
  sum before the narrowing is held to 1e-5 of ``ref.mha`` and of JAX's
  ``attention_chunked`` on the bf16 inputs widened to f32, the narrowed
  output to the card's bf16 bar (1e-2 of max |plain|) and to the f32 sum
  rounded to bf16, bit for bit.
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
TOL = 1e-5
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


def test_every_config_head_dim_takes_the_tf32_route_at_f32():
    dims = _attention_head_dims()
    assert {32, 64, 80, 128} <= set(dims), dims
    for D in dims:
        assert fa.route(torch.float32, D) == "tf32", D
    assert fa.LIBRARIES["tf32"] == "flash_attention_tf32"


def test_route_for_every_k10_edge_at_f32():
    edges = _k10_edges()
    dims = {e[5] for e in edges}
    assert {20, 40, 100} <= dims, "K10_EDGES keep ragged head dims"
    assert any(D % 4 for D in dims), "and one the 16-byte copies miss"
    for *_, D, _causal, _window in edges:
        assert fa.route(torch.float32, D) == "tf32", D


@pytest.mark.parametrize("D,want", [(8, "tf32"), (40, "tf32"),
                                    (72, "tf32"), (248, "tf32"),
                                    (256, "tf32"), (20, "tf32"),
                                    (100, "tf32"), (257, None),
                                    (264, None)])
def test_tf32_route_rule_on_other_head_dims(D, want):
    if want is None:
        with pytest.raises(ValueError, match="no kernel"):
            fa.route(torch.float32, D)
    else:
        assert fa.route(torch.float32, D) == want


# ---------------------------------------------------------------------------
# The kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def tile_keys(D: int) -> int:
    """Keys a tile of ``flash_attention_tf32.cu`` (``Cfg<DMAX>::BK``): 64
    for head dims up to 64, 32 above."""
    return 64 if D <= 64 else 32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of finite f32 values: the magnitude rounded to
    10 stored mantissa bits, ties away from zero, as f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def products(a: torch.Tensor, b: torch.Tensor, eq: str, axis_a: int,
             axis_b: int, split3: bool = True):
    """The k8 steps of ``mma.sync.m16n8k8`` TF32 along the contracted
    axes, in order, as (big·big sum, cross-term sum) accumulated in fp32;
    each k-step's products are exact in fp32.  ``split3`` False: one TF32
    product a step, no cross terms."""
    n = a.shape[axis_a]
    big = cross = None
    for k0 in range(0, n, 8):
        ak = a.narrow(axis_a, k0, min(8, n - k0))
        bk = b.narrow(axis_b, k0, min(8, n - k0))
        if split3:
            ag, as_ = split(ak)
            bg, bs = split(bk)
            bb = torch.einsum(eq, ag, bg)
            cx = torch.einsum(eq, as_, bg) + torch.einsum(eq, ag, bs)
        else:
            bb = torch.einsum(eq, tf32(ak), tf32(bk))
            cx = torch.zeros_like(bb)
        big = bb if big is None else big + bb
        cross = cx if cross is None else cross + cx
    return big, cross


def emulate_tf32x3(q, k, v, *, causal=True, window=None, scale=None,
                   split3=True, narrow=True) -> torch.Tensor:
    """What ``flash_attention_tf32.cu`` computes on f32 or bf16
    ``q``/``k``/``v`` (``[B, H, S, D]``, any D; GQA by repeating K/V,
    which the kernel reads in place): key tile by key tile, S = big·big +
    cross terms scaled into the exp2 domain and masked to -inf, the online
    softmax, the tile's P V a k-step of 8 keys (small·big, big·small,
    big·big, in that order, into a fresh fp32 accumulator), ``O = O *
    alpha + tile``, the row sum of the unsplit P, and ``o * (1 / l)`` (0
    where ``l`` is 0).  A partial last k-step of the head dim is the
    kernel's zero-padded block.  bf16 operands are widened, exact in
    TF32: QKᵀ one product a k-step, PV ``P_small·V`` then ``P_big·V``,
    the output rounded to bf16 (``narrow`` False: the f32 sum before).
    ``split3`` False: one TF32 product a k-step for QKᵀ and PV."""
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = (t.float() for t in (q, k, v))
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    c = (D ** -0.5 if scale is None else scale) * LOG2E
    c = float(np.float32(c))
    BK = tile_keys(D)
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, Hq, Sq), float("-inf"))
    l = torch.zeros((B, Hq, Sq))
    o = torch.zeros((B, Hq, Sq, D))
    for k0 in range(0, Sk, BK):
        kt, vt = kk[:, :, k0:k0 + BK], vv[:, :, k0:k0 + BK]
        big, cross = products(q, kt, "bhqd,bhkd->bhqk", 3, 3,
                              split3 and not bf16)
        s = (big + cross) * c
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        valid = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
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
        ot = torch.zeros_like(o)
        for j in range(0, kt.shape[2], 8):
            pj, vj = p[..., j:j + 8], vt[:, :, j:j + 8]
            if bf16:
                pg, ps = split(pj)
                for a_ in (ps, pg):
                    ot = ot + a_ @ vj
            elif split3:
                pg, ps = split(pj)
                vg, vs = split(vj)
                for a_, b_ in ((ps, vg), (pg, vs), (pg, vg)):
                    ot = ot + a_ @ b_
            else:
                ot = ot + tf32(pj) @ tf32(vj)
        o = o * alpha[..., None] + ot
        m = mnew
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    o = o * inv[..., None]
    return o.to(torch.bfloat16) if bf16 and narrow else o


#: (Hq, Hkv, Sq, Sk, D, causal, window): the cases of
#: ``tests/test_torch_flash_sm90.py``, at f32 -- the granite head dim with
#: 2 query heads on 1 KV head at Sq = Sk = 300, Sq != Sk without
#: ``causal``, a window starting inside a key tile, Sq > Sk (zero rows)
#: and D 80 -- and D 40 (a head dim no multiple of 16, 64-key tiles).
CASES = [(2, 1, 300, 300, 128, True, None),
         (4, 2, 65, 200, 64, False, None),
         (2, 1, 300, 300, 128, True, 100),
         (4, 4, 129, 50, 128, True, None),
         (8, 2, 127, 127, 80, True, None),
         (4, 2, 100, 100, 40, True, None)]
#: Head dims no multiple of 8, at f32: the reduced LM's 20 (the third
#: 8-column block padded from 20 to 24), 36 without ``causal`` and Sq !=
#: Sk, and 100 (class 128, 32-key tiles) under a window.
RAGGED = [(8, 2, 100, 100, 20, True, None),
          (4, 2, 65, 90, 36, False, None),
          (4, 1, 129, 129, 100, True, 50)]
#: bf16 head dims the wgmma route does not take.
BF16_CASES = [(8, 2, 100, 100, 20, True, None),
              (4, 2, 100, 100, 40, True, None),
              (4, 1, 129, 129, 100, True, 50)]


def _inputs(Hq, Hkv, Sq, Sk, D, dtype=torch.float32):
    rng = np.random.default_rng(Hq * 1000 + Sq + D)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dtype)
                 for s in ((1, Hq, Sq, D), (1, Hkv, Sk, D), (1, Hkv, Sk, D)))


def _jax_chunked(q, k, v, causal, window):
    return np.asarray(jfa.attention_chunked(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), causal=causal,
        window=window, block_q=128, block_k=64))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                  # the TF32 neighbour of 1
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0, one, -one, one, 3.0]
    big, small = split(torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -20]))
    assert big.item() == one
    assert small.item() == pytest.approx(-(2.0 ** -11) + 2.0 ** -20, rel=0)


@pytest.mark.parametrize("case", CASES + RAGGED, ids=str)
def test_emulation_matches_plain(case):
    Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = _inputs(Hq, Hkv, Sq, Sk, D)
    got = emulate_tf32x3(q, k, v, causal=causal, window=window)
    want = ref.mha(q, k, v, causal=causal, window=window)
    assert _rel(got, want) <= TOL
    if Sq > Sk and causal:
        assert not got[:, :, :Sq - Sk].any(), "rows with no key must be 0"


@pytest.mark.parametrize("case", CASES + RAGGED, ids=str)
def test_emulation_matches_jax_attention_chunked(case):
    Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = _inputs(Hq, Hkv, Sq, Sk, D)
    got = emulate_tf32x3(q, k, v, causal=causal, window=window)
    want = _jax_chunked(q, k, v, causal, window)
    # A query with no valid key is a zero row here and the mean of V in
    # JAX (its -1e30 stand-in for -inf): such rows are left out.
    rows = np.arange(Sq) >= Sq - Sk if causal else np.ones(Sq, bool)
    assert _rel(got.numpy()[:, :, rows], want[:, :, rows]) <= TOL


def test_unsplit_tf32_misses_the_bar():
    """One TF32 product a k-step keeps 11 bits of each operand: the 1e-5
    bar catches it, so the split is what the emulation tests pass on."""
    q, k, v = _inputs(2, 1, 300, 300, 128)
    want = ref.mha(q, k, v)
    assert _rel(emulate_tf32x3(q, k, v), want) <= TOL
    assert _rel(emulate_tf32x3(q, k, v, split3=False), want) > TOL


@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_bf16_emulation_matches_plain_and_jax(case):
    """bf16 operands on the tf32 route: the f32 sum before the narrowing
    within 1e-5 of ``ref.mha`` and JAX on the widened inputs; the bf16
    output that sum rounded to nearest even, within the card's bf16 bar
    of the plain version."""
    Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = _inputs(Hq, Hkv, Sq, Sk, D, torch.bfloat16)
    assert fa.route(torch.bfloat16, D) == "tf32"
    acc = emulate_tf32x3(q, k, v, causal=causal, window=window,
                         narrow=False)
    got = emulate_tf32x3(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want = ref.mha(*(t.float() for t in (q, k, v)), causal=causal,
                   window=window)
    assert _rel(acc, want) <= TOL
    assert _rel(acc, _jax_chunked(q, k, v, causal, window)) <= TOL
    assert torch.equal(got, acc.to(torch.bfloat16))
    assert _rel(got.float(), want) <= 1e-2


def test_bf16_one_product_is_the_three():
    """A widened bf16 operand has no small part: the three products of the
    f32 route give the one (QKᵀ) and two (PV) products' result."""
    q, k, v = _inputs(4, 2, 100, 100, 40, torch.bfloat16)
    one = emulate_tf32x3(q, k, v, narrow=False)
    three = emulate_tf32x3(*(t.float() for t in (q, k, v)))
    assert torch.equal(one, three)
