"""K12, the Mamba-2 chunk scan (``csrc/ssd_chunk_sm90.cu``), where no card
is present: the host plan of a launch's units, the wrapper's launch
arguments, and the kernel's arithmetic emulated in plain PyTorch against
the plain version, JAX's reference and the Pallas K12.

- ``plan_units`` decodes a launch's block indices as the kernel does:
  y units (a row block of up to 16 rows of a (sequence, chunk, group of
  HG heads), the last row blocks first) and state units (a range of N
  columns of a (sequence, chunk, head)).  At mamba2-370m's shapes and the
  main path's 20 prompt lengths (``chip_smoke.py``'s Mamba traffic), and
  at the cases of the retired ``head_group`` rule, every launch holds 132
  CTAs where its units allow, each row, head and state column is
  covered once, and no row tile spans rows past ``ceil(Q / 16) 16``.
- ``emulate_ssd_tf32x3`` repeats what the kernel computes: the cumsum as
  its warp scan (four positions a lane in order, the lane totals by a
  Hillis-Steele scan, the total before a lane added to its sums); S = C
  Bᵀ only over the 8-key blocks a unit needs (to its last row), each
  k-step of 8 as three TF32 products (``cvt.rna`` on int32 bit views;
  small·big, big·small, big·big; the big·big products and the cross
  terms of the even and of the odd k-steps in four fp32 sums added at
  the end); the factor ``exp(cs_i - cs_j) dt_j``, ``exp(-inf) = 0`` above
  the diagonal, on S; S's 8-key blocks permuted into the A operand, each
  block's product with x in a fresh fp32 sum added to the partial of the
  warp that takes the block (block kb to warp kb % 4), the four partials
  summed in warp order; the state's product over the chunk's keys,
  in the same key order, with x scaled by ``exp(cs_last - cs_j) dt_j``,
  in one fp32 sum.  The helpers are ``tests/test_torch_bwd_sm90.py``'s.
- At Q 1, 2, 8, 37, 64 and 128, P 16, 64 and 128, N 16 and 128, with
  bf16-rounded inputs and with a strong decay (``exp(cs_i - cs_j)``
  down to about 1e-17 within a chunk): the emulated ``y_diag`` and states
  through the port's ``ref.ssd_combine`` within 1e-5 of max |JAX| of
  ``repro.kernels.ref.ssd_chunked`` and (at fewer shapes) of the Pallas
  K12 in interpret mode, and directly within 1e-5 of the port's
  ``ref.ssd_chunk_diag``.  One TF32 product a k-step without the split
  misses that bar (``test_unsplit_tf32_misses_the_bar``).  The emulation's
  sums round as IEEE fp32 does; the tensor core's cut, which
  ``chip_smoke.py`` and the ``gpu`` tests hold to the same bar on the
  card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import mamba_ssd as jssd
from repro.kernels import ref as jref
from repro_torch.kernels import mamba_ssd as mssd
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _test_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_bwd = _test_module("_bwd_sm90_tests",
                    ROOT / "tests" / "test_torch_bwd_sm90.py")
tf32, split, mma3 = _bwd.tf32, _bwd.split, _bwd.mma3


def _chip_smoke():
    return _test_module("chip_smoke", ROOT / "chip_smoke.py")


def main_path_prompt_lengths():
    """The 20 prompt lengths of ``chip_smoke.py``'s Mamba-2 traffic."""
    cs = _chip_smoke()
    return [len(r.prompt) for r in cs.mamba_traffic(50280)]


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def plan_units(Bt, L, H, P, N, Q, hg, ns, r):
    """The kernel's units by block index: ("y", b, c, heads, r0, rows) and
    ("state", b, c, h, n0, nw)."""
    rt = r * mssd.ROW_TILE
    nc, nrt = L // Q, -(-Q // rt)
    ngr = -(-H // hg)
    per_rt = Bt * nc * ngr
    nb = -(-N // 8)
    nbu = -(-nb // ns)
    units = []
    for u in range(per_rt * nrt + Bt * nc * H * ns):
        if u < per_rt * nrt:
            r0 = (nrt - 1 - u // per_rt) * rt
            v = u % per_rt
            h0 = (v % ngr) * hg
            v //= ngr
            c, b = v % nc, v // nc
            units.append(("y", b, c, tuple(range(h0, min(H, h0 + hg))), r0,
                          min(rt, Q - r0)))
        else:
            v = u - per_rt * nrt
            s, v = v % ns, v // ns
            h, v = v % H, v // H
            c, b = v % nc, v // nc
            n0 = 8 * nbu * s
            units.append(("state", b, c, h, n0, min(8 * nbu, N - n0)))
    return units


MAMBA = dict(H=32, P=64, N=128)        # mamba2-370m: 32 heads of 64, N 128


def _max_grid(Bt, nc, Q, H, N):
    """CTAs of the finest plan: one head a y unit, a state unit a block of
    8 columns."""
    return Bt * nc * H * (-(-Q // mssd.ROW_TILE) + -(-N // 8))


@pytest.mark.parametrize("n", main_path_prompt_lengths())
def test_plan_fills_the_card_on_the_main_path(n):
    """Each of the main path's 20 prompts (one sequence, ``ops.ssd``'s Q =
    min(128, L), padded to a multiple of it): at least 132 CTAs, since the
    units allow them; one C Bᵀ shared by two heads and two row blocks a y
    unit only where the grid still holds two CTAs an SM."""
    Q = min(128, n)
    nc = -(-n // Q)
    hg, ns, r, grid = mssd.ssd_plan(1, nc, Q, **MAMBA, sms=SMS)
    assert _max_grid(1, nc, Q, MAMBA["H"], MAMBA["N"]) >= SMS
    assert grid >= SMS
    assert hg == 1 or nc * (32 * -(-Q // 16) + 32 * ns) >= 2 * SMS
    assert r == 1 or grid >= 2 * SMS
    units = plan_units(1, nc * Q, 32, 64, 128, Q, hg, ns, r)
    assert len(units) == grid


# The cases of the retired ``head_group`` rule (Bt, nc, H), at mamba2-370m's
# chunk, head dim and state.
@pytest.mark.parametrize("Bt,nc,H", [(1, 8, 32), (1, 1, 32), (1, 20, 32),
                                     (2, 33, 32), (3, 50, 7)])
def test_plan_keeps_the_card_busy(Bt, nc, H):
    hg, ns, r, grid = mssd.ssd_plan(Bt, nc, 128, H, 64, 128, SMS)
    assert grid == len(plan_units(Bt, nc * 128, H, 64, 128, 128, hg, ns, r))
    assert grid >= min(SMS, _max_grid(Bt, nc, 128, H, 128))
    assert hg in (1, 2) and r in (1, 2)
    assert hg == 1 or Bt * nc * (H * 8 + H * ns) >= 2 * SMS


@pytest.mark.parametrize("Bt,L,H,P,N,Q", [
    (1, 1, 32, 64, 128, 1), (1, 2, 32, 64, 128, 2), (1, 37, 32, 64, 128, 37),
    (2, 74, 1, 64, 16, 37), (1, 128, 32, 64, 128, 128),
    (1, 1024, 32, 64, 128, 128), (1, 640, 32, 64, 128, 128),
    (1, 2560, 30, 16, 16, 128), (3, 24, 5, 128, 16, 8),
    (1, 100, 3, 48, 40, 100), (2, 16, 7, 16, 128, 16),
    (1, 5, 32, 64, 128, 1)])
def test_plan_units_cover_each_output_once(Bt, L, H, P, N, Q):
    """Every (sequence, chunk, head, row) in one y unit's rows and every
    (sequence, chunk, head, state column) in one state unit; no row block
    spans rows past ``ceil(Q / 16) 16``; a state unit's 8-column blocks
    are at most 8 an n-warp; the last row blocks take the lowest block
    indices."""
    nc = L // Q
    hg, ns, r, grid = mssd.ssd_plan(Bt, nc, Q, H, P, N, SMS)
    units = plan_units(Bt, L, H, P, N, Q, hg, ns, r)
    assert len(units) == grid
    rows, cols = set(), set()
    pad = -(-Q // 16) * 16
    last_r0 = None
    for u in units:
        if u[0] == "y":
            _k, b, c, heads, r0, nrows = u
            assert 0 < nrows <= 16 * r and r0 + -(-nrows // 16) * 16 <= pad
            assert last_r0 is None or r0 <= last_r0
            last_r0 = r0
            for h in heads:
                for i in range(r0, r0 + nrows):
                    assert (b, c, h, i) not in rows
                    rows.add((b, c, h, i))
        else:
            _k, b, c, h, n0, nw = u
            _wp, wn = mssd.state_warps(P)
            assert 0 < nw and -(-nw // 8) <= 8 * wn
            for n in range(n0, n0 + nw):
                assert (b, c, h, n) not in cols
                cols.add((b, c, h, n))
    assert len(rows) == Bt * nc * H * Q
    assert len(cols) == Bt * nc * H * N


def test_wrapper_launch_arguments(monkeypatch):
    """The wrapper's launch with the launch stubbed: the plan's HG and NS,
    x/B/C's strides as views of one ``xBC`` tensor, dt's strides, the bf16
    flag, one count."""
    got = []
    monkeypatch.setattr(mssd, "require_cuda", lambda op, t: None)
    monkeypatch.setattr(mssd, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(mssd, "launch_kernel",
                        lambda op, dev, *args: got.append((op, args)))
    Bt, L, H, P, N, Q = 1, 256, 32, 64, 128, 128
    for dtype in (torch.float32, torch.bfloat16):
        xBC = torch.zeros(Bt, L, H * P + 2 * N, dtype=dtype)
        x = xBC[..., :H * P].reshape(Bt, L, H, P)
        B, C = xBC[..., H * P:H * P + N], xBC[..., H * P + N:]
        dt = torch.zeros(Bt, L, H)
        A = torch.zeros(H)
        y, s = mssd.ssd_chunk_diag(x, dt, A, B, C, Q)
        assert y.shape == (Bt, L, H, P) and s.shape == (Bt, 2, H, P, N)
        op, args = got[-1]
        assert op == "ssd_chunk_scan"
        hg, ns, r, _grid = mssd.ssd_plan(Bt, 2, Q, H, P, N, SMS)
        assert args[7:16] == (Bt, L, H, P, N, Q, hg, ns, r)
        row = H * P + 2 * N
        assert args[16:26] == (L * row, row, P, L * H, H, 1, L * row, row,
                               L * row, row)
        assert args[26] == int(dtype == torch.bfloat16)
    assert len(got) == 2


# ---------------------------------------------------------------------------
# The kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def warp_scan_cumsum(da):
    """The inclusive cumsum over the last dim (at most 128) as the kernel's
    warp scan takes it: four positions a lane in order, the lane totals by
    a Hillis-Steele scan, the total before a lane added to its sums."""
    Q = da.shape[-1]
    d = torch.nn.functional.pad(da, (0, 128 - Q)).reshape(
        *da.shape[:-1], 32, 4)
    part = [d[..., 0]]
    for e in range(1, 4):
        part.append(part[-1] + d[..., e])
    part = torch.stack(part, -1)
    incl = part[..., 3].clone()
    for o in (1, 2, 4, 8, 16):
        up = torch.nn.functional.pad(incl[..., :-o], (o, 0))
        incl = torch.where(torch.arange(32) >= o, incl + up, incl)
    excl = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    return (excl[..., None] + part).reshape(*da.shape[:-1], 128)[..., :Q]


#: A's column t holds key 2t and column t + 4 key 2t + 1 of an 8-key block.
PERM = [0, 2, 4, 6, 1, 3, 5, 7]


def emulate_ssd_tf32x3(x, dt, A, B, C, Q, split3=True, r=None):
    """What K12 leaves in ``y_diag`` and ``states`` (float32) for f32 or
    bf16 ``x`` ``[Bt, L, H, P]``, ``B``/``C`` ``[Bt, L, N]``, ``dt``
    ``[Bt, L, H]``, ``A`` ``[H]``, with ``r`` row blocks a y unit (the
    plan's by default)."""
    Bt, L, H, P = x.shape
    N, nc = B.shape[-1], L // Q
    if r is None:
        r = mssd.ssd_plan(Bt, nc, Q, H, P, N, SMS)[2]
    ks = 4 // r                          # warps a row block
    f32 = torch.float32
    Qp, Np, Pp = -(-Q // 8) * 8, -(-N // 16) * 16, -(-P // 8) * 8
    xc = torch.nn.functional.pad(
        x.to(f32).reshape(Bt, nc, Q, H, P).movedim(3, 2),
        (0, Pp - P, 0, Qp - Q))                          # [Bt,nc,H,Qp,Pp]
    Bc = torch.nn.functional.pad(B.to(f32).reshape(Bt, nc, Q, N),
                                 (0, Np - N, 0, Qp - Q))  # [Bt,nc,Qp,Np]
    Cc = torch.nn.functional.pad(C.to(f32).reshape(Bt, nc, Q, N),
                                 (0, Np - N, 0, Qp - Q))
    dtc = torch.nn.functional.pad(
        dt.to(f32).reshape(Bt, nc, Q, H).movedim(3, 2), (0, Qp - Q))
    da = dtc * A.to(f32)[None, None, :, None]
    cs = warp_scan_cumsum(da[..., :Q])
    cs = torch.cat([cs, cs[..., -1:].expand(*cs.shape[:-1], Qp - Q)], -1)
    w = torch.exp(cs[..., Q - 1:Q] - cs) * dtc
    w[..., Q:] = 0.0

    # S over the square, by k-steps of 8: big.big and the cross terms, of
    # the even and of the odd k-steps apart where a warp takes one block a
    # tile (r 1).
    Bt_ = Bc.transpose(-1, -2)
    sb = [torch.zeros(Bt, nc, Qp, Qp) for _ in range(2)]
    sx = [torch.zeros(Bt, nc, Qp, Qp) for _ in range(2)]
    for k in range(0, Np, 8):
        q = (k // 8) % 2 if r == 1 else 0
        a, b = Cc[..., k:k + 8], Bt_[..., k:k + 8, :]
        if not split3:
            sb[q] = sb[q] + tf32(a) @ tf32(b)
            continue
        ag, as_ = split(a)
        bg, bs = split(b)
        sx[q] = sx[q] + as_ @ bg
        sx[q] = sx[q] + ag @ bs
        sb[q] = sb[q] + ag @ bg
    S = ((sb[0] + sb[1]) + (sx[0] + sx[1]))[:, :, None]  # [Bt,nc,1,Qp,Qp]
    # A unit's blocks: to its last row, within the chunk.
    i = torch.arange(Qp)[:, None]
    j = torch.arange(Qp)[None, :]
    last_row = (i // 16) * 16 + 15
    taken = (j // 8) <= torch.minimum(last_row // 8,
                                      torch.tensor(-(-Q // 8) - 1))
    S = torch.where(taken, S, 0.0)
    arg = torch.where(j <= i, cs[..., :, None] - cs[..., None, :],
                      torch.tensor(-float("inf")))
    M = S * (torch.exp(arg) * dtc[..., None, :])          # [Bt,nc,H,Qp,Qp]
    assert bool((M[..., ~taken.expand(Qp, Qp)] == 0).all()), \
        "a skipped block held a nonzero term"
    perm = torch.tensor([8 * b + p for b in range(Qp // 8) for p in PERM])
    Mp, xp = M[..., perm], xc[..., perm, :]
    # Block kb goes to key lane kb % (4 / r) of its row block: a fresh sum
    # a block, added to the lane's partial; the partials summed in order.
    parts = [torch.zeros(Bt, nc, H, Qp, Pp) for _ in range(ks)]
    for kb in range(Qp // 8):
        blk = mma3(torch.zeros(Bt, nc, H, Qp, Pp),
                     Mp[..., 8 * kb:8 * kb + 8], xp[..., 8 * kb:8 * kb + 8, :],
                     split3)
        parts[kb % ks] = parts[kb % ks] + blk
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    y = y[..., :Q, :P].movedim(2, 3).reshape(Bt, L, H, P)

    Wt = (xc * w[..., None])[..., perm, :].transpose(-1, -2)   # [..,Pp,Qp]
    Bp = Bc[:, :, None][..., perm, :]                        # [..,Qp,Np]
    st = torch.zeros(Bt, nc, H, Pp, Np)
    for k in range(0, Qp, 8):
        st = mma3(st, Wt[..., k:k + 8], Bp[..., k:k + 8, :], split3)
    return y, st[..., :P, :N].contiguous()


def _inputs(seed, Bt, L, H, P, N, kind):
    """numpy x, dt, A, B, C, D: ``kind`` "f32", "bf16" (x, B and C rounded
    to bf16 and handed over as bf16) or "strong" (dt A down to about -0.3
    a position and -5 at Q 8: exp(cs_i - cs_j) spans about 17 orders in a
    chunk)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bt, L, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, L, H)) - 1.0)).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f)
    B = rng.standard_normal((Bt, L, N)).astype(f)
    C = rng.standard_normal((Bt, L, N)).astype(f)
    D = rng.uniform(0.5, 1.5, H).astype(f)
    if kind == "strong":
        Q = min(128, L)
        dt = rng.uniform(0.5, 1.0, (Bt, L, H)).astype(f)
        A = np.full(H, -40.0 / (0.75 * Q), f)
    if kind == "bf16":
        x, B, C = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                   for a in (x, B, C))
    return x, dt, A, B, C, D


def _t(kind, x, dt, A, B, C):
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dt),
            torch.from_numpy(A), torch.from_numpy(B).to(dtype),
            torch.from_numpy(C).to(dtype))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _full(y_diag, states, x, dt, A, C, D):
    """The emulated chunk scan through the port's cross-chunk code."""
    return ref.ssd_combine(y_diag, states, x, dt, A, C, D)


# (Bt, L, H, P, N, Q, kind): Q 1, 2, 8, 37, 64 and 128; P 16, 64 and 128;
# N 16 and 128; bf16-rounded inputs; a strong decay.
CASES = [
    (2, 3, 2, 64, 128, 1, "f32"),
    (1, 4, 3, 64, 16, 2, "f32"),
    (2, 24, 3, 16, 16, 8, "f32"),
    (1, 74, 2, 64, 16, 37, "f32"),
    (1, 128, 2, 128, 128, 64, "f32"),
    (1, 256, 2, 64, 128, 128, "f32"),
    (1, 128, 3, 16, 128, 128, "f32"),
    (2, 37, 2, 128, 16, 37, "bf16"),
    (1, 128, 2, 64, 128, 128, "bf16"),
    (1, 24, 2, 64, 16, 8, "strong"),
    (1, 256, 2, 64, 128, 128, "strong"),
]


def _id(case):
    return "-".join(map(str, case))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_emulation_matches_jax_ssd_chunked(case):
    Bt, L, H, P, N, Q, kind = case
    x, dt, A, B, C, D = _inputs(L * 7 + Q + P, Bt, L, H, P, N, kind)
    tx, tdt, tA, tB, tC = _t(kind, x, dt, A, B, C)
    yd, st = emulate_ssd_tf32x3(tx, tdt, tA, tB, tC, Q)
    y, s = _full(yd, st, tx.float(), tdt, tA, tC.float(),
                 torch.from_numpy(D))
    yj, sj = jref.ssd_chunked(x, dt, A, B, C, D, chunk=Q)
    assert _rel(y, yj) <= TOL
    assert _rel(s, sj) <= TOL


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_emulation_matches_the_plain_version(case, r):
    """Both row splits of a y unit (one row block over four key lanes, two
    over two), whichever the plan picks here."""
    Bt, L, H, P, N, Q, kind = case
    x, dt, A, B, C, _D = _inputs(L * 7 + Q + P, Bt, L, H, P, N, kind)
    tx, tdt, tA, tB, tC = _t(kind, x, dt, A, B, C)
    yd, st = emulate_ssd_tf32x3(tx, tdt, tA, tB, tC, Q, r=r)
    yp, sp = ref.ssd_chunk_diag(tx.float(), tdt, tA, tB.float(), tC.float(),
                                Q)
    assert yd.dtype == st.dtype == torch.float32
    assert _rel(yd, yp) <= TOL
    assert _rel(st, sp) <= TOL


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[8], CASES[9]],
                         ids=_id)
def test_emulation_matches_pallas_interpret(case):
    Bt, L, H, P, N, Q, kind = case
    x, dt, A, B, C, D = _inputs(L * 7 + Q + P, Bt, L, H, P, N, kind)
    tx, tdt, tA, tB, tC = _t(kind, x, dt, A, B, C)
    yd, st = emulate_ssd_tf32x3(tx, tdt, tA, tB, tC, Q)
    y, s = _full(yd, st, tx.float(), tdt, tA, tC.float(),
                 torch.from_numpy(D))
    yj, sj = jssd.ssd_chunk_scan(x, dt, A, B, C, D, chunk=Q, interpret=True)
    assert _rel(y, yj) <= TOL
    assert _rel(s, sj) <= TOL


def test_unsplit_tf32_misses_the_bar():
    """One TF32 product a k-step, as a plain TF32 kernel would take it,
    misses the f32 bar that the split holds."""
    Bt, L, H, P, N, Q, kind = CASES[5]
    x, dt, A, B, C, D = _inputs(L * 7 + Q + P, Bt, L, H, P, N, kind)
    tx, tdt, tA, tB, tC = _t(kind, x, dt, A, B, C)
    yj, sj = jref.ssd_chunked(x, dt, A, B, C, D, chunk=Q)
    errs = {}
    for split3 in (True, False):
        yd, st = emulate_ssd_tf32x3(tx, tdt, tA, tB, tC, Q, split3=split3)
        y, s = _full(yd, st, tx, tdt, tA, tC, torch.from_numpy(D))
        errs[split3] = (_rel(y, yj), _rel(s, sj))
    assert max(errs[True]) <= TOL
    assert min(errs[False]) > TOL, errs


def test_warp_scan_is_a_cumsum():
    """The kernel's scan order against torch's cumsum: the same sums, in
    another order (within fp32 rounding)."""
    da = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 128)).astype(np.float32))
    for Q in (1, 2, 5, 37, 128):
        got = warp_scan_cumsum(da[:, :Q])
        want = torch.cumsum(da[:, :Q].double(), -1)
        assert float((got.double() - want).abs().max()) <= 1e-5
