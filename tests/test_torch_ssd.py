"""The Mamba-2 SSD in the port against the JAX package on the CPU:
``ref.ssd_reference``, ``_segsum``, ``ssd_chunked`` and
``ssd_decode_step`` against JAX's ``ref``; ``ops.ssd`` (``Q = min(chunk,
L)``, padding with ``dt = 0``, ``ref.ssd_chunk_diag`` -- K12's plain
version -- and the cross-chunk code ``ref.ssd_combine`` that runs beside
K12 on the card) against JAX's Pallas kernel in interpret mode
(``kops.ssd(impl="pallas")``) and the sequential recurrence;
``ssd_chunk_diag`` against the formula written out position by
position; a prefill -> decode chain (``tests/test_kernels.py``'s
``test_ssd_initial_state_and_decode_chain``).  Inputs are made with
numpy from a seed and handed to both.

Tolerance: 1e-5 of max |reference| (float32 throughout; the two sum in
another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import mamba_ssd as jssd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import mamba_ssd as mssd
from repro_torch.kernels import ops, ref

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, Bt, L, H, P, N):
    """numpy x, dt, A, B, C, D, initial state."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bt, L, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, L, H)))).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f)
    B = rng.standard_normal((Bt, L, N)).astype(f)
    C = rng.standard_normal((Bt, L, N)).astype(f)
    D = rng.uniform(0.5, 1.5, H).astype(f)
    s0 = rng.standard_normal((Bt, H, P, N)).astype(f)
    return x, dt, A, B, C, D, s0


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), \
        (err, float(np.abs(want).max()))


@pytest.mark.parametrize("init,D", [(False, False), (True, True)])
def test_ssd_reference_matches_jax(init, D):
    x, dt, A, B, C, Dv, s0 = _inputs(1, 2, 13, 3, 4, 5)
    kw = {"initial_state": s0 if init else None}
    Dj = Dv if D else None
    yj, sj = jref.ssd_reference(x, dt, A, B, C, Dj, **kw)
    yt, st = ref.ssd_reference(*_t(x, dt, A, B, C), None if Dj is None
                               else torch.from_numpy(Dj),
                               initial_state=None if s0 is None or not init
                               else torch.from_numpy(s0))
    _close(yt, yj)
    _close(st, sj)


def test_segsum_matches_jax():
    z = np.random.default_rng(2).standard_normal((2, 3, 7)).astype(np.float32)
    got = ref._segsum(torch.from_numpy(z)).numpy()
    want = np.asarray(jref._segsum(jnp.asarray(z)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = ~np.isinf(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("L,chunk,init", [(16, 8, False), (24, 8, True),
                                          (32, 16, True)])
def test_ssd_chunked_matches_jax(L, chunk, init):
    x, dt, A, B, C, D, s0 = _inputs(L, 2, L, 3, 4, 5)
    s0 = s0 if init else None
    yj, sj = jref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                              initial_state=s0)
    yt, st = ref.ssd_chunked(*_t(x, dt, A, B, C, D), chunk=chunk,
                             initial_state=None if s0 is None
                             else torch.from_numpy(s0))
    _close(yt, yj)
    _close(st, sj)


@pytest.mark.parametrize("D", [False, True])
def test_ssd_decode_step_matches_jax_in_place(D):
    x, dt, A, B, C, Dv, s0 = _inputs(3, 2, 1, 3, 4, 5)
    Dj = Dv if D else None
    yj, sj = jref.ssd_decode_step(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                  Dj, s0)
    state = torch.from_numpy(s0.copy())
    yt, st = ops.ssd_decode_step(*_t(x[:, 0], dt[:, 0], A, B[:, 0],
                                     C[:, 0]),
                                 None if Dj is None else torch.from_numpy(Dj),
                                 state)
    assert st is state                  # updated in place
    _close(yt, yj)
    _close(st, sj)


@pytest.mark.parametrize("L,chunk", [(8, 8), (24, 8), (37, 8), (8, 16),
                                     (24, 16), (37, 16), (5, 16), (1, 8)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("init,D", [(False, False), (True, True)],
                         ids=["bare", "D-and-initial-state"])
def test_ops_ssd_matches_pallas_interpret_and_sequential(L, chunk, init, D):
    """The CPU composition (padding, the K12 plain version, the cross-
    chunk code) against JAX's Pallas kernel in interpret mode and the
    exact sequential recurrence."""
    x, dt, A, B, C, Dv, s0 = _inputs(L * 31 + chunk, 2, L, 3, 4, 5)
    s0 = s0 if init else None
    Dv = Dv if D else None
    yp, sp = jops.ssd(x, dt, A, B, C, Dv, chunk=chunk, initial_state=s0,
                      impl="pallas")
    yr, sr = jref.ssd_reference(x, dt, A, B, C, Dv, initial_state=s0)
    lm.reset_launches()
    yt, st = ops.ssd(*_t(x, dt, A, B, C),
                     None if Dv is None else torch.from_numpy(Dv),
                     chunk=chunk,
                     initial_state=None if s0 is None
                     else torch.from_numpy(s0))
    assert not lm.LAUNCHES                 # CPU tensors: no kernel
    assert yt.shape == (2, L, 3, 4) and st.shape == (2, 3, 4, 5)
    _close(yt, yp)
    _close(st, sp)
    _close(yt, yr)
    _close(st, sr)


@pytest.mark.parametrize("L,Q", [(8, 8), (12, 4), (6, 1)])
def test_ssd_chunk_diag_is_the_kernel_formula(L, Q):
    """K12's plain version against the formula written out position by
    position in float64: ``y_diag[i] = sum_{j<=i} (C_i.B_j) exp(cs_i -
    cs_j) dt_j x_j`` and ``state = sum_j exp(cs_last - cs_j) dt_j x_j ⊗
    B_j`` within each chunk."""
    x, dt, A, B, C, _, _ = _inputs(L + Q, 2, L, 3, 4, 5)
    y, st = ref.ssd_chunk_diag(*_t(x, dt, A, B, C), Q)
    nc = L // Q
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (2, L, 3, 4) and st.shape == (2, nc, 3, 4, 5)
    x, dt, A, B, C = (a.astype(np.float64) for a in (x, dt, A, B, C))
    wy = np.zeros((2, L, 3, 4))
    ws = np.zeros((2, nc, 3, 4, 5))
    for b in range(2):
        for c in range(nc):
            s = slice(c * Q, (c + 1) * Q)
            for h in range(3):
                cs = np.cumsum(dt[b, s, h] * A[h])
                for i in range(Q):
                    for j in range(i + 1):
                        wy[b, c * Q + i, h] += (C[b, c * Q + i] @ B[b, c * Q + j]
                                                * np.exp(cs[i] - cs[j])
                                                * dt[b, c * Q + j, h]
                                                * x[b, c * Q + j, h])
                for j in range(Q):
                    ws[b, c, h] += (np.exp(cs[-1] - cs[j]) * dt[b, c * Q + j, h]
                                    * np.outer(x[b, c * Q + j, h],
                                               B[b, c * Q + j]))
    _close(y, wy)
    _close(st, ws)


def test_prefill_then_decode_chain_matches_one_long_recurrence():
    """A chunked prefill's final state handed to serial decode steps gives
    what one sequential recurrence over the whole sequence gives, and
    what JAX's Pallas prefill + decode chain gives."""
    x, dt, A, B, C, D, _ = _inputs(4, 1, 24, 2, 4, 3)
    y_all, s_all = ref.ssd_reference(*_t(x, dt, A, B, C, D))
    cut = 16
    tx, tdt, tA, tB, tC, tD = _t(x, dt, A, B, C, D)
    y1, state = ops.ssd(tx[:, :cut], tdt[:, :cut], tA, tB[:, :cut],
                        tC[:, :cut], tD, chunk=8)
    jy1, jstate = jssd.ssd_chunk_scan(x[:, :cut], dt[:, :cut], A,
                                      B[:, :cut], C[:, :cut], D, chunk=8,
                                      interpret=True)
    ys, jys = [], []
    for t in range(cut, 24):
        y_t, state = ops.ssd_decode_step(tx[:, t], tdt[:, t], tA, tB[:, t],
                                         tC[:, t], tD, state)
        jy_t, jstate = jref.ssd_decode_step(x[:, t], dt[:, t], A, B[:, t],
                                            C[:, t], D, jstate)
        ys.append(y_t)
        jys.append(jy_t)
    _close(y1, y_all[:, :cut])
    _close(torch.stack(ys, 1), y_all[:, cut:])
    _close(state, s_all)
    _close(y1, jy1)
    _close(torch.stack(ys, 1), np.stack([np.asarray(j) for j in jys], 1))
    _close(state, jstate)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the K12 wrapper raises: only ``ops.ssd`` picks the
    plain version, by the tensors' device."""
    x, dt, A, B, C, _, _ = _inputs(5, 1, 8, 2, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        mssd.ssd_chunk_diag(*_t(x, dt, A, B, C), 8)
