"""Mamba-2 SSD (state-space duality) chunk scan: one hand-written CUDA
launch (K12) and the plain cross-chunk recurrence beside it.

Port of ``repro.kernels.mamba_ssd``'s Pallas kernel (``ssd_chunk_scan``).
The chunked SSD splits the sequence into chunks of ``Q`` positions:
within a chunk the recurrence is computed in its quadratic dual form,
and across chunks a linear recurrence carries the ``[P, N]`` state.
``csrc/ssd_chunk_sm90.cu`` computes the within-chunk part (``y_diag`` and
the chunk-final states, what ``ref.ssd_chunk_diag`` computes) on the TF32
tensor cores with the 3xTF32 split; its header states the bound and the
design.  :func:`ssd_plan` cuts a launch into the kernel's units.  The
cross-chunk recurrence stays plain PyTorch (``ref.ssd_combine``), as the
reference keeps it in jnp outside the ``pallas_call``.

The wrapper takes CUDA tensors only: it launches the kernel or raises.
The full SSD (the reference's ``ssd_chunk_scan``: padding, this launch
and the cross-chunk code) is ``ops.ssd``, which also picks the plain
version for CPU tensors.  Each launch is counted in
``level_megastep.LAUNCHES["ssd_chunk_scan"]``.  Forward only, as in the
reference (no VJP): a call that would need a gradient raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import refuse_grad
from repro_torch.kernels.level_megastep import (_sm_count, launch_kernel,
                                                require_cuda)

#: Element types of x, B and C; the largest chunk, head dim and state.
DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK, MAX_HEADDIM, MAX_STATE = 128, 128, 128
#: Rows of a y unit's row block, as in the kernel.
ROW_TILE = 16
REPLACES = "src/repro/kernels/mamba_ssd.py:62"

#: What a gradient through K12 waits for (``TransformerLM.loss`` names it
#: too for a config with a Mamba layer).
K12_BACKWARD = ("Mamba training waits for a K12 backward written by hand "
                "(ROADMAP.md queue 2, \"K12 backward\")")


def state_warps(P: int) -> Tuple[int, int]:
    """(p-warps, n-warps) of a state unit's four warps: a p-warp a 16-row
    block of ``P`` (up to four), the rest side by side along N."""
    wp = min(4, -(-P // 16))
    return wp, 4 // wp


def ssd_plan(Bt: int, nc: int, Q: int, H: int, P: int, N: int,
             sms: int) -> Tuple[int, int, int, int]:
    """``(HG, NS, R, grid)``: the kernel's units for a launch of ``Bt``
    sequences of ``nc`` chunks of ``Q`` positions, ``H`` heads of ``P``,
    state ``N``, on a card of ``sms`` SMs.

    A y unit is ``R`` row blocks of ``ROW_TILE`` rows (up to the chunk's
    last row) of a (sequence, chunk, group of ``HG`` heads); its four warps
    take a row block each over ``4 / R`` lanes of its 8-key blocks.  A
    state unit is an N-range of ``8 ceil(ceil(N / 8) / NS)`` columns of a
    (sequence, chunk, head).  ``NS`` starts at the fewest units that keep
    a warp's state accumulator within 8 blocks of 8 columns and doubles,
    while a unit keeps a block of 8 columns, until the grid holds ``sms``
    CTAs.  One ``C Bᵀ`` serves two heads (``HG`` 2, P <= 64) where
    one-head units already give two CTAs an SM, and a unit takes two row
    blocks (``R`` 2, half the staging of B and x) where such units still
    give two CTAs an SM."""
    nrb = -(-Q // ROW_TILE)
    nb = -(-N // 8)
    _wp, wn = state_warps(P)
    ns = -(-nb // (8 * wn))

    def grid(hg: int, ns: int, r: int) -> int:
        return Bt * nc * (-(-H // hg) * -(-nrb // r) + H * ns)

    while grid(1, ns, 1) < sms and 2 * ns <= nb:
        ns *= 2
    ns = -(-nb // -(-nb // ns))          # no unit left without a column
    hg = 2 if P <= 64 and H > 1 and grid(1, ns, 1) >= 2 * sms else 1
    r = 2 if grid(hg, ns, 2) >= 2 * sms else 1
    return hg, ns, r, grid(hg, ns, r)


def _check(op: str, name: str, t: torch.Tensor, ndim: int, dtype,
           device) -> None:
    if t.dim() != ndim:
        raise ValueError(f"{op}: {name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, x on {device}")


def ssd_chunk_diag(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12: the within-chunk part of the SSD in one launch.

    ``x`` ``[Bt, L, H, P]``, ``B``/``C`` ``[Bt, L, N]`` (float32 or bf16,
    one type, unit stride along ``P``/``N``; strided views welcome),
    ``dt`` ``[Bt, L, H]`` float32 (any strides), ``A`` ``[H]`` float32;
    ``L`` a multiple of ``chunk`` (at most 128).  Returns new contiguous
    float32 ``y_diag`` ``[Bt, L, H, P]`` and ``states`` ``[Bt, L/chunk, H,
    P, N]``, as ``ref.ssd_chunk_diag``."""
    op = "ssd_chunk_scan"
    require_cuda(op, x)
    refuse_grad(op, REPLACES, x, dt, A, B, C, waits_for=K12_BACKWARD)
    dev = x.device
    if x.dtype not in DTYPES:
        raise TypeError(f"{op}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    _check(op, "x", x, 4, x.dtype, dev)
    _check(op, "B", B, 3, x.dtype, dev)
    _check(op, "C", C, 3, x.dtype, dev)
    _check(op, "dt", dt, 3, torch.float32, dev)
    _check(op, "A", A, 1, torch.float32, dev)
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    if tuple(B.shape) != (Bt, L, N) or tuple(C.shape) != (Bt, L, N):
        raise ValueError(f"{op}: B and C must be [Bt, L, N] = [{Bt}, {L}, "
                         f"N] alike, got {tuple(B.shape)} and "
                         f"{tuple(C.shape)}")
    if tuple(dt.shape) != (Bt, L, H) or tuple(A.shape) != (H,):
        raise ValueError(f"{op}: dt must be [{Bt}, {L}, {H}] and A [{H}], "
                         f"got {tuple(dt.shape)} and {tuple(A.shape)}")
    if not 0 < chunk <= MAX_CHUNK or L % chunk:
        raise ValueError(f"{op}: chunk {chunk} must be in 1..{MAX_CHUNK} "
                         f"and divide L = {L}")
    if not 0 < P <= MAX_HEADDIM or not 0 < N <= MAX_STATE:
        raise ValueError(f"{op}: head dim {P} and state {N} must be in "
                         f"1..{MAX_HEADDIM} and 1..{MAX_STATE}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{op}: {name} needs unit stride along its "
                             f"last dim, got strides {t.stride()}")
    if not A.is_contiguous():
        raise ValueError(f"{op}: A must be contiguous")
    nc = L // chunk
    y = torch.empty((Bt, L, H, P), dtype=torch.float32, device=dev)
    states = torch.empty((Bt, nc, H, P, N), dtype=torch.float32, device=dev)
    if y.numel():
        hg, ns, r, _grid = ssd_plan(Bt, nc, chunk, H, P, N,
                                     _sm_count(dev))
        launch_kernel(op, dev, y.data_ptr(), states.data_ptr(),
                      x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                      B.data_ptr(), C.data_ptr(), Bt, L, H, P, N, chunk,
                      hg, ns, r,
                      x.stride(0), x.stride(1), x.stride(2),
                      dt.stride(0), dt.stride(1), dt.stride(2),
                      B.stride(0), B.stride(1), C.stride(0), C.stride(1),
                      int(x.dtype == torch.bfloat16))
    return y, states

