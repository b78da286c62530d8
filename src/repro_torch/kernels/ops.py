"""Backend dispatch for the kernel layer (port of the part of
``repro.kernels.ops`` the serving and training paths need).

Dispatch goes by the device of the tensors, never by a silent fallback:

  - a CPU tensor → the plain PyTorch version (``ref.py``);
  - a CUDA tensor → the hand-written kernel, which launches or raises;
    a kind or dtype with no kernel raises too.

This is the only place that makes the choice: the kernels' wrappers
(``level_megastep.MEGASTEPS``, ``level_megastep_bwd.bwd_megastep``,
``level_megastep_bwd.scatter_add_rows``, ``gather_scatter``'s
``gather_rows``/``scatter_rows``, ``cell_kernels``' ``lstm_gates``/
``treelstm_gates``, ``level_step.lstm_level_fused``,
``flash_attention.flash_attention``,
``decode_attention.decode_attention`` and
``mamba_ssd.ssd_chunk_diag``) take CUDA tensors only.  Every megastep
kind (``treelstm``, ``lstm``, ``gru``, ``treefc``) has its kernels; an
unknown kind raises ``ValueError`` on either device.
The reference's ``impl=`` override is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.structure import ScatterPlan
from repro_torch.kernels import cell_kernels as ck
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gather_scatter as gsc
from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels import level_megastep_bwd as lmb
from repro_torch.kernels import level_step as ls
from repro_torch.kernels import mamba_ssd as mssd
from repro_torch.kernels import ref
from repro_torch.obs.registry import get_registry


def _tick(op: str, impl: str) -> None:
    """Count one dispatch through this layer on the metrics registry
    (``kernel.dispatch{op=...,impl=...}``).  PyTorch runs eagerly, so
    this counts calls, one per level."""
    get_registry().inc("kernel.dispatch", op=op, impl=impl)


def lstm_gates(gates: torch.Tensor, c_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM gate chain in one pass (K8a): ``gates`` ``[M, 4H]``
    (``i|f|o|u``), ``c_prev`` ``[M, H]`` → ``(c, h)`` at ``gates.dtype``.
    Forward only on the card."""
    if not gates.is_cuda:
        _tick("lstm_gates", "ref")
        return ref.lstm_gates(gates, c_prev)
    _tick("lstm_gates", "cuda")
    return ck.lstm_gates(gates, c_prev)


def treelstm_gates(i_pre: torch.Tensor, f_pre: torch.Tensor,
                   o_pre: torch.Tensor, u_pre: torch.Tensor,
                   c_k: torch.Tensor, child_mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The child-sum Tree-LSTM gate chain in one pass (K8b):
    ``i/o/u_pre`` ``[M, H]``, ``f_pre``/``c_k`` ``[M, A, H]``,
    ``child_mask`` ``[M, A]`` → ``(c, h)`` at ``i_pre.dtype``.  Forward
    only on the card."""
    if not i_pre.is_cuda:
        _tick("treelstm_gates", "ref")
        return ref.treelstm_gates(i_pre, f_pre, o_pre, u_pre, c_k,
                                  child_mask)
    _tick("treelstm_gates", "cuda")
    return ck.treelstm_gates(i_pre, f_pre, o_pre, u_pre, c_k, child_mask)


def lstm_level_fused(h_prev: torch.Tensor, c_prev: torch.Tensor,
                     ext_proj: torch.Tensor, wh: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused LSTM batching task (K9): ``h_prev · W_h`` + ``ext_proj``
    + ``b``, then the gate chain, the gates never written out → ``(c, h)``
    at ``h_prev.dtype``.  Forward only on the card."""
    if not h_prev.is_cuda:
        _tick("lstm_level_fused", "ref")
        return ref.lstm_level_fused(h_prev, c_prev, ext_proj, wh, b)
    _tick("lstm_level_fused", "cuda")
    return ls.lstm_level_fused(h_prev, c_prev, ext_proj, wh, b)


def level_megastep(kind: str, buf: torch.Tensor, child_ids: torch.Tensor,
                   child_mask: torch.Tensor, ext_ids: torch.Tensor,
                   node_mask: torch.Tensor, offset: int, ext: torch.Tensor,
                   weights: Tuple[torch.Tensor, ...], *,
                   live: Optional[int] = None) -> torch.Tensor:
    """One fused batching task: gather child rows out of ``buf`` (its last
    row the zero sentinel), run the declared gate math, write rows
    ``[offset, offset+M)`` in place.  Returns ``buf``.  ``kind``/
    ``weights`` come from the cell's ``GateSpec``.  ``live``: the level's
    live slot count (``DeviceSchedule.live``), which the card's kernels
    (K1, K3, K4, K5) read to stop their product there; the plain version
    ignores it."""
    if not buf.is_cuda:
        _tick("level_megastep", "ref")
        return ref.level_megastep(kind, buf, child_ids, child_mask, ext_ids,
                                  node_mask, offset, ext, weights)
    kernel = lm.MEGASTEPS.get(kind)
    if kernel is None:
        raise ValueError(f"unknown megastep gate kind: {kind!r}")
    _tick("level_megastep", "cuda")
    return kernel(buf, child_ids, ext_ids, node_mask, offset, ext, *weights,
                  live=live)


def frontier_megastep(kind: str, buf: torch.Tensor, child_ids: torch.Tensor,
                      child_mask: torch.Tensor, rows: torch.Tensor,
                      node_mask: torch.Tensor, out_ids: torch.Tensor,
                      weights: Tuple[torch.Tensor, ...], *,
                      ext_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One batching task over a mixed-depth UNION frontier (continuous
    serving): gather child rows from arbitrary rows of ``buf``
    (``[R, S]``, its last row the zero sentinel), run the declared gate
    math, scatter the masked states to the per-lane rows ``out_ids``
    (unique; an id outside ``[0, R)`` is a pad lane, dropped).  ``rows``
    are the pulled rows ``[M, G]``; with ``ext_ids`` (``[M]`` int32) they
    are a matrix of pulled rows that ``ext_ids`` index.  Writes ``buf`` IN
    PLACE and returns it.

    On the card it is one launch: the level megastep of ``kind`` (K1, K3,
    K4 or K5) over ``buf`` itself, which stores lane ``m``'s row at row
    ``out_ids[m]`` (the reference's two launches, the megastep into a
    staging block and then K6b's scatter, folded into the store).

    Contract: within the tick the ``out_ids`` are unique and none of them
    names a row the tick reads, a ``child_ids`` row or the sentinel.  The
    plain version (and the reference) composes the two phases, so an
    overlap would read the row's old state there; in one launch it would
    be a race.  :class:`~repro_torch.serve.continuous.ContinuousBatchEngine`
    never makes one: a lane is a vertex of an in-flight request's current
    level, its row allocated to it alone at admission and written only at
    its own tick; its children are vertices of lower levels of the same
    request, written at earlier ticks (a tick takes at most one level of a
    request, and a level only once the one below it is done); absent
    children and pad lanes read the sentinel, which no vertex owns; pad
    lanes are stored past the arena; and a request's rows return to the
    free list only after its root is read back (K6a), between windows.
    The card does not check it per tick (that would cost a sync);
    :func:`frontier_contract_holds` checks a tick where a caller wants
    to."""
    if not buf.is_cuda:
        _tick("frontier_megastep", "ref")
        if ext_ids is not None:
            rows = rows.index_select(0, ext_ids)
        return ref.frontier_megastep(kind, buf, child_ids, child_mask, rows,
                                     node_mask, out_ids, weights)
    kernel = lm.MEGASTEPS.get(kind)
    if kernel is None:
        raise ValueError(f"unknown megastep gate kind: {kind!r}")
    if ext_ids is None:
        ext_ids = torch.arange(child_ids.shape[0], dtype=torch.int32,
                               device=buf.device)
    _tick("frontier_megastep", "cuda")
    return kernel(buf, child_ids, ext_ids, node_mask, 0, rows, *weights,
                  out_ids=out_ids)


def gather_rows(src: torch.Tensor, idx, *,
                host_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` (Cavs ``gather``/``pull``), a new
    ``[n, D]`` tensor; ``idx``: int32 ids in ``[0, R)`` on the host (a CPU
    tensor or, on the card, a numpy array too).  ``host_out`` (``[>= n,
    D]`` on the host; page-locked on the card) also gets the rows: on the
    card through the same launch, once the stream has passed it."""
    if not src.is_cuda:
        _tick("gather_rows", "ref")
        out = ref.gather_rows(src, torch.as_tensor(idx))
        if host_out is not None:
            host_out[:out.shape[0]].copy_(out)
        return out
    _tick("gather_rows", "cuda")
    return gsc.gather_rows(src, idx, host_out=host_out)


def scatter_rows(dst: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``dst[idx[i]] = rows[i]`` (Cavs ``scatter``/``push``) in place;
    unique ids, an id outside ``[0, R)`` dropped.  Returns ``dst``."""
    if not dst.is_cuda:
        _tick("scatter_rows", "ref")
        return ref.scatter_rows(dst, idx, rows)
    _tick("scatter_rows", "cuda")
    return gsc.scatter_rows(dst, idx, rows)


def bwd_workspace(kind: str, g: torch.Tensor, M: int, A: int,
                  H: int) -> Optional[torch.Tensor]:
    """The reverse megastep's workspace for a backward of kind ``kind``
    over levels of ``M`` slots, allocated once and handed to every
    level's :func:`bwd_megastep`; ``None`` for a CPU gradient buffer (the
    plain version needs none)."""
    return lmb.bwd_workspace(kind, M, A, H, g.device) if g.is_cuda else None


def bwd_megastep(kind: str, g: torch.Tensor, buf: torch.Tensor,
                 child_ids: torch.Tensor, child_mask: torch.Tensor,
                 ext_ids: torch.Tensor, node_mask: torch.Tensor,
                 offset: int, ext: torch.Tensor,
                 weights: Tuple[torch.Tensor, ...], *,
                 sort_perm: Optional[torch.Tensor] = None,
                 sorted_child_ids: Optional[torch.Tensor] = None,
                 run_head: Optional[torch.Tensor] = None,
                 workspace: Optional[torch.Tensor] = None,
                 live: Optional[int] = None, single: Optional[bool] = None,
                 heads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused reverse batching task: recompute the level's gates from
    the residual node buffer ``buf``, run the cotangent math and
    scatter-ADD the child-row cotangents into the gradient buffer ``g``
    in place (∂gather = scatter-add, §3.4).  Returns ``g``.

    On the card the level's sorted runs (``sort_perm`` /
    ``sorted_child_ids`` / ``run_head``, from ``pack_batch``) are
    required, and its plan (``live`` / ``single`` / ``heads``, from
    ``LevelSchedule.bwd_plans``) is read where given; the plain version
    ignores them and the workspace."""
    if not g.is_cuda:
        _tick("bwd_megastep", "ref")
        return ref.bwd_megastep(kind, g, buf, child_ids, child_mask,
                                ext_ids, node_mask, offset, ext, weights)
    _tick("bwd_megastep", "cuda")
    return lmb.bwd_megastep(kind, g, buf, child_ids, ext_ids, node_mask,
                            offset, ext, weights, sort_perm=sort_perm,
                            sorted_child_ids=sorted_child_ids,
                            run_head=run_head, workspace=workspace,
                            live=live, single=single, heads=heads)


def scatter_add_rows(dst: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor, *,
                     plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """``dst[idx[i]] += rows[i]`` with repeats, in place, deterministic
    (∂gather = scatter-add, ∂pull = push, §3.4).  Returns ``dst``.

    ``plan``: ``idx``'s scatter plan (``DeviceSchedule.ext_plan`` /
    ``child_plans[t]``), which the card's kernel reads; without one the
    kernel's wrapper builds it, waiting for the card.  The plain version
    ignores it."""
    if not dst.is_cuda:
        _tick("scatter_add_rows", "ref")
        return ref.scatter_add_rows(dst, idx, rows)
    _tick("scatter_add_rows", "cuda")
    return lmb.scatter_add_rows(dst, idx, rows, plan=plan)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """``[B, Hq, Sq, D] x [B, Hkv, Sk, D]^2 -> [B, Hq, Sq, D]`` (K10):
    GQA, ``causal`` with the ends aligned, sliding ``window``, ``scale``
    (default ``D ** -0.5``); float32 math, ``q``'s type out.  Under
    grad, autograd differentiates ``ref.mha`` on the CPU; on the card
    K10's wrapper runs its hand-written backward (float32)."""
    if not q.is_cuda:
        _tick("attention", "ref")
        return ref.mha(q, k, v, causal=causal, window=window, scale=scale)
    _tick("attention", "cuda")
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Optional[torch.Tensor] = None,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``[B, Hq, D] x [B, Hkv, S, D]^2 -> [B, Hq, D]`` (K11): one token a
    sequence against its cache, rows ``>= kv_len[b]`` masked (``kv_len``
    ``[B]`` int32 on the tensors' device, default every row), ``window``,
    GQA, ``scale`` (default ``D ** -0.5``)."""
    if not q.is_cuda:
        _tick("decode_attention", "ref")
        return ref.decode_attention(q, k, v, kv_len=kv_len, window=window,
                                    scale=scale)
    _tick("decode_attention", "cuda")
    return dec.decode_attention(q, k, v, kv_len=kv_len, window=window,
                                scale=scale)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: Optional[torch.Tensor] = None, *,
        chunk: int = 128, initial_state: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space-dual scan (K12); returns ``(y, final_state)``.

    ``x`` ``[Bt, L, H, P]``, ``dt`` ``[Bt, L, H]``, ``A`` ``[H]``,
    ``B``/``C`` ``[Bt, L, N]``, ``D`` ``[H]``; ``y`` at ``x``'s type, the
    state ``[Bt, H, P, N]`` float32.  As the reference: ``Q = min(chunk,
    L)`` and the sequence is padded to a multiple of ``Q`` with ``dt = 0``
    rows (decay ``exp(0) = 1`` and no input, so the final state is exact;
    the padded ``y`` rows are dropped).  The within-chunk part is K12 on a
    CUDA tensor and ``ref.ssd_chunk_diag`` on a CPU one; both then go
    through the same cross-chunk code (``ref.ssd_combine``)."""
    L = x.shape[1]
    Q = min(chunk, L)
    Lp = -(-L // Q) * Q
    if Lp != L:
        pad = Lp - L
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    if not x.is_cuda:
        _tick("ssd", "ref")
        y_diag, states = ref.ssd_chunk_diag(x, dt, A, B, C, Q)
    else:
        _tick("ssd", "cuda")
        y_diag, states = mssd.ssd_chunk_diag(x, dt, A, B, C, Q)
    y, s = ref.ssd_combine(y_diag, states, x, dt, A, C, D, initial_state)
    return y[:, :L], s


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    D: Optional[torch.Tensor], state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSM update, plain ops on either device (plain jnp in the
    reference too): ``state`` ``[Bt, H, P, N]`` float32 is updated IN
    PLACE and returned with ``y`` ``[Bt, H, P]``."""
    _tick("ssd_decode_step", "ref")
    return ref.ssd_decode_step(x, dt, A, B, C, D, state)


# ---------------------------------------------------------------------------
# Diagnostics (called by no path of the package)
# ---------------------------------------------------------------------------

def frontier_contract_holds(child_ids: torch.Tensor, out_ids: torch.Tensor,
                            rows: int) -> torch.Tensor:
    """Whether one tick keeps :func:`frontier_megastep`'s contract over an
    arena of ``rows`` rows (the last the sentinel): its ids inside
    ``[0, rows)`` are unique and none of them is a ``child_ids`` row or
    the sentinel.  A 0-d bool tensor on the ids' device, computed with no
    copy to the host (a caller that reads it syncs).

    A diagnostic, not part of the dispatch: no path of the package calls
    it; the tests and ``chip_smoke.py`` check the ticks they tap with
    it."""
    dev = out_ids.device
    ids = out_ids.long()
    inside = (ids >= 0) & (ids < rows)
    slot = torch.where(inside, ids, torch.full_like(ids, rows))
    stored = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    stored.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    read = torch.zeros(rows + 1, dtype=torch.bool, device=dev)
    read.index_fill_(0, child_ids.reshape(-1).long(), True)
    read[rows - 1] = True
    stored, read = stored[:rows], read[:rows]
    return (stored <= 1).all() & ~(read & (stored > 0)).any()
