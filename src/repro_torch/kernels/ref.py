"""Plain PyTorch versions of the kernels (port of the part of
``repro.kernels.ref`` the serving and training paths need).

These are the semantic ground truth: simplest correct code, no tiling.
On a CPU tensor the ``ops`` dispatch runs them; on the card,
``chip_smoke.py`` holds each hand-written kernel against them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import level_megastep as lm
from repro_torch.kernels.decode_split import row_range, split_rows


def lstm_gates(gates: torch.Tensor, c_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM gate math (K8a): ``gates`` ``[M, 4H]`` (i|f|o|u
    pre-activations), ``c_prev`` ``[M, H]``; the forget gate adds +1.0.
    Computed in float32 whatever the inputs' types, as the Pallas kernel
    does; ``(c, h)`` come back at ``gates.dtype``."""
    i, f, o, u = torch.chunk(gates.float(), 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
    c = f * c_prev.float() + i * torch.tanh(u)
    return c.to(gates.dtype), (o * torch.tanh(c)).to(gates.dtype)


def treelstm_gates(i_pre: torch.Tensor, f_pre: torch.Tensor,
                   o_pre: torch.Tensor, u_pre: torch.Tensor,
                   c_k: torch.Tensor, child_mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Child-sum Tree-LSTM gate math (paper Fig. 4 L7-17; K8b).

    ``i_pre/o_pre/u_pre``: ``[M, H]``; ``f_pre/c_k``: ``[M, A, H]``;
    ``child_mask``: ``[M, A]``.  Computed in float32, as the Pallas
    kernel does; ``(c, h)`` come back at ``i_pre.dtype``.
    """
    i = torch.sigmoid(i_pre.float())
    f = torch.sigmoid(f_pre.float())
    o = torch.sigmoid(o_pre.float())
    u = torch.tanh(u_pre.float())
    c = i * u + torch.sum(f * c_k.float() * child_mask.float()[..., None],
                          dim=1)
    return c.to(i_pre.dtype), (o * torch.tanh(c)).to(i_pre.dtype)


def lstm_level_fused(h_prev: torch.Tensor, c_prev: torch.Tensor,
                     ext_proj: torch.Tensor, wh: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM level, recurrent product and gates (K9): ``gates =
    ext_proj + h_prev · W_h + b`` in float32 (``h_prev``/``c_prev``
    ``[M, H]``, ``ext_proj`` ``[M, 4H]``, ``wh`` ``[H, 4H]``, ``b``
    ``[4H]``), then :func:`lstm_gates`' math; ``(c, h)`` come back at
    ``h_prev.dtype``."""
    gates = ext_proj.float() + h_prev.float() @ wh.float() + b.float()
    c, h = lstm_gates(gates, c_prev)
    return c.to(h_prev.dtype), h.to(h_prev.dtype)


def megastep_cell_state(kind: str, child: torch.Tensor, rows: torch.Tensor,
                        child_mask: torch.Tensor,
                        weights: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The megastep cell math alone: gathered child rows ``[M, A, S]``
    plus pulled (eagerly projected) rows ``[M, G]`` → state ``[M, S]``
    (before node masking).  ``lstm`` and ``gru`` read child 0 only and
    rely on the zero sentinel rather than on ``child_mask``."""
    M, A = child.shape[:2]
    if kind == "lstm":
        wh, b = weights
        H = wh.shape[0]
        prev = child[:, 0, :]
        gates = rows + prev[:, H:] @ wh + b
        c, h = lstm_gates(gates, prev[:, :H])
        return torch.cat([c, h], dim=-1)
    if kind == "treelstm":
        ui, uf, uo, uu, b = weights
        H = ui.shape[0]
        mk = child_mask.to(child.dtype)[..., None]
        cs = child * mk
        c_k, h_k = cs[..., :H], cs[..., H:]
        h_sum = torch.sum(h_k, dim=1)
        xi, xf, xo, xu = torch.split(rows, H, dim=-1)
        bi, bf, bo, bu = torch.split(b, H)
        rec_f = (h_k.reshape(M * A, H) @ uf).reshape(M, A, H)
        c, h = treelstm_gates(
            xi + h_sum @ ui + bi,
            xf[:, None, :] + rec_f + bf,
            xo + h_sum @ uo + bo,
            xu + h_sum @ uu + bu,
            c_k, child_mask.to(child.dtype))
        return torch.cat([c, h], dim=-1)
    if kind == "gru":
        wh, b = weights
        H = wh.shape[0]
        h_prev = child[:, 0, :]
        rec = h_prev @ wh + b
        z = torch.sigmoid(rows[:, :H] + rec[:, :H])
        r = torch.sigmoid(rows[:, H:2 * H] + rec[:, H:2 * H])
        # The reset gate multiplies the recurrent candidate with its bias.
        n = torch.tanh(rows[:, 2 * H:] + r * rec[:, 2 * H:])
        return (1.0 - z) * n + z * h_prev
    if kind == "treefc":
        wc, b = weights
        mk = child_mask.to(child.dtype)[..., None]
        cs = (child * mk).reshape(M, -1)                 # [M, A*H] concat
        return torch.tanh(cs @ wc + rows + b)
    raise ValueError(f"unknown megastep gate kind: {kind!r}")


def level_megastep(kind: str, buf: torch.Tensor, child_ids: torch.Tensor,
                   child_mask: torch.Tensor, ext_ids: torch.Tensor,
                   node_mask: torch.Tensor, offset: int, ext: torch.Tensor,
                   weights: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """One batching task as gather → cell math → contiguous block write
    of rows ``[offset, offset+M)``.  Writes ``buf`` IN PLACE, like the
    kernel it stands beside, and returns it."""
    M, A = child_ids.shape
    S = buf.shape[1]
    child = buf.index_select(0, child_ids.reshape(-1)).reshape(M, A, S)
    rows = ext.index_select(0, ext_ids)
    nm = node_mask.to(buf.dtype)[:, None]
    state = megastep_cell_state(kind, child, rows,
                                child_mask.to(buf.dtype), weights)
    buf[offset:offset + M] = (state * nm).to(buf.dtype)
    return buf


def frontier_megastep(kind: str, buf: torch.Tensor, child_ids: torch.Tensor,
                      child_mask: torch.Tensor, rows: torch.Tensor,
                      node_mask: torch.Tensor, out_ids: torch.Tensor,
                      weights: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """One batching task over a mixed-depth UNION frontier (continuous
    serving): gather child rows from arbitrary rows of ``buf``, run the
    cell math on the pre-gathered pulled rows ``rows`` ``[M, G]``, mask
    by ``node_mask`` and scatter the states to the per-lane rows
    ``out_ids`` (unique; an id outside ``[0, R)`` is a pad lane, dropped).
    Writes ``buf`` IN PLACE, like the kernels it stands beside, and
    returns it.  The row math is exactly :func:`megastep_cell_state`."""
    M, A = child_ids.shape
    S = buf.shape[1]
    child = buf.index_select(0, child_ids.reshape(-1)).reshape(M, A, S)
    nm = node_mask.to(buf.dtype)[:, None]
    state = megastep_cell_state(kind, child, rows,
                                child_mask.to(buf.dtype), weights)
    return scatter_rows(buf, out_ids, (state * nm).to(buf.dtype))


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` — the Cavs ``gather``/``pull`` memcpy.
    Indices must lie in ``[0, R)``."""
    return src.index_select(0, idx.long())


def scatter_rows(dst: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``dst[idx[i]] = rows[i]`` — the Cavs ``scatter``/``push`` memcpy,
    with the reference's ``mode="drop"``: ids are unique and an id
    outside ``[0, R)`` is dropped.  Writes ``dst`` IN PLACE, like the
    kernel it stands beside, and returns it."""
    keep = (idx >= 0) & (idx < dst.shape[0])
    dst[idx[keep].long()] = rows[keep].to(dst.dtype)
    return dst


def scatter_add_rows(dst: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``dst[idx[i]] += rows[i]``, duplicates accumulate — the transpose
    of a row gather: ∂gather = scatter-add (Cavs §3.4).  Writes ``dst``
    IN PLACE, like the kernel it stands beside, and returns it.  Indices
    must lie in ``[0, R)``: masked rows arrive as zero rows aimed at a
    sentinel row, and nothing is dropped."""
    return dst.index_add_(0, idx.long(), rows.to(dst.dtype))


#: Warps of the scatter-add's combine block, each summing one contiguous
#: group of a split run's chunk sums (``kGroups`` in
#: ``csrc/scatter_add_rows.cu``).
SCATTER_GROUPS = 16


def scatter_add_rows_planned(dst: torch.Tensor, rows: torch.Tensor,
                             plan) -> torch.Tensor:
    """``dst[idx[i]] += rows[i]`` summed in the order of the card's
    kernel along ``plan`` (a ``core.structure.ScatterPlan`` of ``idx``):
    each chunk's rows in plan order from its first row; a row that is one
    chunk gets ``dst + sum``; a split run's chunk sums are cut into
    ``SCATTER_GROUPS`` contiguous groups of ``ceil(k / SCATTER_GROUPS)``,
    each summed in chunk order, and the group sums added in order before
    ``dst + total``.  Float adds in that order give the kernel's bits.
    Writes ``dst`` IN PLACE and returns it."""
    ch = plan.chunks.to(dst.device).long()
    if ch.shape[0] == 0:
        return dst
    order = plan.order.to(dst.device).long()
    rows = rows.to(dst.dtype)
    begin, length = ch[:, 1], ch[:, 2] - ch[:, 1]
    acc = rows[ch[:, 3]]
    for j in range(1, int(length.max())):
        live = torch.nonzero(length > j).squeeze(1)
        acc[live] = acc[live] + rows[order[begin[live] + j]]
    S = plan.split_chunks
    dst_rows, sums = [ch[S:, 0]], [acc[S:]]
    starts = plan.run_start.tolist()
    for c0, c1 in zip(starts[:-1], starts[1:]):
        part = acc[c0:c1]
        per = -(-(c1 - c0) // SCATTER_GROUPS)
        total = None
        for g0 in range(0, c1 - c0, per):
            group = part[g0]
            for c in range(g0 + 1, min(g0 + per, c1 - c0)):
                group = group + part[c]
            total = group if total is None else total + group
        dst_rows.append(ch[c0:c0 + 1, 0])
        sums.append(total[None])
    r = torch.cat(dst_rows)
    dst[r] = dst[r] + torch.cat(sums)
    return dst


def bwd_megastep(kind: str, g: torch.Tensor, buf: torch.Tensor,
                 child_ids: torch.Tensor, child_mask: torch.Tensor,
                 ext_ids: torch.Tensor, node_mask: torch.Tensor,
                 offset: int, ext: torch.Tensor,
                 weights: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """One reverse batching task as slice → analytic cell backward
    (``level_megastep.level_bwd``) → scatter-add of the child-row
    cotangents into the gradient buffer ``g``, IN PLACE.  Returns ``g``.
    Rows ``[offset, offset+M)`` are only read."""
    M, A = child_ids.shape
    S = g.shape[1]
    g_state = g[offset:offset + M] * node_mask.to(g.dtype)[:, None]
    child = buf.index_select(0, child_ids.reshape(-1)).reshape(M, A, S)
    rows = ext.index_select(0, ext_ids)
    g_child, _, _ = lm.level_bwd(kind, g_state, child, rows,
                                 child_mask.to(g.dtype), weights)
    return scatter_add_rows(g, child_ids.reshape(-1),
                            g_child.reshape(M * A, S))


# ---------------------------------------------------------------------------
# Attention (GQA / SWA / causal) -- K10 and K11
# ---------------------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor, scale: float) -> torch.Tensor:
    """Softmax attention of ``q`` ``[B, Hq, Sq, D]`` over ``k``/``v``
    ``[B, Hkv, Sk, D]`` (query head ``h`` reads KV head ``h // (Hq/Hkv)``)
    where ``valid`` (broadcastable to ``[B, Hq, Sq, Sk]``) allows, all in
    float32; a row with no valid key gives zeros, as the kernels write."""
    g = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    logits = logits.masked_fill(~valid, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    w = torch.where(valid.any(dim=-1, keepdim=True), w, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """Full-materialisation attention (K10's plain version).

    ``q``: ``[B, Hq, Sq, D]``; ``k``/``v``: ``[B, Hkv, Sk, D]`` with
    ``Hq % Hkv == 0`` (GQA).  ``causal`` aligns the ends: query ``i`` sits
    at key position ``i + Sk - Sq`` and sees keys up to it.  ``window``:
    a query at position ``p`` sees keys ``> p - window`` (SWA), with or
    without ``causal``, as the Pallas kernel masks (the reference's
    ``ref.mha`` applies it under ``causal`` only; no caller passes a
    window without it).  ``scale`` defaults to ``D ** -0.5``.

    Computed in float32 (the reference rounds the logits and the
    probabilities to ``q``'s type first; at float32 the two agree);
    returns ``q``'s type.  A query with no valid key (``Sq > Sk`` under
    ``causal``) gives a zero row where the reference gives NaN."""
    Sq, D = q.shape[2], q.shape[3]
    scale = D ** -0.5 if scale is None else scale
    valid = mha_valid(Sq, k.shape[2], causal, window, q.device)
    return _attend(q, k, v, valid, scale)


def mha_valid(Sq: int, Sk: int, causal: bool, window: Optional[int],
              device=None) -> torch.Tensor:
    """``[Sq, Sk]`` bool: the keys each query of :func:`mha` sees (query
    ``i`` at key position ``i + Sk - Sq``)."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= kpos > qpos - window
    return valid


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], scale: Optional[float]
            ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """``(S, valid, scale)``: the float32 scores ``scale q kᵀ`` ``[B, Hq,
    Sq, Sk]`` with the masked ones at -inf, K read through GQA."""
    Sq, D = q.shape[2], q.shape[3]
    scale = D ** -0.5 if scale is None else scale
    valid = mha_valid(Sq, k.shape[2], causal, window, q.device)
    kk = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    return s.masked_fill(~valid, float("-inf")), valid, scale


def mha_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
            window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """The row log-sum-exp of :func:`mha`'s scores, ``[B, Hq, Sq]``
    float32 (what K10 stores when asked for it; -inf for a query with no
    valid key)."""
    return torch.logsumexp(_scores(q, k, causal, window, scale)[0], dim=-1)


def mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
            window: Optional[int] = None, scale: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`mha` at output gradient
    ``do`` (the K10 backward's plain version), step by step in float32
    from the forward's row log-sum-exp ``lse`` ``[B, Hq, Sq]``, as the
    kernel takes them:

      S = scale Q Kᵀ, masked as :func:`mha` masks;  E = exp(S - lse), a
      row with no valid key (lse = -inf) all zeros;  P = E / rowsum(E);
      dP = dO Vᵀ;  Δ = rowsum(P ∘ dP);  dS = P ∘ (dP - Δ);
      dQ = scale dS K;  dK = scale dSᵀ Q;  dV = Pᵀ dO,

    dK and dV summed over each KV head's group of query heads (GQA).  P is
    normalised by its own row sum and Δ taken from it, as autograd of a
    softmax does, so that a row of dS sums to zero up to rounding (Δ from
    the forward's output instead, ``rowsum(dO ∘ O)``, would carry the
    forward's rounding into every row, and dQ and dK would carry it times
    the component the keys and queries share).  Each gradient comes back
    at its operand's type."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    s, valid, scale = _scores(q, k, causal, window, scale)
    lse = lse.float()[..., None]
    live = valid & torch.isfinite(lse)
    e = torch.where(live, torch.exp(s - torch.where(live, lse, 0.0)), 0.0)
    total = e.sum(dim=-1, keepdim=True)
    p = e / torch.where(total > 0, total, 1.0)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.view(B, Hkv, g, Sk, D).sum(dim=2)
    dv = dv.view(B, Hkv, g, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Optional[torch.Tensor] = None,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over a KV cache (K11's plain
    version).

    ``q``: ``[B, Hq, D]``; ``k``/``v``: ``[B, Hkv, S, D]``; ``kv_len``:
    ``[B]`` valid cache rows (default ``S``): row ``r`` of sequence ``b``
    is attended iff ``r < kv_len[b]`` and, with ``window``,
    ``r >= kv_len[b] - window``.  ``scale`` defaults to ``D ** -0.5``, as
    the kernel's.  Float32 math, ``q``'s type out; a sequence with no
    valid row gives zeros."""
    B, _, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    last = (torch.full((B,), S, dtype=torch.int64, device=q.device)
            if kv_len is None else kv_len.to(q.device).long())
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < last[:, None]
    if window is not None:
        valid &= pos >= last[:, None] - window
    return _attend(q[:, :, None, :], k, v, valid[:, None, None, :],
                   scale)[:, :, 0, :]


def decode_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, kv_len: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           ns: int = 1) -> torch.Tensor:
    """K11's split of the rows in plain PyTorch (for the tests and
    ``chip_smoke.py``; never on the main path): each slot's valid rows
    assigned to ``ns`` ranks exactly as the kernel assigns them
    (``decode_split.row_range`` and ``split_rows``), each rank's
    partial ``(m, l, acc)`` formed over its rows, and the partials
    combined in rank order: ``m = max m_i``, ``l = sum l_i e^(m_i - m)``,
    ``o = sum acc_i e^(m_i - m) / l``, zeros where ``l = 0``.  Arguments
    as :func:`decode_attention`; float32 math, ``q``'s type out."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    lens = [S] * B if kv_len is None else [int(n) for n in kv_len.tolist()]
    out = torch.zeros((B, Hq, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        parts = []
        for r0, r1 in split_rows(*row_range(lens[b], S, window), ns):
            kk = k[b, :, r0:r1].float().repeat_interleave(g, dim=0)
            vv = v[b, :, r0:r1].float().repeat_interleave(g, dim=0)
            s = torch.einsum("hd,hnd->hn", q[b].float(), kk) * scale
            m = (s.amax(dim=-1) if r1 > r0 else
                 torch.full((Hq,), float("-inf"), device=q.device))
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(dim=-1), torch.einsum("hn,hnd->hd", p, vv)))
        m = torch.stack([mi for mi, _, _ in parts]).amax(dim=0)
        l = torch.zeros((Hq,), device=q.device)
        o = torch.zeros((Hq, D), device=q.device)
        for mi, li, acc in parts:
            e = torch.where(mi == float("-inf"), 0.0, torch.exp(mi - m))
            l = l + li * e
            o = o + acc * e[:, None]
        out[b] = torch.where(l[:, None] > 0, o / l[:, None], 0.0)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) -- K12
# ---------------------------------------------------------------------------

def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  D: Optional[torch.Tensor] = None,
                  initial_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential SSM recurrence, one step a position (the ground
    truth for the chunked and kernel paths).

    Shapes (one B/C group): ``x`` ``[Bt, L, H, P]``, ``dt`` ``[Bt, L, H]``,
    ``A`` ``[H]`` (negative log-decay rates), ``B``/``C`` ``[Bt, L, N]``,
    ``D`` ``[H]`` skip.  Per head ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t
    ⊗ B_t`` and ``y_t = S_t C_t (+ D x_t)``, in float32.  Returns
    ``(y [Bt, L, H, P] at x's type, state [Bt, H, P, N] float32)``."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((Bt, H, P, N), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), B.to(f32), C.to(f32)
    ys = []
    for t in range(L):
        dtt = dtf[:, t]
        decay = torch.exp(dtt * A[None, :])[:, :, None, None]
        upd = (dtt[:, :, None, None] * xf[:, t, ..., None]
               * Bf[:, t, None, None, :])
        s = decay * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cf[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D[None, None, :, None] * xf
    return y.to(x.dtype), s


def _segsum(z: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise segment sums:
    ``out[..., i, j] = sum_{j<k<=i} z_k``, ``-inf`` above the diagonal."""
    L = z.shape[-1]
    cs = torch.cumsum(z, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=z.device))
    return out.masked_fill(~mask, float("-inf"))


def _chunks(x, dt, A, B, C, chunk):
    """The chunked float32 views the SSD forms share: ``xc`` ``[Bt, nc,
    Q, H, P]``, ``dtc`` ``[Bt, nc, Q, H]``, ``Bc``/``Cc`` ``[Bt, nc, Q, N]``
    and ``da = dt A`` ``[Bt, nc, H, Q]``."""
    Bt, L, H, P = x.shape
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc, N, f32 = L // chunk, B.shape[-1], torch.float32
    xc = x.reshape(Bt, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bt, nc, chunk, H).to(f32)
    Bc = B.reshape(Bt, nc, chunk, N).to(f32)
    Cc = C.reshape(Bt, nc, chunk, N).to(f32)
    da = (dtc * A[None, None, None, :].to(f32)).movedim(-1, 2)
    return xc, dtc, Bc, Cc, da


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                D: Optional[torch.Tensor] = None, chunk: int = 16,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Dao & Gu 2024, Alg. 1): quadratic within chunks of
    ``chunk`` positions, a linear recurrence across the chunk states.
    Shapes as :func:`ssd_reference`; ``L`` a multiple of ``chunk``."""
    Bt, L, H, P = x.shape
    xc, dtc, Bc, Cc, da = _chunks(x, dt, A, B, C, chunk)
    Ldec = torch.exp(_segsum(da))                          # [Bt,nc,H,Q,Q]
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)            # [Bt,nc,Q,Q]
    M = G[:, :, None] * Ldec
    y_diag = torch.einsum("bchij,bcjh,bcjhp->bcihp", M, dtc, xc)
    decay_to_end = torch.exp(
        torch.cumsum(da.flip(-1), dim=-1).flip(-1) - da)
    states = torch.einsum("bchj,bcjh,bcjhp,bcjn->bchpn", decay_to_end, dtc,
                          xc, Bc)
    return ssd_combine(y_diag.reshape(Bt, L, H, P), states, x, dt, A, C, D,
                       initial_state)


def ssd_combine(y_diag: torch.Tensor, states: torch.Tensor, x: torch.Tensor,
                dt: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
                D: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD's part outside the intra-chunk kernel (the
    reference keeps it in jnp beside its ``pallas_call``): a loop over the
    ``nc`` chunks carries the state (each chunk's entering state, decayed
    by the chunk's ``exp(sum dt A)``, plus the chunk's own final state),
    and one einsum reads each chunk's entering state out through ``C``
    with the decay from the chunk's start, added to ``y_diag``; then the
    ``D`` skip.

    ``y_diag`` ``[Bt, L, H, P]`` and ``states`` ``[Bt, nc, H, P, N]`` as
    :func:`ssd_chunk_diag` returns them; ``x``, ``dt``, ``A``, ``C``,
    ``D`` as :func:`ssd_reference`.  Returns ``(y at x's type, final
    state float32)``."""
    Bt, L, H, P = x.shape
    nc, N, f32 = states.shape[1], states.shape[-1], torch.float32
    Q = L // nc
    da = (dt.reshape(Bt, nc, Q, H).to(f32)
          * A[None, None, None, :].to(f32)).movedim(-1, 2)  # [Bt,nc,H,Q]
    chunk_decay = torch.exp(da.sum(dim=-1))                # [Bt,nc,H]
    s = (torch.zeros((Bt, H, P, N), dtype=f32, device=states.device)
         if initial_state is None else initial_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    entering = torch.stack(entering, dim=1)                # [Bt,nc,H,P,N]
    decay_from_start = torch.exp(torch.cumsum(da, dim=-1))  # [Bt,nc,H,Q]
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp",
                         C.reshape(Bt, nc, Q, N).to(f32), entering,
                         decay_from_start)
    y = (y_diag.reshape(Bt, nc, Q, H, P) + y_off).reshape(Bt, L, H, P)
    if D is not None:
        y = y + D[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), s


def ssd_chunk_diag(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K12 computes (its plain version): for each chunk of ``chunk``
    positions and each head, with ``cs`` the inclusive cumsum of
    ``dt A`` over the chunk,

      ``y_diag[i, p] = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, p]``
      ``states[p, n] = sum_j exp(cs_last - cs_j) dt_j x[j, p] B[j, n]``.

    Shapes as :func:`ssd_reference` with ``L`` a multiple of ``chunk``;
    float32 math on widened inputs.  Returns ``y_diag`` ``[Bt, L, H, P]``
    and ``states`` ``[Bt, nc, H, P, N]``, both float32."""
    Bt, L, H, P = x.shape
    xc, dtc, Bc, Cc, da = _chunks(x, dt, A, B, C, chunk)
    cs = torch.cumsum(da, dim=-1)                          # [Bt,nc,H,Q]
    seg = cs[..., :, None] - cs[..., None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # Above the diagonal the exponent is positive and may overflow: the
    # select (not a multiply by a 0/1 mask) keeps inf out of the sums.
    Lm = torch.where(tri, torch.exp(seg.masked_fill(~tri, 0.0)), 0.0)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)            # [Bt,nc,Q,Q]
    dx = dtc[..., None] * xc                               # [Bt,nc,Q,H,P]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", G[:, :, None] * Lm, dx)
    decay_to_end = torch.exp(cs[..., -1:] - cs)            # [Bt,nc,H,Q]
    w = decay_to_end.movedim(2, 3)[..., None] * dx         # [Bt,nc,Q,H,P]
    states = torch.einsum("bcjhp,bcjn->bchpn", w, Bc)
    return y_diag.reshape(Bt, L, H, P), states


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    D: Optional[torch.Tensor], state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSM update: ``x`` ``[Bt, H, P]``, ``dt`` ``[Bt, H]``,
    ``B``/``C`` ``[Bt, N]``, ``state`` ``[Bt, H, P, N]`` float32.

    The state is updated IN PLACE (``state`` is the returned tensor):
    ``exp(dt A) state + dt x ⊗ B``, the reference's values in its order
    of operations.  Returns ``(y [Bt, H, P] at x's type, state)``."""
    decay = torch.exp(dt * A[None, :])[:, :, None, None]
    upd = dt[:, :, None, None] * x[..., None] * B[:, None, None, :]
    state.mul_(decay).add_(upd)
    y = torch.einsum("bhpn,bn->bhp", state, C)
    if D is not None:
        y = y + D[None, :, None] * x
    return y.to(x.dtype), state
