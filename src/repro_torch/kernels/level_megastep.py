"""Fused level-megastep: one hand-written CUDA launch per batching task.

Port of the forward kernels of ``repro.kernels.level_megastep``, one
wrapper per megastep kind (``GateSpec.kind``):

  :func:`treelstm_megastep` (``csrc/treelstm_megastep_sm90.cu``) — the
    N-ary child-sum Tree-LSTM level (K1): its products on the TF32 tensor
    cores, only for the slots with children (``live``), their depth split
    over a cluster sized by :func:`k1_split`; the gathered product is
    ``csrc/gathered_product.cuh``, the one the reverse megastep's pass (a)
    runs too;
  :func:`lstm_megastep`, :func:`gru_megastep`, :func:`treefc_megastep`
    (``csrc/cell_megastep_sm90.cu``) — the LSTM, GRU and Tree-FC levels
    (K3, K4, K5): the same design on the same product, over the
    predecessor's row (K5: over each child's row against its segment of
    the concat weight), its depth split by :func:`cell_split`.

Each source's header states its bound and design;
:mod:`repro_torch.kernels._build` compiles the sources with ``nvcc`` for
``sm_90a`` on first use.

A launch writes rows ``[offset, offset+M)`` of the node-state buffer
IN PLACE — the counterpart of the Pallas kernels'
``input_output_aliases`` — on PyTorch's current stream, allocating
nothing.  Reads (child rows below ``offset`` and the zero sentinel) never
overlap the written block, which is what makes the in-place write sound.
Given ``out_ids`` (the continuous engine's union frontier,
:func:`repro_torch.kernels.ops.frontier_megastep`), a launch stores slot
``m``'s row at row ``out_ids[m]`` instead, and nothing for an id outside
the buffer (a pad lane): the frontier's row scatter folded into the
store, under the contract that no id names a row the launch reads.

The wrappers take CUDA tensors only: they launch the kernel or raise.
The choice of the plain version for CPU tensors is made once, in
:func:`repro_torch.kernels.ops.level_megastep`.  ``LAUNCHES`` counts
kernel launches (and nothing else), so a run can show that it went
through the kernel, and ``CUDA_LAUNCHES`` the CUDA launches of a
wrapper whose call makes more than one; :func:`require_cuda`,
:func:`check_arg`, :func:`launch_kernel` and the depth split of the
gathered product (:func:`k2_split`, :func:`k2_chunks`) are shared with
the backward's wrappers (``level_megastep_bwd.py``).

The module also holds the analytic backward of one megastep
(:func:`level_bwd`, :func:`level_param_grads`) in plain PyTorch, as the
reference does: the plain version of the reverse megastep and the
scheduler's flat lazily batched parameter-gradient pass.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

#: kernel name → launches of that kernel in this process.
LAUNCHES: "collections.Counter[str]" = collections.Counter()
#: kernel name → the CUDA launches its counted calls made, for K1 and
#: K3–K5, whose call (one level) makes one or two.
CUDA_LAUNCHES: "collections.Counter[str]" = collections.Counter()

#: Largest arity the kernels take.
MAX_ARITY = 4

#: megastep kind → (state width S, pulled-row width G) in units of H.
WIDTHS = {"lstm": (2, 4), "treelstm": (2, 4), "gru": (1, 3),
          "treefc": (1, 1)}


def widths(kind: str, H: int) -> Tuple[int, int]:
    """``(S, G)`` of kind ``kind`` at hidden width ``H``; raises on an
    unknown kind."""
    if kind not in WIDTHS:
        raise ValueError(f"unknown megastep gate kind: {kind!r}")
    s, g = WIDTHS[kind]
    return s * H, g * H


def cell_hidden(kind: str, w: torch.Tensor, A: int) -> int:
    """``H`` of an ``lstm``/``gru``/``treefc`` megastep from its one
    recurrent weight (``wh`` ``[H, 4H]`` / ``[H, 3H]``, or ``wc``
    ``[A·H, H]``).  A ``wc`` whose rows are not ``A·H`` raises, as the
    reference does."""
    if kind != "treefc":
        return w.shape[0]
    H = w.shape[1]
    if w.shape[0] != A * H:
        raise ValueError(f"treefc weight expects A*H={A}*{H} rows, "
                         f"got {w.shape[0]}")
    return H


def reset_launches() -> None:
    LAUNCHES.clear()
    CUDA_LAUNCHES.clear()


# ---------------------------------------------------------------------------
# The gathered product's tiles and depth split (``csrc/gathered_product.cuh``),
# shared by K1, K3–K5, K9 and K2's pass (a)
# ---------------------------------------------------------------------------

#: Slots a tile, depth of a staged chunk, the largest cluster splitting a
#: depth (``BM``, ``BK``, ``MAX_SPLIT`` in ``csrc/gathered_product.cuh``).
K2_BM, K2_BK, K2_MAX_SPLIT = 64, 32, 8
#: K1's hidden columns a tile and warps a CTA (``BJ``, ``NT`` in
#: ``csrc/treelstm_megastep_sm90.cu``): K2's treelstm pass (a) tile.
K1_BJ, K1_WARPS = 16, 8


def k2_split(tiles: int, chunks: int, sms: int, warps: int) -> int:
    """CTAs of a cluster splitting a product's depth, a power of two up to
    ``K2_MAX_SPLIT`` and the product's chunks: the least that gives the
    launch about eight warps an SM (``sms``; 90 % of them), then twice
    that while the launch keeps at most sixteen warps an SM and each rank
    at least 8 chunks (below that the split's partials and the cluster's
    reduce cost more than they save; measured on an H100, PERF.md §6).
    Rank ``r`` of ``s`` takes chunks ``[r n / s, (r + 1) n / s)``
    (:func:`k2_chunks`)."""
    s = 1
    while s < K2_MAX_SPLIT and 10 * tiles * s * warps < 72 * sms \
            and 2 * s <= chunks:
        s *= 2
    while s < K2_MAX_SPLIT and 2 * tiles * s * warps <= 16 * sms \
            and chunks >= 16 * s:
        s *= 2
    return s


def k2_chunks(rank: int, s: int, n: int) -> range:
    """The chunks of a product's ``n`` that rank ``rank`` of ``s`` takes."""
    return range(rank * n // s, (rank + 1) * n // s)


def k1_grid(live: int, H: int) -> Tuple[int, int, int]:
    """``(tiles, chunks, warps)`` of K1's product over a level's ``live``
    slots: its CTA tiles of ``K2_BM`` slots x ``K1_BJ`` columns, the
    chunks of ``K2_BK`` along its depth H, and the warps of a CTA."""
    return (-(-live // K2_BM) * -(-H // K1_BJ), -(-H // K2_BK), K1_WARPS)


def k1_split(live: int, H: int, sms: int) -> int:
    """The depth split of K1's product over ``live`` slots on a card of
    ``sms`` SMs (:func:`k2_split` on its tiles and chunks); 1 where there
    is no product."""
    return k2_split(*k1_grid(live, H)[:2], sms, K1_WARPS) if live else 1


#: Warps of a K3/K4/K5/K9 CTA (``NT`` in ``csrc/cell_megastep_sm90.cu``):
#: K2's lstm, gru and treefc pass (a); K3's, K4's and K9's tile is K1's
#: (``K1_BJ`` columns), K5's ``TREEFC_BJ`` columns (``Cfg::BJ`` there).
CELL_WARPS = 4
TREEFC_BJ = 64


def cell_grid(live: int, H: int, kind: str = "lstm",
              A: int = 1) -> Tuple[int, int, int]:
    """``(tiles, chunks, warps)`` of the product of K3, K4 or K9 (any
    ``kind`` but "treefc") or K5 over ``live`` slots (rows): K1's tiles
    and chunks, or for K5 tiles of ``TREEFC_BJ`` columns and ``A``
    segments of chunks, one a child (K2's treefc pass (a)); and the warps
    of a CTA."""
    if kind == "treefc":
        return (-(-live // K2_BM) * -(-H // TREEFC_BJ),
                A * -(-H // K2_BK), CELL_WARPS)
    return k1_grid(live, H)[:2] + (CELL_WARPS,)


def cell_split(live: int, H: int, sms: int, kind: str = "lstm",
               A: int = 1) -> int:
    """The depth split of the product of K3, K4, K9 or K5 (``kind``,
    ``A`` as for :func:`cell_grid`) over ``live`` slots on a card of
    ``sms`` SMs (:func:`k2_split` on its tiles and chunks); 1 where there
    is no product."""
    return k2_split(*cell_grid(live, H, kind, A)[:2], sms, CELL_WARPS) \
        if live else 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def packed_recurrent(ui: torch.Tensor, uf: torch.Tensor, uo: torch.Tensor,
                     uu: torch.Tensor) -> torch.Tensor:
    """The ``[H, 4H]`` (``ui|uf|uo|uu``) weight the kernel reads: a view,
    no copy, of the one packed tensor behind the four.

    The four must be adjacent column views of that tensor, which is what
    ``interop.pack_recurrent`` builds and ``TreeLSTMVertex.init`` and
    ``interop.params_from_jax`` return; anything else raises."""
    H = ui.shape[0]
    adjacent = all(
        w.shape == (H, H) and w.stride() == (4 * H, 1)
        and w.dtype == ui.dtype
        and w.untyped_storage().data_ptr() == ui.untyped_storage().data_ptr()
        and w.storage_offset() == ui.storage_offset() + g * H
        for g, w in enumerate((ui, uf, uo, uu)))
    if not adjacent:
        raise ValueError("treelstm_megastep: ui/uf/uo/uu must be adjacent "
                         "column views of one [H, 4H] tensor; pack them "
                         "with repro_torch.interop.pack_recurrent")
    return torch.as_strided(ui, (H, 4 * H), (4 * H, 1))


def require_cuda(op: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA card: a kernel's wrapper launches
    or raises, and never falls back to the plain version."""
    if not t.is_cuda:
        raise ValueError(f"{op}: the kernel takes CUDA tensors, got one on "
                         f"{t.device}")


def check_arg(op: str, name: str, t: torch.Tensor, dtype: torch.dtype,
              shape, device: torch.device) -> None:
    """Raise unless argument ``name`` of kernel ``op`` has this dtype,
    shape and device and is contiguous (what the kernels take)."""
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, the buffer on "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def launch_kernel(name: str, device: torch.device, *args,
                  counts: Tuple[str, ...] = ()) -> None:
    """Launch kernel ``name`` (built on first use) with ``args`` on the
    current stream of ``device``; raise if CUDA refuses the launch, and
    count it in ``LAUNCHES`` (under ``name``, or under each of ``counts``)
    only once it is in the stream."""
    launch = _build.load(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    for key in counts or (name,):
        LAUNCHES[key] += 1


def block_rows(op: str, R: int, M: int, offset: int,
               out_ids: Optional[torch.Tensor] = None) -> int:
    """``offset`` of a forward megastep writing rows ``[offset, offset+M)``
    of a buffer of ``R`` rows whose last row is the zero sentinel; raises
    unless the block lies in the buffer below the sentinel.  With
    ``out_ids`` (``[M]`` int32 destination rows on the buffer's device) the
    rows go there and ``offset`` must be 0: nothing else is checked, since
    the ids live on the card."""
    offset = int(offset)
    if out_ids is not None:
        if offset != 0:
            raise ValueError(f"{op}: offset {offset} with out_ids (the rows "
                             f"go to out_ids; pass 0)")
        return offset
    if offset < 0 or offset + M > R - 1:
        raise ValueError(f"{op}: rows [{offset}, {offset + M}) outside a "
                         f"buffer of {R} rows or over its sentinel row "
                         f"{R - 1}")
    return offset


def _out_ids(op: str, out_ids: Optional[torch.Tensor], M: int,
             device: torch.device) -> int:
    """The device address of ``out_ids`` (``[M]`` int32, contiguous, on
    ``device``), or 0 (null: the level's block) without it."""
    if out_ids is None:
        return 0
    check_arg(op, "out_ids", out_ids, torch.int32, (M,), device)
    return out_ids.data_ptr()


def treelstm_megastep(buf: torch.Tensor, child_ids: torch.Tensor,
                      ext_ids: torch.Tensor, node_mask: torch.Tensor,
                      offset: int, ext: torch.Tensor, ui: torch.Tensor,
                      uf: torch.Tensor, uo: torch.Tensor, uu: torch.Tensor,
                      b: torch.Tensor, *, live: Optional[int] = None,
                      out_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One fused N-ary child-sum Tree-LSTM batching task, in place (K1).

    ``buf``: ``[T*M+1, 2H]`` float32 node-state buffer; ``child_ids``:
    ``[M, A]`` int32 buffer rows (absent children at the zero sentinel,
    the buffer's last row); ``ext_ids``: ``[M]`` int32 rows of
    ``ext`` (``[R+1, 4H]``, the hoisted projection); ``node_mask``:
    ``[M]`` float32; ``offset``: first row written, the block below the
    sentinel.  ``live``: one past the last slot with a child other
    than the sentinel (the schedule's ``DeviceSchedule.live``, a host
    value); the product runs over ``[0, live)`` and the leaf launch over
    ``[live, M)``.  Without it the product's grid covers every slot, and a
    tile with no child takes the leaf formula on the card: nothing is
    copied from the card to find out.  Padding slots are written as
    zeros.  ``out_ids``: ``[M]`` int32 destination rows (unique, none a row
    the launch reads; ``offset`` 0): slot ``m``'s row goes to row
    ``out_ids[m]``, nowhere for an id outside ``[0, R)`` (the union
    frontier's tick, :func:`repro_torch.kernels.ops.frontier_megastep`).
    One count in ``LAUNCHES``, one or two in ``CUDA_LAUNCHES``.  Returns
    ``buf``.
    """
    op = "treelstm_megastep"
    require_cuda(op, buf)
    M, A = child_ids.shape
    H = ui.shape[0]
    R = buf.shape[0]
    dev = buf.device
    _check = functools.partial(check_arg, op)
    _check("buf", buf, torch.float32, (buf.shape[0], 2 * H), dev)
    _check("child_ids", child_ids, torch.int32, (M, A), dev)
    _check("ext_ids", ext_ids, torch.int32, (M,), dev)
    _check("node_mask", node_mask, torch.float32, (M,), dev)
    _check("ext", ext, torch.float32, (ext.shape[0], 4 * H), dev)
    _check("b", b, torch.float32, (4 * H,), dev)
    w = packed_recurrent(ui, uf, uo, uu)
    _check("packed recurrent weight", w, torch.float32, (H, 4 * H), dev)
    if not 1 <= A <= MAX_ARITY:
        raise NotImplementedError(
            f"treelstm_megastep: arity {A} outside 1..{MAX_ARITY}")
    offset = block_rows(op, R, M, offset, out_ids)
    oid = _out_ids(op, out_ids, M, dev)
    live = M if live is None else int(live)
    if not 0 <= live <= M:
        raise ValueError(f"{op}: live={live} outside [0, {M}]")
    n = ctypes.c_int(0)
    launch_kernel(op, dev, buf.data_ptr(), child_ids.data_ptr(),
                  ext_ids.data_ptr(), node_mask.data_ptr(), ext.data_ptr(),
                  w.data_ptr(), b.data_ptr(), M, A, H, offset, R - 1,
                  buf.stride(0), ext.stride(0), live,
                  k1_split(live, H, _sm_count(dev)), oid, R,
                  ctypes.addressof(n))
    CUDA_LAUNCHES[op] += n.value
    return buf


def _cell_megastep(kind: str, buf: torch.Tensor, child_ids: torch.Tensor,
                   ext_ids: torch.Tensor, node_mask: torch.Tensor,
                   offset: int, ext: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, live: Optional[int] = None,
                   out_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    op = f"{kind}_megastep"
    require_cuda(op, buf)
    M, A = child_ids.shape
    H = cell_hidden(kind, w, A)
    S, G = widths(kind, H)
    R = buf.shape[0]
    dev = buf.device
    _check = functools.partial(check_arg, op)
    _check("buf", buf, torch.float32, (R, S), dev)
    _check("child_ids", child_ids, torch.int32, (M, A), dev)
    _check("ext_ids", ext_ids, torch.int32, (M,), dev)
    _check("node_mask", node_mask, torch.float32, (M,), dev)
    _check("ext", ext, torch.float32, (ext.shape[0], G), dev)
    _check("w", w, torch.float32, (A * H, H) if kind == "treefc"
           else (H, G), dev)
    _check("b", b, torch.float32, (G,), dev)
    if not 1 <= A <= MAX_ARITY:
        raise NotImplementedError(f"{op}: arity {A} outside 1..{MAX_ARITY}")
    offset = block_rows(op, R, M, offset, out_ids)
    oid = _out_ids(op, out_ids, M, dev)
    live = M if live is None else int(live)
    if not 0 <= live <= M:
        raise ValueError(f"{op}: live={live} outside [0, {M}]")
    n = ctypes.c_int(0)
    launch_kernel(op, dev, buf.data_ptr(), child_ids.data_ptr(),
                  ext_ids.data_ptr(), node_mask.data_ptr(), ext.data_ptr(),
                  w.data_ptr(), b.data_ptr(), M, A, H, offset, R - 1,
                  buf.stride(0), ext.stride(0), live,
                  cell_split(live, H, _sm_count(dev), kind, A), oid, R,
                  ctypes.addressof(n))
    CUDA_LAUNCHES[op] += n.value
    return buf


def lstm_megastep(buf: torch.Tensor, child_ids: torch.Tensor,
                  ext_ids: torch.Tensor, node_mask: torch.Tensor,
                  offset: int, ext: torch.Tensor, wh: torch.Tensor,
                  b: torch.Tensor, *, live: Optional[int] = None,
                  out_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused LSTM batching task, in place (K3).

    ``buf``: ``[T*M+1, 2H]`` float32 node-state buffer ``[c|h]``, its last
    row the zero sentinel; ``child_ids``: ``[M, A]`` int32, column 0 the
    predecessor; ``ext``: ``[R+1, 4H]``; ``wh``: ``[H, 4H]``; ``b``:
    ``[4H]``.  The forget gate adds +1.0; absent children point at the
    sentinel, and the block written lies below it.  ``live``: one past
    the last slot with a child other than the sentinel
    (``DeviceSchedule.live``, a host value); the product runs over
    ``[0, live)`` and an elementwise launch over ``[live, M)``.  Without
    it the product's grid covers every slot, and a tile with no child
    takes the formula of none on the card.  Padding slots are written as zeros.  ``out_ids`` as for
    :func:`treelstm_megastep`.  One count in ``LAUNCHES``, one or two in
    ``CUDA_LAUNCHES``.  Returns ``buf``."""
    return _cell_megastep("lstm", buf, child_ids, ext_ids, node_mask,
                          offset, ext, wh, b, live, out_ids)


def gru_megastep(buf: torch.Tensor, child_ids: torch.Tensor,
                 ext_ids: torch.Tensor, node_mask: torch.Tensor,
                 offset: int, ext: torch.Tensor, wh: torch.Tensor,
                 b: torch.Tensor, *, live: Optional[int] = None,
                 out_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused GRU batching task, in place (K4): state ``h`` (``buf``
    ``[T*M+1, H]``), ``ext`` ``[R+1, 3H]`` (``z|r|n``), ``wh`` ``[H, 3H]``,
    ``b`` ``[3H]``; the reset gate multiplies the recurrent candidate
    with its bias.  ``live`` and ``out_ids`` as for
    :func:`lstm_megastep`.  Returns ``buf``."""
    return _cell_megastep("gru", buf, child_ids, ext_ids, node_mask,
                          offset, ext, wh, b, live, out_ids)


def treefc_megastep(buf: torch.Tensor, child_ids: torch.Tensor,
                    ext_ids: torch.Tensor, node_mask: torch.Tensor,
                    offset: int, ext: torch.Tensor, wc: torch.Tensor,
                    b: torch.Tensor, *, live: Optional[int] = None,
                    out_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused Tree-FC batching task, in place (K5): state ``h``
    (``buf`` ``[T*M+1, H]``), ``ext`` ``[R+1, H]``, the concat weight
    ``wc`` ``[A*H, H]`` (raises unless it has ``A*H`` rows), ``b``
    ``[H]``; the product runs over each child's segment of ``wc``.
    ``live`` and ``out_ids`` as for :func:`lstm_megastep`.  Returns
    ``buf``."""
    return _cell_megastep("treefc", buf, child_ids, ext_ids, node_mask,
                          offset, ext, wc, b, live, out_ids)


#: megastep kind → its kernel's wrapper, all called as
#: ``fn(buf, child_ids, ext_ids, node_mask, offset, ext, *weights,
#: live=..., out_ids=...)``.
MEGASTEPS = {"treelstm": treelstm_megastep, "lstm": lstm_megastep,
             "gru": gru_megastep, "treefc": treefc_megastep}


# ---------------------------------------------------------------------------
# Analytic backward of one megastep (plain PyTorch), port of
# ``repro.kernels.level_megastep.level_bwd`` / ``level_param_grads``.
#
# Shape-polymorphic over the leading ``N``: the same code is the plain
# version of one reverse level (``ref.bwd_megastep``, N = M) and the
# scheduler's flat lazily batched parameter-gradient pass over all T*M
# slots (paper §3.5).  The reverse megastep kernel
# (``csrc/bwd_megastep_sm90.cu``) computes the same cotangents.
# ---------------------------------------------------------------------------

def _lstm_bwd(g_state, child, ext_rows, child_mask, weights):
    wh, b = (w.float() for w in weights)
    H = wh.shape[0]
    prev = child[:, 0, :].float()
    c_prev, h_prev = prev[:, :H], prev[:, H:]
    gates = ext_rows.float() + h_prev @ wh + b
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H:2 * H] + 1.0)
    o = torch.sigmoid(gates[:, 2 * H:3 * H])
    u = torch.tanh(gates[:, 3 * H:])
    c = f * c_prev + i * u
    tc = torch.tanh(c)
    g_c, g_h = g_state[:, :H], g_state[:, H:]
    g_o = g_h * tc
    gc = g_c + g_h * o * (1.0 - tc * tc)
    d_gates = torch.cat([gc * u * i * (1.0 - i),
                         gc * c_prev * f * (1.0 - f),
                         g_o * o * (1.0 - o),
                         gc * i * (1.0 - u * u)], dim=-1)
    # As in the reference, every existing child receives the predecessor's
    # cotangent (an arity-1 cell has one).
    g_child = torch.cat([gc * f, d_gates @ wh.T], dim=-1)[:, None, :] \
        * child_mask[..., None]
    return g_child, d_gates, (h_prev,)


def _treelstm_bwd(g_state, child, ext_rows, child_mask, weights):
    ui, uf, uo, uu, b = [w.float() for w in weights]
    H = ui.shape[0]
    N, A = child.shape[:2]
    mk = child_mask[..., None].float()
    cs = child.float() * mk
    c_k, h_k = cs[..., :H], cs[..., H:]
    h_sum = torch.sum(h_k, dim=1)
    xi, xf, xo, xu = torch.split(ext_rows.float(), H, dim=-1)
    bi, bf, bo, bu = torch.split(b, H, dim=-1)
    i = torch.sigmoid(xi + h_sum @ ui + bi)
    rec_f = (h_k.reshape(N * A, H) @ uf).reshape(N, A, H)
    # The Tree-LSTM forget gate has no +1.0 (the LSTM's has).
    f = torch.sigmoid(xf[:, None, :] + rec_f + bf)
    o = torch.sigmoid(xo + h_sum @ uo + bo)
    u = torch.tanh(xu + h_sum @ uu + bu)
    c = i * u + torch.sum(f * c_k * mk, dim=1)
    tc = torch.tanh(c)
    g_c, g_h = g_state[:, :H], g_state[:, H:]
    g_o = g_h * tc
    gc = g_c + g_h * o * (1.0 - tc * tc)
    d_i = gc * u * i * (1.0 - i)
    d_u = gc * i * (1.0 - u * u)
    d_o = g_o * o * (1.0 - o)
    d_f = (gc[:, None, :] * c_k * mk) * f * (1.0 - f)          # [N, A, H]
    # The pulled row's f lanes feed every child's gate: their cotangent
    # is the sum over children; uf's gradient keeps the per-child d_f.
    d_gates = torch.cat([d_i, torch.sum(d_f, dim=1), d_o, d_u], dim=-1)
    g_h_k = (d_i @ ui.T + d_o @ uo.T + d_u @ uu.T)[:, None, :] \
        + (d_f.reshape(N * A, H) @ uf.T).reshape(N, A, H)
    g_c_k = gc[:, None, :] * f
    g_child = torch.cat([g_c_k, g_h_k], dim=-1) * mk
    return g_child, d_gates, (d_i, d_f, d_o, d_u, h_sum, h_k)


def _gru_bwd(g_state, child, ext_rows, child_mask, weights):
    wh, b = (w.float() for w in weights)
    H = wh.shape[0]
    h_prev = child[:, 0, :].float()                           # [N, H]
    rec = h_prev @ wh + b
    ext_rows = ext_rows.float()
    z = torch.sigmoid(ext_rows[:, :H] + rec[:, :H])
    r = torch.sigmoid(ext_rows[:, H:2 * H] + rec[:, H:2 * H])
    hn = rec[:, 2 * H:]
    n = torch.tanh(ext_rows[:, 2 * H:] + r * hn)
    g_h = g_state.float()
    d_n = g_h * (1.0 - z) * (1.0 - n * n)
    d_z = g_h * (h_prev - n) * z * (1.0 - z)
    d_r = d_n * hn * r * (1.0 - r)
    # Pulled-row cotangent: the x lanes enter the pre-activations additively.
    d_gates = torch.cat([d_z, d_r, d_n], dim=-1)
    # Recurrent-product cotangent: the n lane is gated by r.
    d_rec = torch.cat([d_z, d_r, d_n * r], dim=-1)
    g_h_prev = g_h * z + d_rec @ wh.T
    g_child = g_h_prev[:, None, :] * child_mask[..., None]
    return g_child, d_gates, (h_prev, d_rec)


def _treefc_bwd(g_state, child, ext_rows, child_mask, weights):
    wc, b = (w.float() for w in weights)
    H = wc.shape[1]
    N, A = child.shape[:2]
    mk = child_mask[..., None].float()
    h_k = child.float() * mk                                  # [N, A, H]
    pre = h_k.reshape(N, A * H) @ wc + ext_rows.float() + b
    hy = torch.tanh(pre)
    d_pre = g_state.float() * (1.0 - hy * hy)                 # [N, H]
    g_child = (d_pre @ wc.T).reshape(N, A, H) * mk
    return g_child, d_pre, (h_k,)


_LEVEL_BWD = {"lstm": _lstm_bwd, "treelstm": _treelstm_bwd,
              "gru": _gru_bwd, "treefc": _treefc_bwd}


def level_bwd(kind: str, g_state: torch.Tensor, child: torch.Tensor,
              ext_rows: torch.Tensor, child_mask: torch.Tensor,
              weights: Tuple[torch.Tensor, ...]):
    """Reverse one megastep analytically (activations recomputed from the
    gathered child rows — the remat policy).

    ``g_state``: ``[N, S]`` node-masked state cotangent; ``child``:
    ``[N, A, S]`` gathered child rows; ``ext_rows``: ``[N, 4H]``;
    ``child_mask``: ``[N, A]``.  Returns ``(g_child, d_gates, aux)``:
    ``g_child`` ``[N, A, S]`` is the child-masked cotangent to scatter-ADD
    into the buffer (∂gather = scatter-add, §3.4); ``d_gates`` ``[N, G]``
    the pulled-row cotangent (∂pull = push); ``aux`` feeds
    :func:`level_param_grads`.  An unknown kind raises ``ValueError``.
    """
    fn = _LEVEL_BWD.get(kind)
    if fn is None:
        raise ValueError(f"unknown megastep gate kind: {kind!r}")
    return fn(g_state, child, ext_rows, child_mask, weights)


def level_param_grads(kind: str, d_gates: torch.Tensor, aux,
                      weights: Tuple[torch.Tensor, ...]
                      ) -> Tuple[torch.Tensor, ...]:
    """Weight gradients from ONE flat batched pass over all slots (paper
    §3.5 lazy batching), in ``GateSpec.weight_names`` order.  An unknown
    kind raises ``ValueError``."""
    if kind == "lstm":
        (h_prev,) = aux
        return (h_prev.T @ d_gates).to(weights[0].dtype), \
            torch.sum(d_gates, dim=0)
    if kind == "treelstm":
        d_i, d_f, d_o, d_u, h_sum, h_k = aux
        N, A, H = h_k.shape
        return (h_sum.T @ d_i,
                h_k.reshape(N * A, H).T @ d_f.reshape(N * A, H),
                h_sum.T @ d_o,
                h_sum.T @ d_u,
                torch.cat([torch.sum(d_i, dim=0), torch.sum(d_f, dim=(0, 1)),
                           torch.sum(d_o, dim=0), torch.sum(d_u, dim=0)]))
    if kind == "gru":
        h_prev, d_rec = aux
        return (h_prev.T @ d_rec).to(weights[0].dtype), \
            torch.sum(d_rec, dim=0)
    if kind == "treefc":
        (h_k,) = aux
        N, A, H = h_k.shape
        return (h_k.reshape(N, A * H).T @ d_gates).to(weights[0].dtype), \
            torch.sum(d_gates, dim=0)
    raise ValueError(f"unknown megastep gate kind: {kind!r}")
