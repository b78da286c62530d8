#!/usr/bin/env python3
"""K1 (the Tree-LSTM forward megastep), K3/K4/K5 (the LSTM, GRU and
Tree-FC forward megasteps), K9 (the fused LSTM level step) or K12 (the
Mamba-2 chunk scan) beside an earlier commit's on the same inputs, in one
run on one card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/k1_parent_ab.py build/parent          # K1
    python3 tools/k1_parent_ab.py build/parent k3       # K3 (lstm)
    python3 tools/k1_parent_ab.py build/parent k4       # K4 (gru)
    python3 tools/k1_parent_ab.py build/parent k5       # K5 (treefc)
    python3 tools/k1_parent_ab.py build/parent k9       # K9
    python3 tools/k1_parent_ab.py build/parent k12      # K12

K1.  The directory holds a checkout of the earlier commit; its K1 source,
``src/repro_torch/kernels/csrc/treelstm_megastep.cu`` (the fp32 SIMT
kernel, entry point ``treelstm_megastep_launch``, no sentinel and no live
count), is built with this checkout's ``nvcc`` flags.  Both kernels then
run on the levels ``chip_smoke.py`` launches K1 on, with the keywords the
main path gives this checkout's K1: every level of the served traffic,
one training step's forward levels, the continuous tree frontier's kept
ticks and the synthetic M 4,096 level.  Each level is checked for both
kernels against the plain version (1e-4), then both are timed by
``torch.profiler`` device time, every level in one session, this K1 and
the earlier one in turns.  Prints the means a launch of each set (the
served levels also by ``chip_smoke.K1_CLASSES``) and, last, one JSON line
of them.

K3, K4 and K5.  The earlier source, ``src/repro_torch/kernels/csrc/
cell_megastep.cu`` (the fp32 SIMT kernels, entry points
``lstm_megastep_launch``, ``gru_megastep_launch`` or
``treefc_megastep_launch``, no live count; up to 05ae0b5 it held the
first two, from 1e9f1b9 the third alone), is built the same way.  Both
kernels run, with the keywords the main path gives this checkout's
kernel, on the levels ``chip_smoke.py`` launches them on: the forward
levels of one Var-LSTM (K3), GRU (K4) or Tree-FC (K5) training step (the
cell phase's setup, one step taken with a tap), for K3 and K4 every
``TAP_EVERY``-th decode tick of ``VertexServeEngine`` (``chip_smoke``'s
decode traffic, no live count) and, for K3, the continuous chain
frontier's kept ticks (the LSTM-chain trace submitted at once, no live
count, a staging block past the sentinel).  Each level is checked for
both kernels against the plain version (1e-4 of max |plain|); then both
are timed by ``torch.profiler`` device time, one session a set, this
kernel and the earlier one in turns.  Prints the means a launch, the sum
over the step's levels and, for K5, each level's times; last, one JSON
line of them.

K9.  The earlier source, ``src/repro_torch/kernels/csrc/
lstm_level_fused.cu`` (the fp32 SIMT kernel, entry point
``lstm_level_fused_launch`` without a split), is built the same way.
Both kernels run on the launches ``chip_smoke.py``'s op-by-op phase
keeps: the Var-LSTM forward's levels with ``cell_impl`` "fused", every
tick of the unfused decode, and those levels' operands with a bf16
state; each launch is checked for both against the plain version (1e-4
of max |plain|, bf16 3e-2), then both are timed by ``torch.profiler``
device time, one session a set, in turns.

K12.  The earlier K12 source, ``src/repro_torch/kernels/csrc/ssd_chunk.cu``
(the fp32 SIMT kernel, entry point ``ssd_chunk_launch``, its head group
by the rule that commit's ``mamba_ssd.head_group`` used), is built the
same way.  Both kernels run on the launches ``chip_smoke.py``'s Mamba-2
phase keeps (every ``TAP_EVERY``-th K12 launch of mamba2-370m serving
its traffic) and on mamba2-370m's shapes at ``chip_smoke.K12_TIMED_LENS``
(x/B/C views of one ``xBC`` tensor); each launch is checked for both
against the plain version (``chip_smoke.K12_BARS``), then both are timed
by ``torch.profiler`` device time in one session, in turns.  Prints the
means a launch and, last, one JSON line of them.

Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import level_megastep as lm  # noqa: E402
from repro_torch.kernels import level_step as ls  # noqa: E402
from repro_torch.kernels import mamba_ssd as mssd  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402

#: The earlier entry point's arguments: buf, child_ids, ext_ids,
#: node_mask, ext, w, bias; M, A, H, offset, buf_stride, ext_stride;
#: stream.
EARLIER_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def earlier_library(checkout: Path, source: str) -> ctypes.CDLL:
    """The earlier checkout's ``csrc/<source>``, built here with this
    checkout's ``nvcc`` flags (once for a source's content)."""
    src = checkout / "src" / "repro_torch" / "kernels" / "csrc" / source
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib = _build.build_dir() / f"earlier_{src.stem}-{tag}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    if not lib.exists():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def earlier_k1(checkout: Path):
    """The earlier checkout's K1, built here, as ``fn(buf, child_ids,
    ext_ids, node_mask, offset, ext, weights)`` writing ``buf`` in
    place."""
    fn = earlier_library(checkout, "treelstm_megastep.cu") \
        .treelstm_megastep_launch
    fn.argtypes, fn.restype = EARLIER_ARGS, ctypes.c_int

    def launch(buf, cids, eids, nmask, off, ext, w):
        M, A = cids.shape
        rc = fn(buf.data_ptr(), cids.data_ptr(), eids.data_ptr(),
                nmask.data_ptr(), ext.data_ptr(),
                lm.packed_recurrent(*w[:4]).data_ptr(), w[4].data_ptr(),
                M, A, w[0].shape[0], off, buf.stride(0), ext.stride(0),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the earlier K1 failed with CUDA error {rc}")
        return buf

    return launch


def level_sets() -> dict:
    """set name → (case, kw) pairs, as ``chip_smoke.py`` gathers them."""
    sets = {"served levels": cs.served_level_cases()}
    ex, fn, params, pipe, batches = cs.train_setup()
    graphs, inputs, labels = next(batches)
    b = pipe.pack(graphs, inputs)
    y = cs._labels(labels)
    sets["training step"] = cs.tapped_levels(
        lambda: cs.grads_of(ex, fn, params, b, y, "auto"))
    fn, params, head, hp, ds = cs.cont_setup()
    ticks, _g, eng = cs.frontier_taps(
        lambda: cs.cont_engine(fn, params, head, hp, cs.CONT_ROWS,
                               cs.CONT_WIDTH),
        cs._cont_requests(ds.graphs, ds.inputs))
    R = eng.num_rows + 1
    sets["tree frontier"] = [
        ((snap[0], cids, cmask, eids, nm, R, snap[1], w), {"sentinel": R - 1})
        for snap, cids, cmask, nm, _out, eids, w in ticks if snap is not None]
    gen = torch.Generator().manual_seed(1234)    # kernel_phase's first draw
    sets[f"synthetic M {cs.M_FULL}"] = [(cs.synthetic_level(
        cs.M_FULL, 2, cs.HIDDEN, gen, cs.DEVICE), {})]
    return sets


#: The earlier K3/K4/K5 entry points' arguments: buf, child_ids, ext_ids,
#: node_mask, ext, w, bias; M, A, H, offset, sentinel, buf_stride,
#: ext_stride; stream.
EARLIER_CELL_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])


def earlier_cell(checkout: Path, kind: str):
    """The earlier checkout's K3 (``kind`` "lstm"), K4 ("gru") or K5
    ("treefc"), built here, as ``fn(buf, child_ids, ext_ids, node_mask,
    offset, ext, weights, sentinel)`` writing ``buf`` in place."""
    fn = getattr(earlier_library(checkout, "cell_megastep.cu"),
                 f"{kind}_megastep_launch")
    fn.argtypes, fn.restype = EARLIER_CELL_ARGS, ctypes.c_int

    def launch(buf, cids, eids, nmask, off, ext, w, sentinel):
        M, A = cids.shape
        rc = fn(buf.data_ptr(), cids.data_ptr(), eids.data_ptr(),
                nmask.data_ptr(), ext.data_ptr(), w[0].data_ptr(),
                w[1].data_ptr(), M, A, lm.cell_hidden(kind, w[0], A), off,
                sentinel, buf.stride(0), ext.stride(0),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the earlier {kind}_megastep failed with "
                               f"CUDA error {rc}")
        return buf

    return launch


def cell_sets(kind: str) -> dict:
    """set name → (case, kw) pairs of K3 (``kind`` "lstm"), K4 ("gru") or
    K5 ("treefc"), as ``chip_smoke.py`` gathers them: one training step's
    forward levels, (K3, K4) the kept decode ticks and (K3) the chain
    frontier's kept ticks."""
    phase = {"lstm": "var_lstm", "gru": "gru", "treefc": "tree_fc"}[kind]
    _k, fn, params, d, ext, h_lo, _s = cs.cell_setup(phase)
    sets = {f"{phase} step": cs.tapped_levels(
        lambda: cs.cell_grads(fn, params, d, ext, h_lo))}
    if kind == "treefc":
        return sets
    fn, params, graphs, xs = cs.decode_setup(kind)
    taps, inner = [], cs.ops.level_megastep

    def tap(k, buf, *args, **kw):
        if eng.ticks % cs.TAP_EVERY == 0:
            taps.append(((buf.clone(),) + args, kw))
        return inner(k, buf, *args, **kw)

    cs.ops.level_megastep = tap
    try:
        eng = cs.VertexServeEngine(fn, params, num_slots=cs.DECODE_SLOTS,
                                   device=cs.DEVICE)
        cs._drain(eng, [cs.VertexRequest(i, x) for i, x in enumerate(xs)])
    finally:
        cs.ops.level_megastep = inner
    sets["decode ticks"] = taps
    if kind == "lstm":
        fn, params, _gen = cs.chain_setup()
        _arr, lens = cs.poisson_trace(cs.TRACE_SEED, cs.TRACE_N,
                                      cs.TRACE_RATE, cs.TRACE_LENGTHS)
        ticks, _g, eng = cs.frontier_taps(
            lambda: cs.cont_engine(fn, params, None, None, cs.CHAIN_ROWS,
                                   cs.CHAIN_WIDTH),
            cs.trace_requests(cs.ContinuousRequest, lens, fn.input_dim))
        R = eng.num_rows + 1
        sets["chain frontier"] = [
            ((snap[0], cids, cmask, eids, nm, R, snap[1], w),
             {"sentinel": R - 1})
            for snap, cids, cmask, nm, _out, eids, w in ticks
            if snap is not None]
    return sets


def cell_main(dev: dict, checkout: Path, kind: str) -> None:
    earlier = earlier_cell(checkout, kind)
    torch.set_grad_enabled(True)
    sets = cell_sets(kind)
    torch.set_grad_enabled(False)
    name_k = cs.FWD_KERNELS[kind][0]
    out = {"card": dev["smi"], "kernel": name_k}
    for name, levels in sets.items():
        timed, copies, bounds = {}, {}, []
        for i, (case, kw) in enumerate(levels):
            buf, cids, cmask, eids, nmask, off, ext, w = case
            sent = kw.get("sentinel", buf.shape[0] - 1)
            want = ref.level_megastep(kind, buf.clone(), cids, cmask, eids,
                                      nmask, off, ext, w)
            got = lm.MEGASTEPS[kind](buf.clone(), cids, eids, nmask, off,
                                     ext, *w, **kw)
            old = earlier(buf.clone(), cids, eids, nmask, off, ext, w, sent)
            torch.cuda.synchronize()
            M = cids.shape[0]
            scale = max(float(want[off:off + M].abs().max()), 1e-30)
            for label, res in (("this", got), ("earlier", old)):
                err = float((res[off:off + M] - want[off:off + M])
                            .abs().max()) / scale
                cs.check(err <= cs.TOL, f"{label} {name_k} on {name} level "
                         f"{i}: {err:.3e} of max |plain| > {cs.TOL}")
            kb, eb = copies.setdefault(buf.data_ptr(),
                                       (buf.clone(), buf.clone()))
            c = (cids, eids, nmask, off, ext)
            timed[i, "this"] = {
                "calls": [lambda kb=kb, c=c, w=w, kw=kw:
                          lm.MEGASTEPS[kind](kb, *c, *w, **kw)],
                "match": cs.FWD_KERNELS[kind][1],
                "launches": cs.fwd_designed(M, kw.get("live"))}
            timed[i, "earlier"] = {
                "calls": [lambda eb=eb, c=c, w=w, sent=sent:
                          earlier(eb, *c, w, sent)],
                "match": "cell_megastep_kernel", "launches": 1}
            bounds.append(cs.cell_bound_ms(kind, (kind,) + case, False,
                                           sentinel=sent)[0])
        ms = cs.device_ms(timed, reps=10)
        this = [ms[i, "this"] for i in range(len(levels))]
        old = [ms[i, "earlier"] for i in range(len(levels))]
        out[name] = {"levels": len(levels), "ms": float(np.mean(this)),
                     "earlier_ms": float(np.mean(old)),
                     "total_ms": float(np.sum(this)),
                     "earlier_total_ms": float(np.sum(old)),
                     "bound_ms": float(np.mean(bounds))}
        print(f"{name_k} {name} ({len(levels)} levels): this "
              f"{out[name]['ms']:.4f} ms a launch, the earlier "
              f"{out[name]['earlier_ms']:.4f} ms (device time; all levels "
              f"{out[name]['total_ms']:.4f} / "
              f"{out[name]['earlier_total_ms']:.4f} ms), bound "
              f"{out[name]['bound_ms']:.5f} ms")
        if kind == "treefc":                     # K5 by level
            out[name]["by_level"] = [
                {"level": i, "live": kw.get("live"), "ms": t, "earlier_ms": o,
                 "bound_ms": b}
                for i, ((_c, kw), t, o, b) in enumerate(
                    zip(levels, this, old, bounds))]
            for r in out[name]["by_level"]:
                print(f"  level {r['level']} (live {r['live']}): this "
                      f"{r['ms']:.4f} ms, the earlier {r['earlier_ms']:.4f} "
                      f"ms, bound {r['bound_ms']:.5f} ms")
    print(dev["smi"])
    print(json.dumps(out))


#: The earlier K9 entry point's arguments: c_out, h_out, h_prev, c_prev,
#: ext, w, bias; M, H, h_stride, c_stride, ext_stride, state_bf16; stream.
EARLIER_K9_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def earlier_k9(checkout: Path):
    """The earlier checkout's K9, built here, as ``fn(h_prev, c_prev,
    ext_proj, wh, b) -> (c, h)``."""
    fn = earlier_library(checkout, "lstm_level_fused.cu") \
        .lstm_level_fused_launch
    fn.argtypes, fn.restype = EARLIER_K9_ARGS, ctypes.c_int

    def launch(h_prev, c_prev, ext, wh, b):
        M, H = h_prev.shape
        c = torch.empty((M, H), dtype=h_prev.dtype, device=h_prev.device)
        h = torch.empty_like(c)
        rc = fn(c.data_ptr(), h.data_ptr(), h_prev.data_ptr(),
                c_prev.data_ptr(), ext.data_ptr(), wh.data_ptr(),
                b.data_ptr(), M, H, h_prev.stride(0), c_prev.stride(0),
                ext.stride(0), int(h_prev.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the earlier K9 failed with CUDA error {rc}")
        return c, h

    return launch


def k9_sets() -> dict:
    """set name → K9's argument tuples, as ``chip_smoke.py``'s op-by-op
    phase keeps them: the Var-LSTM forward's levels with ``cell_impl``
    "fused", every tick of the unfused decode, and the levels' operands
    with the state in bf16 (the halves of one ``[M, 2H]`` tensor)."""
    _k, fn, params, d, ext, _h, _s = cs.cell_setup("var_lstm")
    fused = dataclasses.replace(fn, cell_impl="fused")
    with cs.tapped("lstm_level_fused") as levels:
        cs.execute(fused, params, d, ext, fusion_mode="none")
    fn, params, _graphs, xs = cs.decode_setup("lstm", impl="fused")
    with cs.tapped("lstm_level_fused") as ticks:
        cs._drain(cs.VertexServeEngine(fn, params,
                                       num_slots=cs.DECODE_SLOTS,
                                       fusion_mode="none", device=cs.DEVICE),
                  [cs.VertexRequest(i, x) for i, x in enumerate(xs)])
    bf16 = []
    for hp, cp, e, wh, b in levels:
        H = hp.shape[1]
        state = torch.cat([cp, hp], 1).bfloat16()
        bf16.append((state[:, H:], state[:, :H], e, wh, b))
    return {"var_lstm fused levels": levels, "decode ticks": ticks,
            "var_lstm levels, bf16 state": bf16}


def k9_main(dev: dict, checkout: Path) -> None:
    earlier = earlier_k9(checkout)
    sets = k9_sets()
    out = {"card": dev["smi"], "kernel": "K9"}
    for name, calls in sets.items():
        timed, bounds = {}, []
        for i, args in enumerate(calls):
            want = ref.lstm_level_fused(*args)
            got = ls.lstm_level_fused(*args)
            old = earlier(*args)
            torch.cuda.synchronize()
            for label, res in (("this", got), ("earlier", old)):
                for g, w in zip(res, want):
                    g, w = g.float(), w.float()
                    diff = (g - w).abs()
                    ok = (bool((diff <= cs.BF16_TOL + cs.BF16_TOL * w.abs())
                               .all()) if args[0].dtype == torch.bfloat16
                          else float(diff.max())
                          <= cs.TOL * float(w.abs().max()))
                    cs.check(ok, f"{label} K9 on {name} launch {i}: max abs "
                             f"err {float(diff.max()):.3e}")
            timed[i, "this"] = {
                "calls": [lambda a=args: ls.lstm_level_fused(*a)],
                "match": "k9_", "launches": 1}
            timed[i, "earlier"] = {
                "calls": [lambda a=args: earlier(*a)],
                "match": "lstm_level_fused_kernel", "launches": 1}
            bounds.append(cs.gate_bound_ms("lstm_level_fused", args)[0])
        ms = cs.device_ms(timed, reps=10)
        this = [ms[i, "this"] for i in range(len(calls))]
        old = [ms[i, "earlier"] for i in range(len(calls))]
        out[name] = {"launches": len(calls), "ms": float(np.mean(this)),
                     "earlier_ms": float(np.mean(old)),
                     "bound_ms": float(np.mean(bounds))}
        print(f"K9 {name} ({len(calls)} launches): this "
              f"{out[name]['ms']:.4f} ms a launch, the earlier "
              f"{out[name]['earlier_ms']:.4f} ms (device time), bound "
              f"{out[name]['bound_ms']:.5f} ms")
    print(dev["smi"])
    print(json.dumps(out))


#: The earlier K12 entry point's arguments: y, states, x, dt, A, B, C;
#: Bt, L, H, P, N, Q, HG; ten strides; bf16; stream.
EARLIER_K12_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                    + [ctypes.c_longlong] * 10
                    + [ctypes.c_int, ctypes.c_void_p])


def earlier_head_group(Bt: int, nc: int, H: int) -> int:
    """The earlier K12's heads a CTA: the fewest groups that still put 132
    CTAs in the grid (``Bt * nc`` a group), one head a CTA when even that
    does not fill the card."""
    groups = min(H, -(-132 // max(Bt * nc, 1)))
    return max(1, H // groups)


def earlier_k12(checkout: Path):
    """The earlier checkout's K12, built here, as ``fn(x, dt, A, B, C, Q)``
    returning new ``(y_diag, states)``."""
    fn = earlier_library(checkout, "ssd_chunk.cu").ssd_chunk_launch
    fn.argtypes, fn.restype = EARLIER_K12_ARGS, ctypes.c_int

    def launch(x, dt, A, B, C, Q):
        Bt, L, H, P = x.shape
        N = B.shape[-1]
        y = torch.empty((Bt, L, H, P), device=x.device)
        st = torch.empty((Bt, L // Q, H, P, N), device=x.device)
        rc = fn(y.data_ptr(), st.data_ptr(), x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), Bt, L, H, P, N, Q,
                earlier_head_group(Bt, L // Q, H), x.stride(0), x.stride(1),
                x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
                B.stride(0), B.stride(1), C.stride(0), C.stride(1),
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the earlier K12 failed with CUDA error {rc}")
        return y, st

    return launch


def k12_sets() -> dict:
    """set name → K12 launch arguments (x, dt, A, B, C, Q): the kept
    launches of mamba2-370m serving ``chip_smoke.mamba_traffic`` and one
    launch at each of ``chip_smoke.K12_TIMED_LENS``."""
    cfg = cs.get_config(cs.MAMBA_ARCH)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(cs.DEVICE).manual_seed(0),
                        cs.DEVICE)
    kept, seen = [], [0]
    inner = mssd.ssd_chunk_diag

    def tap(x, dt, A, B, C, Q):
        if seen[0] % cs.TAP_EVERY == 0:
            kept.append(cs.k12_kept_args(x, dt, A, B, C, Q))
        seen[0] += 1
        return inner(x, dt, A, B, C, Q)

    mssd.ssd_chunk_diag = tap
    try:
        cs.lm_serve(model, params, cs.mamba_traffic(cfg.vocab),
                    prefill_kernel="ssd_chunk_scan", pad_prompts=False)
    finally:
        mssd.ssd_chunk_diag = inner
    del model, params
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(1212)
    sets = {"kept launches": kept}
    for L in cs.K12_TIMED_LENS:
        sets[f"{L} tokens"] = [(*cs.k12_inputs(gen, 1, L, 32, 64, 128,
                                               torch.float32), min(128, L))]
    return sets


def k12_main(dev: dict, checkout: Path) -> None:
    earlier = earlier_k12(checkout)
    torch.set_grad_enabled(False)
    sets = k12_sets()
    timed = {}
    for name, launches in sets.items():
        for i, a in enumerate(launches):
            want = cs.k12_plain(a)
            for label, out in (("this", mssd.ssd_chunk_diag(*a)),
                               ("earlier", earlier(*a))):
                torch.cuda.synchronize()
                for g, w, what in zip(out, want, ("y_diag", "states")):
                    rel = float((g - w).abs().max()) / max(
                        float(w.abs().max()), 1e-30)
                    cs.check(rel <= cs.K12_BARS[a[0].dtype], f"{label} K12 "
                             f"on {name} launch {i}: {what} {rel:.3e} of "
                             f"max |plain|")
        timed[name, "this"] = {
            "calls": [lambda a=a: mssd.ssd_chunk_diag(*a) for a in launches],
            "match": "ssd_chunk_sm90_kernel"}
        timed[name, "earlier"] = {
            "calls": [lambda a=a: earlier(*a) for a in launches],
            "match": "ssd_chunk_kernel"}
    ms = cs.device_ms(timed, reps=10)
    out = {"card": dev["smi"]}
    for name, launches in sets.items():
        out[name] = {"launches": len(launches), "ms": ms[name, "this"],
                     "earlier_ms": ms[name, "earlier"],
                     "bound_ms": float(np.mean([cs.k12_bound_ms(a)[0]
                                                for a in launches]))}
        print(f"K12 {name} ({len(launches)}): this "
              f"{out[name]['ms']:.4f} ms a launch, the earlier "
              f"{out[name]['earlier_ms']:.4f} ms (device time), bound "
              f"{out[name]['bound_ms']:.5f}")
    print(dev["smi"])
    print(json.dumps(out))


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    cells = {"k3": "lstm", "k4": "gru", "k5": "treefc"}
    cs.check(len(args) in (1, 2) and (len(args) == 1 or args[1] in (
        "k1", "k9", "k12", *cells)),
             "usage: k1_parent_ab.py EARLIER_CHECKOUT [k1|k3|k4|k5|k9|k12]")
    dev = cs.device_phase()
    if len(args) == 2 and args[1] == "k12":
        k12_main(dev, Path(args[0]))
        return
    if len(args) == 2 and args[1] == "k9":
        torch.set_grad_enabled(False)
        k9_main(dev, Path(args[0]))
        return
    if len(args) == 2 and args[1] in cells:
        cell_main(dev, Path(args[0]), cells[args[1]])
        return
    earlier = earlier_k1(Path(args[0]))
    torch.set_grad_enabled(True)
    sets = level_sets()
    torch.set_grad_enabled(False)
    timed, copies = {}, {}
    for name, levels in sets.items():
        for i, (case, kw) in enumerate(levels):
            buf, cids, cmask, eids, nmask, off, ext, w = case
            want = ref.level_megastep("treelstm", buf.clone(), cids, cmask,
                                      eids, nmask, off, ext, w)
            got = lm.treelstm_megastep(buf.clone(), cids, eids, nmask, off,
                                       ext, *w, **kw)
            old = earlier(buf.clone(), cids, eids, nmask, off, ext, w)
            torch.cuda.synchronize()
            M = cids.shape[0]
            for label, out in (("this", got), ("earlier", old)):
                err = float((out[off:off + M] - want[off:off + M])
                            .abs().max())
                cs.check(err <= cs.TOL, f"{label} K1 on {name} level {i}: "
                         f"max_abs_err {err:.3e} > {cs.TOL}")
            kb, eb = copies.setdefault(buf.data_ptr(),
                                       (buf.clone(), buf.clone()))
            c = (cids, eids, nmask, off, ext)
            timed[name, i, "this"] = {
                "calls": [lambda kb=kb, c=c, w=w, kw=kw:
                          lm.treelstm_megastep(kb, *c, *w, **kw)],
                "match": "k1_",
                "launches": cs.fwd_designed(M, kw.get("live"))}
            timed[name, i, "earlier"] = {
                "calls": [lambda eb=eb, c=c, w=w: earlier(eb, *c, w)],
                "match": "treelstm_megastep_kernel", "launches": 1}
    ms = cs.device_ms(timed, reps=10)
    out = {"card": dev["smi"]}
    for name, levels in sets.items():
        this = [ms[name, i, "this"] for i in range(len(levels))]
        old = [ms[name, i, "earlier"] for i in range(len(levels))]
        out[name] = {"levels": len(levels), "ms": float(np.mean(this)),
                     "earlier_ms": float(np.mean(old)),
                     "total_ms": float(np.sum(this)),
                     "earlier_total_ms": float(np.sum(old))}
        print(f"{name} ({len(levels)} levels): this K1 "
              f"{out[name]['ms']:.4f} ms a launch, the earlier "
              f"{out[name]['earlier_ms']:.4f} ms (device time; all levels "
              f"{out[name]['total_ms']:.4f} / "
              f"{out[name]['earlier_total_ms']:.4f} ms)")
    served = sets["served levels"]
    by = {}
    for cls, pick in cs.K1_CLASSES.items():
        idx = []
        for i, (case, kw) in enumerate(served):
            M = case[1].shape[0]
            live = M if kw.get("live") is None else kw["live"]
            if pick(int(case[5]) // M, live):
                idx.append(i)
        if idx:
            by[cls] = {"levels": len(idx),
                       "ms": float(np.mean([ms["served levels", i, "this"]
                                            for i in idx])),
                       "earlier_ms": float(np.mean(
                           [ms["served levels", i, "earlier"] for i in idx]))}
            print(f"served levels, {cls} (x{len(idx)}): this K1 "
                  f"{by[cls]['ms']:.4f} ms, the earlier "
                  f"{by[cls]['earlier_ms']:.4f} ms")
    out["served levels"]["by_class"] = by
    print(dev["smi"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
