#!/usr/bin/env python3
"""K1 (the Tree-LSTM forward megastep), K3/K4/K5 (the LSTM, GRU and
Tree-FC forward megasteps), K9 (the fused LSTM level step), K12 (the
Mamba-2 chunk scan), the continuous frontier's tick (K6b) or K10 at the
ragged head dims beside an earlier commit's on the same inputs, in one
run on one card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/k1_parent_ab.py build/parent          # K1
    python3 tools/k1_parent_ab.py build/parent k3       # K3 (lstm)
    python3 tools/k1_parent_ab.py build/parent k4       # K4 (gru)
    python3 tools/k1_parent_ab.py build/parent k5       # K5 (treefc)
    python3 tools/k1_parent_ab.py build/parent k9       # K9
    python3 tools/k1_parent_ab.py build/parent k12      # K12
    python3 tools/k1_parent_ab.py build/parent k6b      # frontier ticks
    python3 tools/k1_parent_ab.py build/parent k10      # K10, ragged D
    python3 tools/k1_parent_ab.py build/parent k10 build/other ...

K1.  The directory holds a checkout of the earlier commit; its K1 source,
``src/repro_torch/kernels/csrc/treelstm_megastep.cu`` (the fp32 SIMT
kernel, entry point ``treelstm_megastep_launch``, no sentinel and no live
count), is built with this checkout's ``nvcc`` flags.  Both kernels then
run on the levels ``chip_smoke.py`` launches K1 on, with the keywords the
main path gives this checkout's K1: every level of the served traffic,
one training step's forward levels and the synthetic M 4,096 level (the
continuous frontier's ticks store their rows at arena ids, which the
earlier kernel cannot: ``k6b`` times them).  Each level is checked for both
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
decode traffic, no live count); the chain frontier's ticks are
``k6b``'s.  Each level is checked for both kernels against the plain
version (1e-4 of max |plain|); then both are timed by ``torch.profiler`` device time, one session a set, this
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

K6b.  A continuous frontier tick on the earlier commit (up to be1bb74)
is two launches: its level megastep (``treelstm_megastep_sm90.cu`` or
``cell_megastep_sm90.cu``, entry points without ``out_ids``) writes the
lanes' states into a staging block past the arena, then its K6b
(``gather_scatter.cu``, ``scatter_rows_launch``) routes them to their
rows.  Both are built from the earlier checkout the same way and run, in
turns with this checkout's one launch (the megastep storing each lane's
row at its id), on the kept ticks of ``chip_smoke.py``'s continuous
Tree-LSTM run (K1) and of the LSTM-chain trace submitted at once (K3).
Each tick is checked: this checkout's arena against the plain version
(1e-4 of max |plain|) and, bit for bit, against the earlier two
launches' arena.  Then both are timed by ``torch.profiler`` device time,
one session a set (the earlier tick's two kernels also apart); and by
CUDA events over back-to-back ticks (the host's launch cost included),
this checkout's tick through its wrapper beside the earlier tick's two
entry points called through ``ctypes``.

K10.  The earlier SIMT kernel, ``src/repro_torch/kernels/csrc/
flash_attention.cu`` (fp32 FMAs, entry point ``flash_attention_launch``,
the route of head dims the tensor-core kernels did not take until
be1bb74), is built the same way.  Both it and this checkout's
``flash_attention`` (the tf32 route at those head dims) run on the ragged
cases of ``chip_smoke.K10_EDGES`` and ``chip_smoke.K10_RAGGED_TIMED`` at
f32 and bf16, on the K10 launches of ``chip_smoke``'s reduced f32 LM at
``RAGGED_HEAD_DIM`` (all, and by query length) and on those launches'
shapes at D 24 and 32; each is checked against the plain version
(``chip_smoke.ATTN_BARS``), then both are timed by ``torch.profiler``
device time, one session a set.  Further directories, where given, hold
other checkouts whose ``flash_attention_tf32.cu`` (entry point
``flash_attention_tf32_launch``) is built and timed beside, each under
its directory's name; the ptxas lines (registers, spills) of every
tf32 build are printed.

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
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(lib), str(src)], check=True,
                           capture_output=True, text=True)
        lib.with_suffix(".log").write_text(r.stdout + r.stderr)
    return ctypes.CDLL(str(lib))


def ptxas_lines(log: str) -> list:
    """``(entry function, registers / spills line)`` pairs of what
    ``nvcc -Xptxas -v`` said in ``log``."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and ("registers" in line or "spill stores" in line):
            out.append((entry, line.replace("ptxas info    :", "").strip()))
    return out


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
    forward levels and (K3, K4) the kept decode ticks."""
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
            sent = buf.shape[0] - 1
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
            bounds.append(cs.cell_bound_ms(kind, (kind,) + case, False)[0])
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


#: The earlier forward megasteps' entry points (K1 and K3-K5 up to
#: be1bb74): buf, child_ids, ext_ids, node_mask, ext, w, bias; M, A, H,
#: offset, sentinel, buf_stride, ext_stride, live, split; launches, stream.
EARLIER_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p] * 2
#: The earlier K6b: dst, rows, idx; n, R, D, elem, dst_stride,
#: rows_stride; stream.
EARLIER_SCATTER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def earlier_tick(checkout: Path, kind: str):
    """The earlier checkout's two-launch frontier tick of ``kind``
    ("treelstm" or "lstm"), built here, as ``fn(stg, R, cids, eids, nm,
    ext, w, out)``: the megastep over every slot (no live count, as the
    frontier ran it) into rows ``[R, R + M)`` of ``stg``, then K6b from
    there to ``out`` in ``stg[:R]``."""
    src = ("treelstm_megastep_sm90.cu" if kind == "treelstm"
           else "cell_megastep_sm90.cu")
    mega = getattr(earlier_library(checkout, src),
                   f"{kind}_megastep_sm90_launch")
    mega.argtypes, mega.restype = EARLIER_FWD_ARGS, ctypes.c_int
    scat = earlier_library(checkout, "gather_scatter.cu").scatter_rows_launch
    scat.argtypes, scat.restype = EARLIER_SCATTER_ARGS, ctypes.c_int
    sms = lm._sm_count(torch.device(cs.DEVICE))

    def launch(stg, R, cids, eids, nm, ext, w, out):
        M, A = cids.shape
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "treelstm":
            wp, H = lm.packed_recurrent(*w[:4]), w[0].shape[0]
            split = lm.k1_split(M, H, sms)
        else:
            wp, H = w[0], w[0].shape[0]
            split = lm.cell_split(M, H, sms, kind, A)
        n = ctypes.c_int(0)
        rc = mega(stg.data_ptr(), cids.data_ptr(), eids.data_ptr(),
                  nm.data_ptr(), ext.data_ptr(), wp.data_ptr(),
                  w[-1].data_ptr(), M, A, H, R, R - 1, stg.stride(0),
                  ext.stride(0), M, split, ctypes.addressof(n), stream)
        if rc:
            raise RuntimeError(f"the earlier {kind} megastep failed with "
                               f"CUDA error {rc}")
        rc = scat(stg.data_ptr(), stg[R:].data_ptr(), out.data_ptr(), M, R,
                  stg.shape[1], stg.element_size(), stg.stride(0),
                  stg.stride(0), stream)
        if rc:
            raise RuntimeError(f"the earlier scatter_rows failed with CUDA "
                               f"error {rc}")
        return stg

    return launch


def tick_sets() -> dict:
    """set name → (kind, kept ticks, engine): the continuous Tree-LSTM
    run's and the LSTM-chain trace's kept frontier ticks, as
    ``chip_smoke.py`` taps them."""
    fn, params, head, hp, ds = cs.cont_setup()
    ticks, _g, eng = cs.frontier_taps(
        lambda: cs.cont_engine(fn, params, head, hp, cs.CONT_ROWS,
                               cs.CONT_WIDTH),
        cs._cont_requests(ds.graphs, ds.inputs))
    sets = {"tree frontier": ("treelstm", ticks, eng)}
    fn, params, _gen = cs.chain_setup()
    _arr, lens = cs.poisson_trace(cs.TRACE_SEED, cs.TRACE_N, cs.TRACE_RATE,
                                  cs.TRACE_LENGTHS)
    ticks, _g, eng = cs.frontier_taps(
        lambda: cs.cont_engine(fn, params, None, None, cs.CHAIN_ROWS,
                               cs.CHAIN_WIDTH),
        cs.trace_requests(cs.ContinuousRequest, lens, fn.input_dim))
    sets["chain frontier"] = ("lstm", ticks, eng)
    return sets


def k6b_main(dev: dict, checkout: Path) -> None:
    torch.set_grad_enabled(False)
    sets = tick_sets()
    out = {"card": dev["smi"]}
    for name, (kind, ticks, eng) in sets.items():
        earlier = earlier_tick(checkout, kind)
        R = eng.num_rows + 1
        this_calls, old_calls, lanes = [], [], []
        for snap, cids, cmask, nm, ids, eids, w in ticks:
            if snap is None:
                continue
            arena, ext = snap
            M, S = cids.shape[0], arena.shape[1]
            want = cs.ref.frontier_megastep(kind, arena.clone(), cids, cmask,
                                            ext.index_select(0, eids), nm,
                                            ids, w)
            got = lm.MEGASTEPS[kind](arena.clone(), cids, eids, nm, 0, ext,
                                     *w, out_ids=ids)
            stg = torch.cat([arena, arena.new_zeros((M, S))])
            old = earlier(stg, R, cids, eids, nm, ext, w, ids)[:R]
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            cs.check(err <= cs.TOL, f"{name} tick: {err:.3e} of max |plain|")
            cs.check(cs.bitwise_equal(got, old), f"{name} tick: the one "
                     f"launch's arena differs from the earlier two "
                     f"launches'")
            tb, ob = arena.clone(), stg.clone()
            c = (cids, eids, nm, ext, w, ids)
            this_calls.append(lambda tb=tb, c=c: lm.MEGASTEPS[kind](
                tb, c[0], c[1], c[2], 0, c[3], *c[4], out_ids=c[5]))
            old_calls.append(lambda ob=ob, c=c: earlier(
                ob, R, c[0], c[1], c[2], c[3], c[4], c[5]))
            lanes.append(int((nm > 0).sum()))
        ms = cs.device_ms({
            "this": {"calls": this_calls, "launches": 1,
                     "match": cs.FWD_KERNELS[kind][1]},
            "earlier": {"calls": old_calls, "launches": 2,
                        "parts": {"megastep": ["gates_kernel"],
                                  "scatter": ["scatter_rows"]}}}, reps=10)
        old_ms, parts = ms["earlier"]
        ev = {k: float(np.mean([cs.time_ms(f, 20, 3) for f in calls[:8]]))
              for k, calls in (("this", this_calls),
                               ("earlier", old_calls))}
        out[name] = {"ticks": len(this_calls), "M": ticks[0][1].shape[0],
                     "live_lanes": float(np.mean(lanes)),
                     "ms": ms["this"], "earlier_ms": old_ms,
                     "earlier_megastep_ms": parts["megastep"],
                     "earlier_scatter_ms": parts["scatter"],
                     "events_ms": ev["this"],
                     "earlier_events_ms": ev["earlier"]}
        r = out[name]
        print(f"{name} ({r['ticks']} kept ticks, M {r['M']}, "
              f"{r['live_lanes']:.1f} live lanes): this one launch "
              f"{r['ms']:.4f} ms a tick, the earlier two launches "
              f"{r['earlier_ms']:.4f} ms (megastep "
              f"{r['earlier_megastep_ms']:.4f} + scatter_rows "
              f"{r['earlier_scatter_ms']:.4f}; device time); back-to-back "
              f"ticks by CUDA events {r['events_ms']:.4f} (through the "
              f"wrapper) vs {r['earlier_events_ms']:.4f} ms (the earlier two "
              f"entry points); the arena bit for bit the earlier one's on "
              f"every tick")
    print(dev["smi"])
    print(json.dumps(out))


#: The earlier SIMT K10's arguments: out, q, k, v; B, Hq, Hkv, Sq, Sk, D;
#: nine strides; scale; causal, window, bf16; stream.
EARLIER_K10_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                    + [ctypes.c_longlong] * 9 + [ctypes.c_float]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def earlier_k10(checkout: Path, source: str = "flash_attention.cu",
                entry: str = "flash_attention_launch"):
    """The earlier checkout's SIMT K10 (or, by ``source`` and ``entry``,
    its tf32 route, which takes the same arguments), built here, as
    ``fn(q, k, v, *, causal, window)`` returning a new ``[B, Hq, Sq, D]``
    tensor."""
    fn = getattr(earlier_library(checkout, source), entry)
    fn.argtypes, fn.restype = EARLIER_K10_ARGS, ctypes.c_int

    def launch(q, k, v, *, causal=True, window=None, scale=None):
        B, Hq, Sq, D = q.shape
        out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
        rc = fn(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), B,
                Hq, k.shape[1], Sq, k.shape[2], D,
                *[t.stride(i) for t in (q, k, v) for i in range(3)],
                D ** -0.5 if scale is None else float(scale), int(causal),
                window or 0,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the earlier K10 failed with CUDA error {rc}")
        return out

    return launch


def k10_sets() -> dict:
    """set name → K10 calls ((q, k, v), kw): each ragged case of
    ``K10_EDGES`` and ``K10_RAGGED_TIMED`` (a head dim no multiple of 8,
    or at bf16 no multiple of 16) at f32 and bf16; the K10 launches of
    the reduced f32 LM at ``RAGGED_HEAD_DIM``, all and by query length;
    and those launches' shapes at D 24 and 32 (seeded normal inputs), to
    part the ragged head dim's cost from the rest."""
    gen = torch.Generator().manual_seed(1010)
    sets = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, Sq, Sk, D, causal, window in (
                *cs.K10_EDGES, *cs.K10_RAGGED_TIMED):
            if D % 8 == 0 and (dtype == torch.float32 or D % 16 == 0):
                continue
            q = torch.randn((B, Sq, Hq, D), generator=gen).to(
                cs.DEVICE, dtype).transpose(1, 2)
            k, v = (torch.randn((B, Hkv, Sk, D), generator=gen).to(
                cs.DEVICE, dtype) for _ in range(2))
            name = (f"{str(dtype).split('.')[-1]} D {D} Sq {Sq} Sk {Sk}"
                    + (" causal" if causal else "")
                    + (f" window {window}" if window else ""))
            sets[name] = [((q, k, v), {"causal": causal, "window": window})]
    calls = []
    cs.lm_exact_f32_check(head_dim=cs.RAGGED_HEAD_DIM, keep=calls)
    lm_name = f"reduced f32 LM, head dim {cs.RAGGED_HEAD_DIM}"
    sets[lm_name] = calls
    for sq in sorted({a[0].shape[2] for a, _kw in calls}):
        sets[f"{lm_name}, Sq {sq}"] = [c for c in calls
                                       if c[0][0].shape[2] == sq]
    for D in (24, 32):
        sets[f"the LM's launch shapes at D {D}"] = [
            (tuple(torch.randn(t.shape[:3] + (D,), generator=gen).to(
                cs.DEVICE) for t in a), kw) for a, kw in calls]
    return sets


def k10_main(dev: dict, checkout: Path, others=()) -> None:
    """``others``: further checkouts whose ``flash_attention_tf32.cu`` is
    timed beside, each under its directory's name."""
    runs = {"earlier": (earlier_k10(checkout), "flash_attention")}
    for d in others:
        runs[d.name] = (earlier_k10(d, "flash_attention_tf32.cu",
                                    "flash_attention_tf32_launch"),
                        "flash_attention_tf32")
    _build.load("flash_attention_tf32")
    logs = {"this": _build.build_log("flash_attention_tf32")}
    for d in others:
        src = d / "src" / "repro_torch" / "kernels" / "csrc" / \
            "flash_attention_tf32.cu"
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        log = _build.build_dir() / f"earlier_{src.stem}-{tag}.log"
        logs[d.name] = log.read_text() if log.exists() else ""
    for label, log in logs.items():
        for entry, line in ptxas_lines(log):
            print(f"ptxas {label} {entry}: {line}")
    torch.set_grad_enabled(False)
    sets = k10_sets()
    timed = {}
    for name, calls in sets.items():
        for a, kw in calls:
            want = cs.attn_plain("flash_attention", a, kw)
            bar = cs.ATTN_BARS[a[0].dtype]
            for label, res in (("this", cs.flash.flash_attention(*a, **kw)),
                               *((lb, fn(*a, **kw))
                                 for lb, (fn, _m) in runs.items())):
                torch.cuda.synchronize()
                rel = float((res.float() - want).abs().max()) / max(
                    float(want.abs().max()), 1e-30)
                cs.check(rel <= bar, f"{label} K10 on {name}: {rel:.3e} of "
                         f"max |plain|")
        timed[name, "this"] = {
            "calls": [lambda a=a, kw=kw: cs.flash.flash_attention(*a, **kw)
                      for a, kw in calls], "launches": 1,
            "match": "flash_attention_tf32"}
        for label, (fn, match) in runs.items():
            timed[name, label] = {
                "calls": [lambda a=a, kw=kw, fn=fn: fn(*a, **kw)
                          for a, kw in calls], "launches": 1,
                "match": match}
    ms = cs.device_ms(timed, reps=5)
    out = {"card": dev["smi"]}
    for name, calls in sets.items():
        out[name] = {"launches": len(calls), "ms": ms[name, "this"],
                     "earlier_ms": ms[name, "earlier"],
                     "bound_ms": float(np.mean([cs.attn_bound_ms(
                         "flash_attention", a, kw)[0] for a, kw in calls]))}
        for d in others:
            out[name][f"{d.name}_ms"] = ms[name, d.name]
        r = out[name]
        extra = "".join(f", the tf32 kernel of {d} {r[d.name + '_ms']:.4f} "
                        f"ms" for d in others)
        print(f"K10 {name} ({len(calls)} launches): this (tf32 route) "
              f"{r['ms']:.4f} ms a launch, the earlier SIMT kernel "
              f"{r['earlier_ms']:.4f} ms (x{r['earlier_ms'] / r['ms']:.2f}; "
              f"device time){extra}, bound {r['bound_ms']:.5f} ms")
    print(dev["smi"])
    print(json.dumps(out))


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    cells = {"k3": "lstm", "k4": "gru", "k5": "treefc"}
    cs.check(len(args) in (1, 2) and (len(args) == 1 or args[1] in (
        "k1", "k9", "k12", "k6b", "k10", *cells))
             or len(args) > 2 and args[1] == "k10",
             "usage: k1_parent_ab.py EARLIER_CHECKOUT "
             "[k1|k3|k4|k5|k9|k12|k6b|k10 [OTHER_CHECKOUT ...]]")
    dev = cs.device_phase()
    if len(args) == 2 and args[1] == "k6b":
        k6b_main(dev, Path(args[0]))
        return
    if len(args) >= 2 and args[1] == "k10":
        k10_main(dev, Path(args[0]), [Path(a) for a in args[2:]])
        return
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
