#!/usr/bin/env python3
"""K1 (the Tree-LSTM forward megastep), K3/K4/K5 (the LSTM, GRU and
Tree-FC forward megasteps), K9 (the fused LSTM level step), K12 (the
Mamba-2 chunk scan), the continuous frontier's tick (K6b), K10 at the
ragged head dims, K8a (the LSTM gate chain) or K6a (the retired roots'
gather) with the continuous engine's retirement beside an earlier
commit's on the same inputs, in one run on one card.

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
    python3 tools/k1_parent_ab.py build/parent k8a      # K8a
    python3 tools/k1_parent_ab.py build/parent k6a      # K6a, retirement

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

K8a.  The earlier source, ``src/repro_torch/kernels/csrc/cell_gates.cu``
(up to 690aa79: four columns a thread in blocks of 256 wherever a vector
fits, entry point ``lstm_gates_launch`` without a geometry), is built the
same way.  Both kernels run on the Var-LSTM forward's levels with
``cell_impl`` "pallas" (the main path's launches, tapped), on those
levels with a bf16 ``c_prev`` and on ``chip_smoke.K8A_SHAPES``; each
launch is checked for both against the plain version
(``chip_smoke.GATE_TOL``) and for this one against the earlier one bit
for bit, then both are timed by ``torch.profiler`` device time, one
session a set, in turns.

K6a.  The earlier ``gather_scatter.cu`` (up to 690aa79: the ids on the
card, no host destination) is built the same way and run beside this
checkout's K6a (the ids by value, the rows also stored into a pinned
host buffer) on the first 24 retired-root gathers of the continuous
Tree-LSTM run and of the chain trace submitted at once: the rows bit for
bit each other's and the host rows the card's, then device time as
above.  Then a retiring window's readback alone, host time in turns in
one process (this checkout's ``_readback``; the earlier ``_retire``'s
readback as written, on the earlier kernel), and both checkouts'
engines in fresh processes (``RETIRE_SCRIPT``, earlier, this, this,
earlier): ``_retire``'s host time a window over three runs of each
trace, and the copies each retiring window enqueues under the profiler.

Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import cell_kernels as ck  # noqa: E402
from repro_torch.kernels import gather_scatter as gsc  # noqa: E402
from repro_torch.kernels import level_megastep as lm  # noqa: E402
from repro_torch.kernels import level_step as ls  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
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


def ab_sets(kernel: str, sets: dict, this, earlier, agree, bound,
            match: tuple) -> dict:
    """This checkout's kernel (``this(*args)``) and the earlier one
    (``earlier(*args)``) on each set's argument tuples: ``agree(label,
    args, this_out, earlier_out)`` checks a call's outputs, then both are
    timed by ``torch.profiler`` device time (kernels whose name holds
    ``match[0]`` / ``match[1]``, one a call), one session a set, in turns;
    ``bound(args)`` is a call's bound in ms.  Prints and returns the means
    a launch by set."""
    out = {}
    for name, calls in sets.items():
        timed, bounds = {}, []
        for i, args in enumerate(calls):
            got, old = this(*args), earlier(*args)
            torch.cuda.synchronize()
            agree(f"{name} launch {i}", args, got, old)
            timed[i, "this"] = {"calls": [lambda a=args: this(*a)],
                                "match": match[0], "launches": 1}
            timed[i, "earlier"] = {"calls": [lambda a=args: earlier(*a)],
                                   "match": match[1], "launches": 1}
            bounds.append(bound(args))
        ms = cs.device_ms(timed, reps=10)
        out[name] = {"launches": len(calls),
                     "ms": float(np.mean([ms[i, "this"]
                                          for i in range(len(calls))])),
                     "earlier_ms": float(np.mean([ms[i, "earlier"] for i
                                                  in range(len(calls))])),
                     "bound_ms": float(np.mean(bounds))}
        r = out[name]
        print(f"{kernel} {name} ({len(calls)} launches): this "
              f"{r['ms']:.4f} ms a launch, the earlier "
              f"{r['earlier_ms']:.4f} ms (device time), bound "
              f"{r['bound_ms']:.5f} ms")
    return out


def k9_main(dev: dict, checkout: Path) -> None:
    def agree(label, args, got, old):
        want = ref.lstm_level_fused(*args)
        for who, res in (("this", got), ("earlier", old)):
            for g, w in zip(res, want):
                g, w = g.float(), w.float()
                diff = (g - w).abs()
                ok = (bool((diff <= cs.BF16_TOL + cs.BF16_TOL * w.abs())
                           .all()) if args[0].dtype == torch.bfloat16
                      else float(diff.max()) <= cs.TOL * float(w.abs().max()))
                cs.check(ok, f"{who} K9 on {label}: max abs err "
                         f"{float(diff.max()):.3e}")

    out = {"card": dev["smi"], "kernel": "K9", **ab_sets(
        "K9", k9_sets(), ls.lstm_level_fused, earlier_k9(checkout), agree,
        lambda a: cs.gate_bound_ms("lstm_level_fused", a)[0],
        ("k9_", "lstm_level_fused_kernel"))}
    print(dev["smi"])
    print(json.dumps(out))


#: The earlier K8a entry point's arguments (up to 690aa79: a thread per 4
#: columns in blocks of 256 wherever a vector fits): c_out, h_out, gates,
#: c_prev; M, H, g_stride, c_stride, gates_bf16, c_bf16; stream.
EARLIER_K8A_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def earlier_k8a(checkout: Path):
    """The earlier checkout's K8a (``cell_gates.cu``), built here, as
    ``fn(gates, c_prev) -> (c, h)``."""
    fn = earlier_library(checkout, "cell_gates.cu").lstm_gates_launch
    fn.argtypes, fn.restype = EARLIER_K8A_ARGS, ctypes.c_int

    def launch(gates, c_prev):
        M, H = c_prev.shape
        c = torch.empty((M, H), dtype=gates.dtype, device=gates.device)
        h = torch.empty_like(c)
        rc = fn(c.data_ptr(), h.data_ptr(), gates.data_ptr(),
                c_prev.data_ptr(), M, H, gates.stride(0), c_prev.stride(0),
                int(gates.dtype == torch.bfloat16),
                int(c_prev.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the earlier K8a failed with CUDA error {rc}")
        return c, h

    return launch


def k8a_sets() -> dict:
    """set name → K8a's argument tuples: the Var-LSTM forward's levels
    with ``cell_impl`` "pallas" (the main path's 54 launches, tapped as
    ``chip_smoke.py``'s op-by-op phase keeps them), those levels' operands
    with the state in bf16, and ``chip_smoke.K8A_SHAPES`` with a strided
    f32 and bf16 ``c_prev`` (the ragged and small shapes)."""
    _k, fn, params, d, ext, _h, _s = cs.cell_setup("var_lstm")
    with cs.tapped("lstm_gates") as levels:
        cs.execute(dataclasses.replace(fn, cell_impl="pallas"), params, d,
                   ext, fusion_mode="none")
    bf16 = []
    for g, c in levels:
        H = c.shape[1]
        state = torch.cat([c, c], 1).bfloat16()
        bf16.append((g, state[:, :H]))
    gen = torch.Generator().manual_seed(88)
    edges = []
    for M, H in cs.K8A_SHAPES:
        for sd in (torch.float32, torch.bfloat16):
            g = torch.randn(M, 4 * H, generator=gen).to(cs.DEVICE)
            state = torch.randn(M, 2 * H, generator=gen).to(cs.DEVICE, sd)
            edges.append((g, state[:, :H]))
    return {"var_lstm pallas levels": levels,
            "var_lstm levels, bf16 c_prev": bf16, "edge shapes": edges}


def k8a_main(dev: dict, checkout: Path) -> None:
    """K8a on ``k8a_sets()`` beside the earlier K8a: both against the plain
    version (``chip_smoke.GATE_TOL``) and bit for bit each other; the
    geometry this checkout chose at the main path's shape."""
    def agree(label, args, got, old):
        want = ref.lstm_gates(*args)
        for g, o, w in zip(got, old, want):
            cs.check(torch.equal(cs._bits(g), cs._bits(o)), f"K8a on "
                     f"{label}: this and the earlier kernel's outputs "
                     f"differ in their bits")
            err = float((g.float() - w.float()).abs().max())
            cs.check(err <= cs.GATE_TOL, f"K8a on {label}: {err:.3e}")

    sms = lm._sm_count(torch.device(cs.DEVICE))
    V, nt = ck.k8a_geometry(128, 512, sms, True)
    ctas = -(-128 * (512 // V) // nt)
    cs.check(ctas >= 2 * sms, f"K8a at M 128, H 512: {ctas} CTAs")
    print(f"K8a at M 128, H 512: {V} columns a thread, blocks of {nt}: "
          f"{ctas} CTAs on {sms} SMs (the earlier kernel: 4 in blocks of "
          f"256, 64 CTAs)")
    out = {"card": dev["smi"], "kernel": "K8a", "geometry": [V, nt, ctas],
           **ab_sets("K8a", k8a_sets(), ck.lstm_gates, earlier_k8a(checkout),
                     agree, lambda a: cs.gate_bound_ms("lstm_gates", a)[0],
                     ("lstm_gates_kernel", "lstm_gates_kernel"))}
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


def earlier_k6a(checkout: Path):
    """The earlier checkout's K6a (``gather_scatter.cu``, up to 690aa79:
    the ids on the card, no host destination), built here, as ``fn(src,
    idx_on_card) -> out`` through the earlier ``ops.gather_rows`` path's
    host steps (the dispatch count, the wrapper's checks, the output's
    allocation, the launch on the current stream under the device's
    context, the launch count), so that its host time is comparable."""
    fn = earlier_library(checkout, "gather_scatter.cu").gather_rows_launch
    fn.argtypes, fn.restype = EARLIER_SCATTER_ARGS, ctypes.c_int
    op = "gather_rows"

    def launch(src, idx):
        kops._tick(op, "cuda")
        lm.require_cuda(op, src)
        R, D = src.shape
        n, dev = idx.shape[0], src.device
        lm.check_arg(op, "src", src, src.dtype, (R, D), dev)
        lm.check_arg(op, "idx", idx, torch.int32, (n,), dev)
        out = torch.empty((n, D), dtype=src.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = fn(out.data_ptr(), src.data_ptr(), idx.data_ptr(), n, R, D,
                    src.element_size(), out.stride(0), src.stride(0), stream)
        if rc:
            raise RuntimeError(f"the earlier K6a failed with CUDA error {rc}")
        lm.LAUNCHES["earlier " + op] += 1
        return out

    return launch


#: Run in a checkout's root with its own ``src`` on the path (this one's
#: or an earlier one's): the continuous Tree-LSTM run (512 parses at once,
#: with the head) and the LSTM-chain trace's chains (at once, no head)
#: through that checkout's ``ContinuousBatchEngine``, each once to warm
#: (64 requests), then timed three times: every ``_retire`` call's host
#: time and its ``_release``'s (``time.perf_counter``; the window before
#: it ended in the engine's sync; no request has a deadline, so each
#: ``_release`` is a retirement's), the run's wall time.  Then the
#: readback alone, 400 times on the arena's rows 0..7 (a window's 7.6
#: roots): this checkout's ``_readback``, or, in a checkout without one,
#: the earlier ``_retire``'s readback as it is written there (the ids
#: copied to the card, K6a, the roots read back; the head over them and
#: its logits read back).  Then 64 requests under ``retire_copies``
#: (this checkout's ``chip_smoke.retire_copies``, passed in as source).
#: Prints one JSON line.
RETIRE_SCRIPT = """
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
_build.build_all()
{retire_copies}

def timed(make, reqs):
    eng = make()
    took = {{"_retire": [], "_release": []}}
    for name, t in took.items():
        inner = getattr(eng, name)
        def wrapped(acts, inner=inner, t=t):
            t0 = time.perf_counter()
            inner(acts)
            t.append(time.perf_counter() - t0)
        setattr(eng, name, wrapped)
    for r in reqs:
        assert eng.submit(r), r.error
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    assert all(r.status == "ok" for r in reqs)
    releases = iter(took["_release"])
    return ([t - next(releases) for t in took["_retire"]], took["_retire"],
            wall)

class Root:
    def __init__(self, row):
        self.root_row = row

def readback(eng, done):
    if hasattr(eng, "_readback"):
        return eng._readback(done)
    root_rows = torch.tensor([a.root_row for a in done], dtype=torch.int32,
                             device=eng.device)
    roots_dev = kops.gather_rows(eng._buf, root_rows)
    roots = roots_dev.cpu().numpy()
    logits = None
    if eng.head is not None:
        logits = eng.head.logits(eng.head_params, roots_dev).cpu().numpy()
    return roots, roots_dev, logits

out = {{}}
torch.set_grad_enabled(False)
fn, params, head, hp, ds = cs.cont_setup()
tree = (lambda: cs.cont_engine(fn, params, head, hp, cs.CONT_ROWS,
                               cs.CONT_WIDTH),
        lambda n: cs._cont_requests(ds.graphs[:n], ds.inputs[:n]))
cfn, cparams, _gen = cs.chain_setup()
_arr, lens = cs.poisson_trace(cs.TRACE_SEED, cs.TRACE_N, cs.TRACE_RATE,
                              cs.TRACE_LENGTHS)
chains = (lambda: cs.cont_engine(cfn, cparams, None, None, cs.CHAIN_ROWS,
                                 cs.CHAIN_WIDTH),
          lambda n: cs.trace_requests(cs.ContinuousRequest, lens[:n],
                                      cfn.input_dim))
for name, (make, reqs) in (("tree", tree), ("chains", chains)):
    timed(make, reqs(64))
    runs = [timed(make, reqs(None)) for _ in range(3)]
    less = np.concatenate([r[0] for r in runs])
    whole = np.concatenate([r[1] for r in runs])
    eng = make()
    done = [Root(i) for i in range(8)]
    for _ in range(20):
        readback(eng, done)
    rb = []
    for _ in range(400):
        t0 = time.perf_counter()
        readback(eng, done)
        rb.append(time.perf_counter() - t0)
    per = retire_copies(make(), reqs(64), 0.05, 8)
    seen = [w for w in per if w["k6a"]]
    out[name] = {{
        "windows": len(whole),
        "retire_p50_us": float(np.percentile(whole, 50)) * 1e6,
        "retire_less_release_p50_us": float(np.percentile(less, 50)) * 1e6,
        "retire_total_ms": float(np.sum(whole)) * 1e3 / len(runs),
        "readback_p50_us": float(np.percentile(rb, 50)) * 1e6,
        "readback_p10_us": float(np.percentile(rb, 10)) * 1e6,
        "requests_per_s": [len(reqs(None)) / r[2] for r in runs],
        "profiled_windows": len(per), "windows_seen": len(seen),
        "copies_enqueued": [min(w["api"] for w in per),
                            max(w["api"] for w in per)],
        "h2d": max(w["h2d"] for w in seen) if seen else None,
        "d2h": max(w["d2h"] for w in seen) if seen else None}}
print(json.dumps(out))
"""


def retire_run(checkout: Path) -> dict:
    """``RETIRE_SCRIPT`` in a fresh process in ``checkout`` (its own
    package, kernels built into its own ``build/``)."""
    script = RETIRE_SCRIPT.format(
        retire_copies=inspect.getsource(cs.retire_copies))
    env = {**os.environ, "PYTHONPATH": str(checkout.resolve() / "src")}
    r = subprocess.run([sys.executable, "-c", script], cwd=checkout, env=env,
                       capture_output=True, text=True, timeout=900)
    cs.check(r.returncode == 0, f"the retirement run in {checkout} failed: "
             f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def gather_sets() -> dict:
    """set name → K6a's argument tuples ``(src, ids on the host, the same
    ids on the card, a pinned host buffer)``: the first 24 retired-root
    gathers of the continuous Tree-LSTM run and of the LSTM-chain trace
    submitted at once, as ``chip_smoke.py`` taps them."""
    fn, params, head, hp, ds = cs.cont_setup()
    _t, tree, _e = cs.frontier_taps(
        lambda: cs.cont_engine(fn, params, head, hp, cs.CONT_ROWS,
                               cs.CONT_WIDTH),
        cs._cont_requests(ds.graphs, ds.inputs))
    fn, params, _gen = cs.chain_setup()
    _arr, lens = cs.poisson_trace(cs.TRACE_SEED, cs.TRACE_N, cs.TRACE_RATE,
                                  cs.TRACE_LENGTHS)
    _t, chain, _e = cs.frontier_taps(
        lambda: cs.cont_engine(fn, params, None, None, cs.CHAIN_ROWS,
                               cs.CHAIN_WIDTH),
        cs.trace_requests(cs.ContinuousRequest, lens, fn.input_dim))
    return {name: [(src, idx, idx.to(cs.DEVICE),
                    cs.host_rows_for(src, idx.numel())) for src, idx in g]
            for name, g in (("tree roots", tree), ("chain roots", chain))}


class _Root:
    """A retired request as a readback sees it: its root's arena row."""

    def __init__(self, row: int):
        self.root_row = row


def readback_ab(old, reps: int = 400) -> dict:
    """A retiring window's readback, host time (``time.perf_counter``) in
    one process, in turns: this checkout's ``_readback`` and the earlier
    ``_retire``'s readback as it was written, on the earlier K6a (the ids
    copied to the card, the launch, the roots read back; the head and its
    logits read back).  Eight roots (a window's 7.6), the engines of the
    continuous Tree-LSTM run (a head) and of the chain trace (none).
    Returns p10/p50 µs of each."""
    fn, params, head, hp, _ds = cs.cont_setup()
    cfn, cparams, _gen = cs.chain_setup()
    out = {}
    for name, eng in (
            ("tree", cs.cont_engine(fn, params, head, hp, cs.CONT_ROWS,
                                    cs.CONT_WIDTH)),
            ("chains", cs.cont_engine(cfn, cparams, None, None,
                                      cs.CHAIN_ROWS, cs.CHAIN_WIDTH))):
        done = [_Root(i) for i in range(8)]

        def earlier():
            ids = torch.tensor([a.root_row for a in done],
                               dtype=torch.int32, device=eng.device)
            roots_dev = old(eng._buf, ids)
            roots_dev.cpu().numpy()
            if eng.head is not None:
                eng.head.logits(eng.head_params, roots_dev).cpu().numpy()

        took = {"this": [], "earlier": []}
        for i in range(reps + 20):
            for who, call in (("this", lambda: eng._readback(done)),
                              ("earlier", earlier))[::1 - 2 * (i % 2)]:
                t0 = time.perf_counter()
                call()
                if i >= 20:
                    took[who].append(time.perf_counter() - t0)
        out[name] = {f"{who} {q}": float(np.percentile(t, q)) * 1e6
                     for who, t in took.items() for q in (10, 50)}
        print(f"readback, {name} (8 roots, {reps} in turns, host µs): "
              + ", ".join(f"{k} {v:.1f}" for k, v in out[name].items()))
    return out


def k6a_main(dev: dict, checkout: Path) -> None:
    """K6a on the retired-root gathers beside the earlier K6a (bit for bit:
    this one's rows on the card and in the host buffer, the earlier one's);
    the readback alone in turns (``readback_ab``); then ``_retire``'s host
    time a window and the copies a window enqueues, the earlier checkout's
    engine and this one's in fresh processes, in the order earlier, this,
    this, earlier."""
    torch.set_grad_enabled(False)
    old = earlier_k6a(checkout)

    def agree(label, args, got, was):
        src, idx, _di, host = args
        cs.check(torch.equal(cs._bits(got), cs._bits(was)), f"K6a on "
                 f"{label}: this and the earlier kernel's rows differ in "
                 f"their bits")
        cs.check(torch.equal(cs._bits(host[:idx.numel()]),
                             cs._bits(got.cpu())),
                 f"K6a on {label}: the host rows differ from the card's")

    out = {"card": dev["smi"], "kernel": "K6a", **ab_sets(
        "K6a", gather_sets(),
        lambda s, i, _d, h: gsc.gather_rows(s, i, host_out=h),
        lambda s, _i, d, _h: old(s, d), agree,
        lambda a: cs.k6_bound_ms(a[1].numel(), a[1].numel(), a[0].shape[1],
                                 a[0].element_size(), 2)[0],
        ("gather_rows_kernel", "gather_rows_kernel"))}
    out["readback"] = readback_ab(old)
    runs = []
    for who, root in (("earlier", checkout), ("this", ROOT), ("this", ROOT),
                      ("earlier", checkout)):
        runs.append((who, retire_run(root)))
        print(f"retirement, {who}: {json.dumps(runs[-1][1])}")
    for name in ("tree", "chains"):
        for who in ("this", "earlier"):
            mine = [r[name] for w, r in runs if w == who]
            out[f"{name} retire, {who}"] = {
                k: [r[k] for r in mine] for k in (
                    "retire_p50_us", "retire_less_release_p50_us",
                    "retire_total_ms", "readback_p50_us", "readback_p10_us",
                    "windows", "requests_per_s", "windows_seen",
                    "copies_enqueued", "h2d", "d2h")}
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
        "k1", "k9", "k12", "k6a", "k6b", "k8a", "k10", *cells))
             or len(args) > 2 and args[1] == "k10",
             "usage: k1_parent_ab.py EARLIER_CHECKOUT "
             "[k1|k3|k4|k5|k9|k12|k6a|k6b|k8a|k10 [OTHER_CHECKOUT ...]]")
    dev = cs.device_phase()
    if len(args) == 2 and args[1] == "k6b":
        k6b_main(dev, Path(args[0]))
        return
    if len(args) == 2 and args[1] == "k6a":
        k6a_main(dev, Path(args[0]))
        return
    if len(args) == 2 and args[1] == "k8a":
        torch.set_grad_enabled(False)
        k8a_main(dev, Path(args[0]))
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
