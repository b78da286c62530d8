#!/usr/bin/env python3
"""K1 (the Tree-LSTM forward megastep) beside an earlier commit's K1 on the
same inputs, in one run on one card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/k1_parent_ab.py build/parent

The directory holds a checkout of the earlier commit; its K1 source,
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
of them.  Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
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

#: The earlier entry point's arguments: buf, child_ids, ext_ids,
#: node_mask, ext, w, bias; M, A, H, offset, buf_stride, ext_stride;
#: stream.
EARLIER_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def earlier_k1(checkout: Path):
    """The earlier checkout's K1, built here, as ``fn(buf, child_ids,
    ext_ids, node_mask, offset, ext, weights)`` writing ``buf`` in
    place."""
    src = checkout / "src" / "repro_torch" / "kernels" / "csrc" \
        / "treelstm_megastep.cu"
    lib = _build.build_dir() / "earlier_treelstm_megastep.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).treelstm_megastep_launch
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


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    cs.check(len(args) == 1, "usage: k1_parent_ab.py EARLIER_CHECKOUT")
    dev = cs.device_phase()
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
                "launches": cs.k1_designed(M, kw.get("live"))}
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
