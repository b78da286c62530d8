#!/usr/bin/env python3
"""Device time of K2's two kernels (``csrc/bwd_megastep_sm90.cu``) by
depth split, on synthetic levels of the training paths' shapes.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/k2_split_sweep.py          # every split 1, 2, 4, 8
    python3 tools/k2_split_sweep.py auto     # the split k2_split picks

Each level (kind, M, A, H and its live slots; distinct children, so one
contribution a row) runs 20 times under ``torch.profiler`` per split, the
split forced by replacing ``level_megastep_bwd.k2_split``; one JSON line
a level gives the gates and hgrad kernels' mean device ms a launch.
This is the measurement behind ``k2_split``'s rule (PERF.md §6).
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core.structure import level_bwd_plan  # noqa: E402
from repro_torch.interop import pack_recurrent  # noqa: E402
from repro_torch.kernels import level_megastep_bwd as lmb  # noqa: E402

DEV = "cuda"
#: (kind, M, A, H, live): Tree-LSTM levels of the T16xM2048 step, the
#: Var-LSTM/GRU levels (M 128), Tree-FC levels of 64 256-leaf trees.
LEVELS = (("treelstm", 2048, 2, 512, 3), ("treelstm", 2048, 2, 512, 77),
          ("treelstm", 2048, 2, 512, 349), ("lstm", 128, 1, 512, 1),
          ("lstm", 128, 1, 512, 36), ("lstm", 128, 1, 512, 128),
          ("gru", 128, 1, 512, 128), ("treefc", 16384, 2, 512, 8192),
          ("treefc", 16384, 2, 512, 1024), ("treefc", 16384, 2, 512, 64))
GATES = {"treelstm": 4, "lstm": 4, "gru": 3, "treefc": 1}


def level(kind, M, A, H, live, T=4, seed=0):
    """One level at offset 3M of a T-level buffer: slots [0, live) have
    distinct children below it; random weights with a nonzero bias."""
    gen = torch.Generator().manual_seed(seed)
    S = 2 * H if kind in ("treelstm", "lstm") else H
    G = GATES[kind] * H
    R = T * M + 1
    buf = torch.randn(R, S, generator=gen) * 0.5
    buf[-1] = 0
    g = torch.randn(R, S, generator=gen)
    cids = torch.full((M, A), R - 1, dtype=torch.int32)
    cids.view(-1)[:live * A] = torch.randperm(
        M * A, generator=gen)[:live * A].int()
    eids = torch.randint(0, M, (M,), generator=gen, dtype=torch.int32)
    ext = torch.randn(M + 1, G, generator=gen) * 0.5
    nm = torch.zeros(M)
    nm[:live] = 1
    if kind == "treelstm":
        p = {k: torch.randn(H, H, generator=gen) * H ** -0.5
             for k in ("ui", "uf", "uo", "uu")}
        p["b"] = torch.randn(4 * H, generator=gen) * 0.1
        p = pack_recurrent({k: v.to(DEV) for k, v in p.items()})
        w = tuple(p[k] for k in ("ui", "uf", "uo", "uu", "b"))
    else:
        rows = A * H if kind == "treefc" else H
        w = ((torch.randn(rows, H if kind == "treefc" else G, generator=gen)
              * rows ** -0.5).to(DEV),
             (torch.randn(G, generator=gen) * 0.1).to(DEV))
    flat = cids.reshape(-1)
    order = torch.sort(flat.long(), stable=True)[1].int()
    n_live, single, heads = level_bwd_plan(cids.numpy(), R - 1)
    kw = dict(sort_perm=order.to(DEV),
              sorted_child_ids=flat[order.long()].to(DEV),
              run_head=torch.ones_like(flat).to(DEV), live=n_live,
              single=single, heads=heads)
    return (kind, g.to(DEV), buf.to(DEV), cids.to(DEV), eids.to(DEV),
            nm.to(DEV), 3 * M, ext.to(DEV), w), kw


def device_ms(args, kw, reps=20) -> dict:
    kind, g, *rest = args

    def call():
        lmb.bwd_megastep(kind, g, *rest, **kw)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):                  # CUPTI may drop the first events
            torch.cuda._sleep(1000)
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "k2_" in e.key:
            name = "gates" if "gates" in e.key else "hgrad"
            out[name] = round(e.self_device_time_total / 1e3 / reps, 4)
    return out


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("k2_split_sweep: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    real = lmb.k2_split
    for spec in LEVELS:
        args, kw = level(*spec)
        row = {"kind": spec[0], "live": spec[4],
               "auto": device_ms(args, kw)}
        for s in (() if "auto" in argv else (1, 2, 4, 8)):
            lmb.k2_split = lambda t, c, sms, w, s=s: min(s, c)
            try:
                row[s] = device_ms(args, kw)
            finally:
                lmb.k2_split = real
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
