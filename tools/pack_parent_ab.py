#!/usr/bin/env python3
"""``pipeline.pack``'s host time on ``chip_smoke.py``'s phase 3 traffic
(the serving phase: the paper's ``tree_lstm`` at hidden 512, 512 SST-like
parses of seed 0 scored by ``StructureServeEngine`` in batches of 64,
every batch a cold pack) in this checkout beside an earlier commit's, in
one run on one card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/pack_parent_ab.py build/parent

Each checkout runs ``PACK_SCRIPT`` in a fresh process of its own (its own
package, its kernels built into its own ``build/``), in turns: earlier,
this, this, earlier.  A run scores the traffic ``REPEATS`` times, each
through a fresh engine (a fresh pipeline and cache, so every pack is
cold), and times every ``pipeline.pack`` call by ``time.perf_counter``.
Prints each run's p50/p99 and, last, one JSON line of them.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REPEATS = 3

PACK_SCRIPT = """
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
fn, params, ds = cs.served_traffic()
took, stats = [], None
for _ in range({repeats}):
    eng = cs.StructureServeEngine(fn, params, batch_size=cs.BATCH,
                                  device=cs.DEVICE)
    inner = eng.pipeline.pack
    def pack(*a, inner=inner, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            took.append(time.perf_counter() - t0)
    eng.pipeline.pack = pack
    reqs = cs._requests(ds)
    for r in reqs:
        assert eng.submit(r), r.error
    torch.cuda.synchronize()
    eng.run()
    assert all(r.status == "ok" for r in reqs)
    stats = {{k: v for k, v in eng.pipeline.stats().items()
             if isinstance(v, (int, float))}}
print(json.dumps({{"pack_ms": [t * 1e3 for t in took], "stats": stats}}))
"""


def run(checkout: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(checkout.resolve() / "src")}
    r = subprocess.run([sys.executable, "-c",
                        PACK_SCRIPT.format(repeats=REPEATS)],
                       cwd=checkout, env=env, capture_output=True,
                       text=True, timeout=900)
    if r.returncode != 0:
        sys.exit(f"pack_parent_ab: the run in {checkout} failed: "
                 f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        sys.exit(__doc__)
    parent = Path(args[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    rows = []
    for label, where in (("earlier", parent), ("this", ROOT),
                         ("this", ROOT), ("earlier", parent)):
        got = run(where)
        ms = np.asarray(got["pack_ms"])
        row = {"run": label, "pack_p50_ms": float(np.percentile(ms, 50)),
               "pack_p99_ms": float(np.percentile(ms, 99)),
               "packs": len(ms), "cache": got["stats"]}
        print(f"{label}: pipeline.pack p50 {row['pack_p50_ms']:.3f} ms, "
              f"p99 {row['pack_p99_ms']:.3f} ms over {len(ms)} packs")
        rows.append(row)
    print(json.dumps({"pack_ab": rows, "card": smi}))


if __name__ == "__main__":
    main()
