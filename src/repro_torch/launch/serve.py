"""Serving launcher: continuous batching over a reduced arch config
(port of ``repro.launch.serve``).

Feeds a stream of synthetic requests through ``ServeEngine`` and reports
throughput: the serving-side end-to-end entry point.  Prompts are bucketed
for attention models and prefilled at their exact length for models with
an SSM state (``pad_prompts = cfg.mamba is None``, the reference's rule).
Runs on the card unless ``--device cpu``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --requests 16 --slots 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.archs import ASSIGNED, reduced
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ASSIGNED, default="stablelm-3b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    lm = TransformerLM(cfg)
    params = lm.init(torch.Generator(args.device).manual_seed(0),
                     device=args.device)
    pad_prompts = cfg.mamba is None          # SSM states can't pad-bucket
    engine = ServeEngine(lm, params, num_slots=args.slots,
                         max_len=args.max_len, pad_prompts=pad_prompts)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(3, 12))
        engine.submit(Request(request_id=i,
                              prompt=rng.integers(0, cfg.vocab, size=plen),
                              max_new_tokens=args.max_new))
    finished = engine.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in finished)
    print(f"arch={cfg.name} requests={len(finished)} ticks={engine.ticks} "
          f"tokens={total_tokens} wall={dt:.2f}s "
          f"tok/s={total_tokens / dt:.1f}")
    return finished


if __name__ == "__main__":
    main()
