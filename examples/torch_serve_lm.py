"""Continuous-batching LM serving on the PyTorch port (the counterpart of
``examples/serve_lm.py``).

ONE decode step over a fixed slot pool; requests arriving and retiring
are pure data.  On the card every prompt's prefill runs the K10
flash-attention kernel once a layer and every tick the K11
decode-attention kernel once a layer.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py            # the card
      PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.archs import reduced
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced(get_config("granite-3-8b"))
    lm = TransformerLM(cfg)
    params = lm.init(torch.Generator(args.device).manual_seed(args.seed),
                     device=args.device)
    engine = ServeEngine(lm, params, num_slots=4, max_len=64)
    rng = np.random.default_rng(args.seed)

    # staggered arrivals: some requests only arrive after serving started
    first_wave = [Request(request_id=i,
                          prompt=rng.integers(0, cfg.vocab, size=int(n)),
                          max_new_tokens=8)
                  for i, n in enumerate(rng.integers(3, 12, size=6))]
    second_wave = [Request(request_id=10 + i,
                           prompt=rng.integers(0, cfg.vocab, size=5),
                           max_new_tokens=6)
                   for i in range(3)]

    for r in first_wave:
        engine.submit(r)
    t0 = time.perf_counter()
    for _ in range(4):                  # the engine is already decoding...
        engine.step()
    for r in second_wave:               # ...when more requests arrive
        engine.submit(r)
    finished = engine.run()
    dt = time.perf_counter() - t0

    tokens = sum(len(r.output) for r in finished)
    print(f"served {len(finished)} requests / {tokens} tokens in "
          f"{engine.ticks} ticks on {args.device} ({dt:.2f}s wall, "
          f"{tokens / dt:.1f} tok/s)")
    print(f"slot pool: {engine.num_slots} slots; requests were admitted and "
          f"retired continuously")
    for r in sorted(finished, key=lambda r: r.request_id)[:4]:
        print(f"  req {r.request_id}: prompt[{len(r.prompt)}] -> {r.output}")
    return finished


if __name__ == "__main__":
    main()
